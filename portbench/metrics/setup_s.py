"""setup_s: process start to the first timed call (host clock): Python
and PyTorch start, data made from the seed, kernel builds (nvcc on a
checkout's first run, then the cached libraries), the index build or the
set-up rows, the query table, and the warm calls."""

UNIT = "s"


def read(rec):
    return rec["setup_s"]
