"""query_span_ms.entry: milliseconds per ``knns`` call of the traced
window in the program's ``hnsw.knns.entry`` ranges (the sampled entry of
every query batch of the call), on the stream's clock: from the moment
the card has done the work launched before each range to the moment it
has done the work launched inside it, launch gaps included, as a CUDA
event pair around the range reads it (``spans.stream_span_us``, from
torch.profiler's launches and device operations)."""

from portbench import spans

UNIT = "ms"


def read(rec):
    return spans.stream_span_ms_per_call(rec, "knns.entry")
