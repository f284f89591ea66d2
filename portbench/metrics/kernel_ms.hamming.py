"""kernel_ms.hamming: device milliseconds per chunk of the window of the
build's kernel ``hamming`` (see ``trace.PORT_KERNELS``), from torch.profiler
by kernel name, over the chunks inserted in the traced window."""

from portbench import trace

UNIT = "ms"


def read(rec):
    return trace.kernel_ms_per_chunk(rec, "hamming")
