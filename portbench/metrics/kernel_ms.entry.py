"""kernel_ms.entry: device milliseconds per ``knns`` call of the window
of the sampled entry kernel (``csrc/sampled_entry.cu``, its ``__global__``
function ``sampled_entry_kernel``), from torch.profiler by kernel name.
Programs without that kernel read nothing here."""

from portbench import trace

UNIT = "ms"
KERNEL = "sampled_entry_kernel"


def read(rec):
    return trace.per_call_ms(rec, "query", lambda n: KERNEL in n, "calls")
