"""kernel_ms.rerank: device milliseconds per ``knns`` call of the window
of the mini route's exact rerank kernel (``csrc/exact_rerank.cu``, its
``__global__`` function ``exact_rerank_kernel``), from torch.profiler by
kernel name. Programs without that kernel read nothing here."""

from portbench import trace

UNIT = "ms"
KERNEL = "exact_rerank_kernel"


def read(rec):
    return trace.per_call_ms(rec, "query", lambda n: KERNEL in n, "calls")
