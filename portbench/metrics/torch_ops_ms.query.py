"""torch_ops_ms.query: device milliseconds per ``knns`` call of every
operation that is not one of the port's own CUDA kernels (csrc/*.cu):
the entry's GEMM and argmin, the sorts, the rerank's gathers, copies;
from torch.profiler over the traced window."""

from portbench import trace

UNIT = "ms"


def read(rec):
    return trace.per_call_ms(rec, "query",
                             lambda n: not trace.is_port_kernel(n), "calls")
