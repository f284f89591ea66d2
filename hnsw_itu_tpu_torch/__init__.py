"""hnsw_itu_tpu_torch — the PyTorch + CUDA port of ``hnsw_itu_tpu``.

The JAX package beside this one is the reference; every module here keeps
its counterpart's name (``ops/metrics.py``, ``models/hnsw.py``, ...) so a
reader can find the function it was ported from. The port imports
``torch`` and never ``jax`` or ``hnsw_itu_tpu``: numpy-only helpers are
copied, not shared.

Rules the port follows:

* every class that owns tensors takes an explicit ``device``; nothing
  picks ``cuda`` or ``cpu`` for the caller;
* a kernel wrapper launches its CUDA kernel for CUDA tensors and runs
  the kernel's plain PyTorch version only for CPU tensors;
* no kernel is built at import: ``ops/_kernels.py`` compiles
  ``csrc/*.cu`` with ``nvcc`` at first use.

Slice 1 is the query path: the host-built HNSW hierarchy, the sampled
entry, the fused beam-search kernel and the brute-force oracle.
"""

from .device import require_cuda

__version__ = "0.1.0"

__all__ = ["require_cuda"]
