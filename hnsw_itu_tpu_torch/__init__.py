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

Ported: the Hamming, integer-L2 and float-L2 metrics and registered
ones; the HNSW and NSW query paths (the sampled entry or the greedy
descent, then the fused or the mini-table beam-search kernel with its
exact rerank, or the general beam search where no table serves); the
brute-force oracle; the HNSW and NSW builds (the native host warmup, then
the batched device build on the gather beam-search kernel, or the general
beam search past its limits, and the dense Hamming kernel); the BFS
reorder; ``.npz`` persistence of all three index kinds; the six-command
CLI (``cli.py``); and index and query sharding (``parallel/``).

A sharded index takes a mesh, an ordered list of devices
(``parallel.make_mesh(devices=[...])``), one per shard; on a mesh of
several cards its build and its queries run in one long-lived worker
process a card (``parallel.mesh.CardPool``), on a mesh of one device in
the caller's process. A device may repeat, so S shards can
share one card (``[torch.device("cuda", 0)] * 4``) and the CPU tests
pass ``["cpu"] * S``; ``make_mesh()`` takes every visible card and raises
without one.
"""

from .device import require_cuda
from .ops.metrics import Metric, get_metric, register_metric

__version__ = "0.1.0"

__all__ = ["Metric", "get_metric", "register_metric", "require_cuda"]
