"""Fused beam search: the whole search loop in one kernel (counterpart of
hnsw_itu_tpu/ops/pallas_search.py).

The JAX package runs the base-layer beam search as one Pallas kernel over a
"fused" table whose row holds a node's adjacency ids AND its neighbors'
sketches, so each expansion is one sequential read. The port keeps the
idea and the contract (bit-exact keys, ``visited`` and ``steps`` against
the packed XLA beam search) and picks its own table layout for the GPU:

  ids   int32[cap, Wp]          node e's neighbor ids, -1 = no edge
  data  int32[cap, Wp, words]   neighbor j's sketch at data[e, j], 128 B
                                contiguous at words=32

``Wp = fused_width(W)``, the next power of two (<= 128). Padding columns
hold id -1 and zero words; so do the sketches of absent edges.

``fused_beam_search`` launches ``csrc/fused_beam_search.cu`` for CUDA
tensors and runs the plain version (``ops/search.py``) for CPU tensors;
any other device raises. ``fused_beam_search.kernel_launches`` and
``fused_beam_search.plain_calls`` count the two routes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _kernels
from .search import beam_search_packed

MAX_WIDTH = 128  # widest fused row, and the largest beam the kernel holds
MAX_EF = 128


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def fused_width(width: int) -> int:
    """Physical adjacency width of the fused table: the next power of two.
    Rows wider than 128 cannot be fused."""
    if width > MAX_WIDTH:
        raise ValueError(f"adjacency width {width} > {MAX_WIDTH}")
    return min(MAX_WIDTH, max(1, _next_pow2(width)))


def key_clamp(id_bits: int, max_d: int) -> int:
    """Effective distance bound of the packed (d << id_bits) | id key:
    min(max_d, 2^(31 - id_bits) - 2). Distances are clamped to it, so ids
    up to 2^id_bits pack for any metric bound."""
    return min(max_d, (1 << (31 - id_bits)) - 2)


class FusedTable(NamedTuple):
    """The fused query table (see module docstring)."""

    ids: torch.Tensor   # int32[cap, Wp]
    data: torch.Tensor  # int32[cap, Wp, words]

    @property
    def cap(self) -> int:
        return self.ids.shape[0]

    @property
    def width(self) -> int:
        return self.ids.shape[1]


def materialize_fused(points: torch.Tensor, adj: torch.Tensor,
                      tile: int = 8192) -> FusedTable:
    """Build the fused table on the points' device, ``tile`` rows at a
    time, so no temporary larger than one tile's rows coexists with the
    table."""
    cap, W0 = adj.shape
    Wp = fused_width(W0)
    words = points.shape[1]
    dev = points.device
    ids = torch.full((cap, Wp), -1, dtype=torch.int32, device=dev)
    ids[:, :W0] = adj
    data = torch.zeros((cap, Wp, words), dtype=torch.int32, device=dev)
    for s in range(0, cap, tile):
        a = adj[s : s + tile].long()
        g = points[a.clamp(0, points.shape[0] - 1)]  # [t, W0, words]
        data[s : s + tile, :W0] = torch.where((a >= 0)[..., None], g, 0)
    return FusedTable(ids=ids, data=data)


def _check_inputs(table: FusedTable, queries, init_keys, ef: int,
                  max_steps: int) -> None:
    dev = queries.device
    for name, t in (("table.ids", table.ids), ("table.data", table.data),
                    ("queries", queries), ("init_keys", init_keys)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, queries on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    cap, W = table.ids.shape
    words = queries.shape[1]
    if table.data.shape != (cap, W, words):
        raise ValueError(
            f"table.data {tuple(table.data.shape)} != {(cap, W, words)}")
    if init_keys.shape != (queries.shape[0],):
        raise ValueError("init_keys must be int32[B]")
    if not 1 <= ef <= MAX_EF:
        raise ValueError(f"ef={ef} outside [1, {MAX_EF}]")
    if W > MAX_WIDTH:
        raise ValueError(f"table width {W} > {MAX_WIDTH}")
    if max_steps < 0:
        raise ValueError("max_steps must be >= 0")


def fused_beam_search(table: FusedTable, queries: torch.Tensor,
                      init_keys: torch.Tensor, *, ef: int, id_bits: int,
                      max_d: int, max_steps: int = 512,
                      packed: str = "auto"):
    """Run the fused search. Returns (keys int32[B, ef], visited int32[B],
    steps int32[B]); decode with ``key >> id_bits`` / ``key & mask``.
    ``init_keys`` holds each query's packed entry key (distance
    pre-clamped). ``max_d`` is clamped to ``key_clamp(id_bits, max_d)``.

    ``packed`` is accepted for the JAX signature and has no effect: the
    TPU's lane packing of several queries per vector row has no
    counterpart here (the kernel runs one query per warp)."""
    del packed
    _check_inputs(table, queries, init_keys, ef, max_steps)
    if not 1 <= id_bits <= 30:
        raise ValueError(f"id_bits={id_bits} outside [1, 30]")
    if table.cap > (1 << id_bits):
        raise ValueError(f"table cap {table.cap} > 2**id_bits")
    max_d = key_clamp(id_bits, max_d)
    key_inf = (max_d + 1) << id_bits
    if queries.device.type == "cpu":
        _kernels.count(fused_beam_search, "plain_calls")
        return beam_search_packed(table.ids, table.data, queries, init_keys,
                                  ef=ef, id_bits=id_bits, max_d=max_d,
                                  max_steps=max_steps)
    if queries.device.type != "cuda":
        raise ValueError(f"no fused beam search for {queries.device}")
    B = queries.shape[0]
    keys = torch.empty((B, ef), dtype=torch.int32, device=queries.device)
    visited = torch.empty(B, dtype=torch.int32, device=queries.device)
    steps = torch.empty(B, dtype=torch.int32, device=queries.device)
    if B == 0:
        return keys, visited, steps
    _kernels.launch_fused_beam_search(
        queries, init_keys, table.ids, table.data, keys, visited, steps,
        ef=ef, id_bits=id_bits, key_inf=key_inf, max_steps=max_steps,
    )
    _kernels.count(fused_beam_search, "kernel_launches")
    return keys, visited, steps


fused_beam_search.kernel_launches = 0
fused_beam_search.plain_calls = 0
