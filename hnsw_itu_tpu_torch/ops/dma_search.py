"""Gather beam search: the build's exact search over an adjacency array
and a point array (counterpart of ``dma_beam_search`` in
hnsw_itu_tpu/ops/pallas_dma_search.py).

Per expansion the search reads the node's adjacency row, drops neighbors
already in the beam (or repeated earlier in the row), and fetches one point
per fresh neighbor, through ``node_map`` when one is given (graph-local id
-> point row: the upper HNSW levels). The JAX package's packed 128-lane
tables (``pack_adj``, ``pack_points``) are TPU layout and are not ported:
the kernel reads ``adj int32[cap, W]`` and ``points int32[cap_pts, words]``
as they are.

Keys are int64 ``d << 32 | id`` (``ops/mini_search.py``), so any id below
2^31 is exact; empty slots are ``KEY_INF``. The beam holds at most 128
keys: a larger ``ef`` raises ``NotImplementedError``. Callers route by
shape before the call (``models/_build.py`` ``search_route``): the general
beam search (``ops/search.py``) takes what the kernel does not.

``dma_beam_search`` launches ``csrc/dma_beam_search.cu`` for CUDA tensors
and runs the plain version (``ops/search.py`` ``beam_search_gather``) for
CPU tensors; any other device raises. ``dma_beam_search.kernel_launches``
and ``dma_beam_search.plain_calls`` count the two routes.
"""

from __future__ import annotations

import torch

from . import _kernels
from .mini_search import seed_keys
from .search import beam_search_gather

MAX_EF = 128  # largest beam the kernel holds
MAX_WIDTH = 128  # widest adjacency row the kernel reads
MAX_WORDS = 64  # widest sketch the kernel keeps in shared memory


def _check_inputs(adj, points, node_map, queries, init_d, init_i, ef,
                  max_steps) -> None:
    dev = queries.device
    named = [("adj", adj), ("points", points), ("queries", queries),
             ("init_d", init_d), ("init_i", init_i)]
    if node_map is not None:
        named.append(("node_map", node_map))
    for name, t in named:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, queries on {dev}")
    if ef > MAX_EF:
        raise NotImplementedError(
            f"ef={ef} > {MAX_EF}: the gather beam search holds at most "
            f"{MAX_EF} keys; the general beam search (ops/search.py) "
            "serves wider beams")
    if ef < 1:
        raise ValueError(f"ef={ef} < 1")
    if adj.dim() != 2 or not adj.is_contiguous():
        raise ValueError("adj must be a contiguous int32[cap, W]")
    cap, W = adj.shape
    if W > MAX_WIDTH:
        raise ValueError(f"adjacency width {W} > {MAX_WIDTH}: the general "
                         "beam search (ops/search.py) serves wider rows")
    if points.dim() != 2 or not points.is_contiguous():
        raise ValueError("points must be a contiguous int32[cap_pts, words]")
    if queries.dim() != 2 or queries.shape[1] != points.shape[1]:
        raise ValueError("queries must be int32[B, words] like points")
    if points.shape[1] > MAX_WORDS:
        raise ValueError(f"words={points.shape[1]} > {MAX_WORDS}")
    if node_map is not None and (node_map.dim() != 1
                                 or node_map.shape[0] < cap):
        raise ValueError(f"node_map must be int32[>= {cap}]")
    B = queries.shape[0]
    if init_i.shape[0] != B or init_d.shape != init_i.shape \
            or init_i.dim() not in (1, 2):
        raise ValueError("init_d/init_i must both be [B] or [B, E]")
    E = 1 if init_i.dim() == 1 else init_i.shape[1]
    if not 1 <= E <= ef:
        raise ValueError(f"{E} entry seeds, ef={ef}")
    if max_steps < 0:
        raise ValueError("max_steps must be >= 0")


def dma_beam_search_plain(adj: torch.Tensor, points: torch.Tensor,
                          node_map: torch.Tensor | None,
                          queries: torch.Tensor, init_d: torch.Tensor,
                          init_i: torch.Tensor, *, ef: int,
                          max_steps: int = 2048, stats: dict | None = None):
    """The plain PyTorch route of ``dma_beam_search`` on any device (the
    CPU route, and the yardstick the kernel is held to on the card).
    ``stats``, when given, accumulates the rows and valid edges the search
    reads."""
    _check_inputs(adj, points, node_map, queries, init_d, init_i, ef,
                  max_steps)
    return beam_search_gather(adj, points, node_map, queries, init_d, init_i,
                              ef=ef, max_steps=max_steps, stats=stats)


def dma_beam_search(adj: torch.Tensor, points: torch.Tensor,
                    node_map: torch.Tensor | None, queries: torch.Tensor,
                    init_d: torch.Tensor, init_i: torch.Tensor, *, ef: int,
                    max_steps: int = 2048):
    """Exact beam search from ``init_d``/``init_i`` ([B] or [B, E]: the
    seeds' distances and graph-local ids). Returns (keys int64[B, ef],
    visited int32[B], steps int32[B]); keys ``d << 32 | id`` ascending,
    empty slots ``KEY_INF``."""
    if queries.device.type == "cpu":
        _kernels.count(dma_beam_search, "plain_calls")
        return dma_beam_search_plain(adj, points, node_map, queries, init_d,
                                     init_i, ef=ef, max_steps=max_steps)
    if queries.device.type != "cuda":
        raise ValueError(f"no gather beam search for {queries.device}")
    _check_inputs(adj, points, node_map, queries, init_d, init_i, ef,
                  max_steps)
    B = queries.shape[0]
    keys = torch.empty((B, ef), dtype=torch.int64, device=queries.device)
    visited = torch.empty(B, dtype=torch.int32, device=queries.device)
    steps = torch.empty(B, dtype=torch.int32, device=queries.device)
    if B > 0:
        _kernels.launch_dma_beam_search(
            queries.contiguous(), seed_keys(init_d, init_i, 0), adj, points,
            None if node_map is None else node_map.contiguous(), keys,
            visited, steps, ef=ef, max_steps=max_steps,
        )
        _kernels.count(dma_beam_search, "kernel_launches")
    return keys, visited, steps


dma_beam_search.kernel_launches = 0
dma_beam_search.plain_calls = 0
