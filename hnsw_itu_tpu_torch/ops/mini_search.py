"""Mini-table beam search: estimated-distance search over truncated
sketches, then an exact rerank (counterpart of the XLA side of
hnsw_itu_tpu/ops/pallas_dma_search.py).

Past 2^21 points the fused table's packed int32 key ``(d << id_bits) |
id`` no longer holds a 1024-bit distance, and past a few million points
the full fused table no longer fits the card. The mini table keeps, for
each of a node's first ``W`` neighbors, the neighbor's id and the first
``mini_words`` words of its sketch. The search ranks on those prefix
("estimated") distances; the final beam is reranked on full sketches.

The JAX package lays the table out in 128-lane TPU rows. The port gives it
its own layout, one neighbor's values contiguous:

  table  int32[cap, W, 1 + mini_words]
         table[e, j, 0]      id of neighbor j of node e, -1 = no edge
         table[e, j, 1 + t]  word t of that neighbor's sketch (t < mini_words)

At ``mini_words = 31`` one neighbor is 128 B. ``W = fused_width(width)``
(the next power of two, <= 128); padding columns and absent edges hold id
-1 and zero words.

Beam keys are two planes ``(d, id)`` compared lexicographically, carried
as one int64 ``d << 32 | id`` (both fields are non-negative int32), so any
id below 2^31 is exact. Empty slots are ``(DINF, IINF)``. With
``tie_bits > 0`` the id plane holds ``bitrev_ids(id)``: ties then order by
the bit-reversed id, and ids are decoded for the row fetch and at the
output.

``mini_beam_search`` launches ``csrc/mini_beam_search.cu`` for CUDA
tensors and runs the plain version (``ops/search.py``
``beam_search_two_plane``) for CPU tensors; any other device raises.
``mini_beam_search.kernel_launches`` and ``mini_beam_search.plain_calls``
count the two routes. The reranks ``rerank_exact`` and ``rerank_onehop``
(XLA code in the JAX package) route the same way: ``csrc/exact_rerank.cu``
for CUDA tensors, ``rerank_exact_plain`` / ``rerank_onehop_plain`` for CPU
tensors, with the same two counters.
"""

from __future__ import annotations

import torch

from . import _kernels
from .fused_search import fused_width
from .metrics import popcount_sum
from .search import beam_search_two_plane
from .topk import sort_by_dist

LANES = 128  # lanes of a row of the JAX package's table layout
MAX_EF = 128  # largest beam the kernel holds
MAX_RERANK_K = 2048  # widest one-hop answer the rerank kernel holds
DINF = 0x7FFF0000  # > any Hamming distance, headroom for compares
IINF = 0x7FFFFFFF
KEY_INF = (DINF << 32) | IINF  # the empty beam slot as an int64 key
_LOW32 = 0xFFFFFFFF


def bitrev_ids(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Reverse the low ``bits`` bits of each id: a bijective involution on
    [0, 2**bits), so the same call encodes and decodes. Computed on the
    32-bit pattern of ``x`` in int64, so every shift is logical; the
    result has ``x``'s dtype. Ids at or past 2**bits lose their high bits,
    as in the JAX function."""
    v = x.to(torch.int64) & _LOW32
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    v = (v >> 16) | ((v << 16) & _LOW32)
    return (v >> (32 - bits)).to(x.dtype)


def mini_subrows(W: int, mini_words: int) -> int:
    """128-lane rows per node in the JAX package's layout. The port's
    table holds the same values, so a node takes ``mini_subrows(W, mw) *
    512`` bytes in both; the (W, mini_words) policy (models/nsw.py
    ``_mini_config_for``) keeps the JAX rule that this divides exactly."""
    tot = (1 + mini_words) * W
    if tot % LANES != 0:
        raise ValueError(
            f"(1+mini_words)*W = {tot} must be a multiple of {LANES}")
    return tot // LANES


def materialize_mini(points: torch.Tensor, adj: torch.Tensor, *,
                     mini_words: int, tile: int = 8192) -> torch.Tensor:
    """Build the mini table on the points' device, ``tile`` rows at a
    time, so no temporary larger than one tile's rows coexists with the
    table."""
    cap, W0 = adj.shape
    W = fused_width(W0)
    words = points.shape[1]
    if not 1 <= mini_words <= words:
        raise ValueError(f"mini_words={mini_words} outside [1, {words}]")
    table = torch.zeros((cap, W, 1 + mini_words), dtype=torch.int32,
                        device=points.device)
    table[:, :, 0] = -1
    for s in range(0, cap, tile):
        a = adj[s : s + tile]
        ok = a >= 0
        g = points[a.long().clamp(0, points.shape[0] - 1), :mini_words]
        table[s : s + tile, :W0, 0] = torch.where(ok, a, -1)
        table[s : s + tile, :W0, 1:] = torch.where(ok[..., None], g, 0)
    return table


def seed_keys(init_d: torch.Tensor, init_i: torch.Tensor,
              tie_bits: int) -> torch.Tensor:
    """int64[B, E] beam seeds from [B] or [B, E] prefix distances and ids:
    ids tie-encoded (where < IINF), keys sorted ascending by (d, id)."""
    B = init_i.shape[0]
    d = init_d.reshape(B, -1).to(torch.int64)
    i = init_i.reshape(B, -1).to(torch.int64)
    if tie_bits:
        i = torch.where(i < IINF, bitrev_ids(i, tie_bits), i)
    return torch.sort((d << 32) | i, dim=1).values.contiguous()


def split_keys(keys: torch.Tensor, tie_bits: int):
    """int64 beam keys -> (d int32, real ids int32); empty slots come out
    as (DINF, IINF)."""
    d = (keys >> 32).to(torch.int32)
    i = (keys & _LOW32).to(torch.int32)
    if tie_bits:
        i = torch.where(i < IINF, bitrev_ids(i, tie_bits), i)
    return d, i


def _check_inputs(table, queries, init_d, init_i, ef, mini_words,
                  max_steps, tie_bits) -> None:
    dev = queries.device
    for name, t in (("table", table), ("queries", queries),
                    ("init_d", init_d), ("init_i", init_i)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, queries on {dev}")
    if table.dim() != 3 or not table.is_contiguous():
        raise ValueError("table must be a contiguous int32[cap, W, 1+mw]")
    cap, W, mv = table.shape
    if mv != 1 + mini_words:
        raise ValueError(f"table holds {mv - 1} prefix words, "
                         f"mini_words={mini_words}")
    if queries.dim() != 2 or mini_words > queries.shape[1]:
        raise ValueError("queries must be int32[B, words >= mini_words]")
    if W > LANES:
        raise ValueError(f"table width {W} > {LANES}")
    B = queries.shape[0]
    if init_i.shape[0] != B or init_d.shape != init_i.shape \
            or init_i.dim() not in (1, 2):
        raise ValueError("init_d/init_i must both be [B] or [B, E]")
    E = 1 if init_i.dim() == 1 else init_i.shape[1]
    if not 1 <= ef <= MAX_EF:
        raise ValueError(f"ef={ef} outside [1, {MAX_EF}]")
    if not 1 <= E <= ef:
        raise ValueError(f"{E} entry seeds, ef={ef}")
    if max_steps < 0:
        raise ValueError("max_steps must be >= 0")
    if not 0 <= tie_bits <= 31 or (tie_bits and cap > (1 << tie_bits)):
        raise ValueError(f"cap={cap} needs tie_bits in "
                         f"[{(cap - 1).bit_length()}, 31], got {tie_bits}")


def mini_beam_search_plain(table: torch.Tensor, queries: torch.Tensor,
                           init_d: torch.Tensor, init_i: torch.Tensor, *,
                           ef: int, mini_words: int, max_steps: int = 256,
                           tie_bits: int = 0, stats: dict | None = None):
    """The plain PyTorch route of ``mini_beam_search`` on any device (the
    CPU route, and the yardstick the kernel is held to on the card).
    ``stats``, when given, accumulates the row fetches and valid edges the
    search reads (``beam_search_two_plane``)."""
    _check_inputs(table, queries, init_d, init_i, ef, mini_words, max_steps,
                  tie_bits)
    keys, vis, steps = beam_search_two_plane(
        table, queries, seed_keys(init_d, init_i, tie_bits), ef=ef,
        max_steps=max_steps, tie_bits=tie_bits, stats=stats,
    )
    return (*split_keys(keys, tie_bits), vis, steps)


def mini_beam_search(table: torch.Tensor, queries: torch.Tensor,
                     init_d: torch.Tensor, init_i: torch.Tensor, *,
                     ef: int, mini_words: int, max_steps: int = 256,
                     tie_bits: int = 0):
    """Beam search on prefix distances over the mini table.

    ``init_d`` / ``init_i`` are [B] (one seed) or [B, E] (E distinct seeds
    per query, any order): the seeds' PREFIX distances (the same
    ``mini_words``) and their ids. Returns (dists int32[B, ef], ids
    int32[B, ef], visited int32[B], steps int32[B]), ascending by
    (d, bit-reversed id when ``tie_bits`` > 0, else id); empty slots are
    (DINF, IINF). Ids are real ids either way. Rerank the ids with full
    sketches (``rerank_exact``) for final results."""
    if queries.device.type == "cpu":
        _kernels.count(mini_beam_search, "plain_calls")
        return mini_beam_search_plain(table, queries, init_d, init_i, ef=ef,
                                      mini_words=mini_words,
                                      max_steps=max_steps, tie_bits=tie_bits)
    if queries.device.type != "cuda":
        raise ValueError(f"no mini beam search for {queries.device}")
    _check_inputs(table, queries, init_d, init_i, ef, mini_words, max_steps,
                  tie_bits)
    B = queries.shape[0]
    keys = torch.empty((B, ef), dtype=torch.int64, device=queries.device)
    visited = torch.empty(B, dtype=torch.int32, device=queries.device)
    steps = torch.empty(B, dtype=torch.int32, device=queries.device)
    if B > 0:
        _kernels.launch_mini_beam_search(
            queries.contiguous(), seed_keys(init_d, init_i, tie_bits), table,
            keys, visited, steps, ef=ef, tie_bits=tie_bits,
            max_steps=max_steps,
        )
        _kernels.count(mini_beam_search, "kernel_launches")
    return (*split_keys(keys, tie_bits), visited, steps)


mini_beam_search.kernel_launches = 0
mini_beam_search.plain_calls = 0


def _exact(points, queries, ids):
    """Full-sketch distances of ``ids`` int32[B, H] (< 0 or >= cap:
    invalid) -> (d, ids) with invalid slots (DINF, IINF)."""
    cap = points.shape[0]
    valid = (ids >= 0) & (ids < cap)
    d = popcount_sum(points[ids.long().clamp(0, cap - 1)]
                     ^ queries[:, None, :])
    return (torch.where(valid, d, DINF),
            torch.where(valid, ids, torch.full_like(ids, IINF)))


def _drop_repeated_ids(d, ids):
    """Keep the best (d, id) copy of each id; later copies become
    (DINF, IINF). Order is (id, d) afterwards."""
    ids, d = sort_by_dist(ids, d)  # (id, d) order: the best copy first
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    return torch.where(dup, DINF, d), torch.where(dup, IINF, ids)


def rerank_exact_plain(points: torch.Tensor, queries: torch.Tensor,
                       cand_ids: torch.Tensor, *, k: int,
                       dedup: bool = False):
    """The plain PyTorch route of ``rerank_exact`` on any device (the CPU
    route, and the yardstick the kernel is held to on the card)."""
    d, ids = _exact(points, queries, cand_ids)
    if dedup:
        d, ids = _drop_repeated_ids(d, ids)
    d, ids = sort_by_dist(d, ids)
    return d[:, :k], ids[:, :k]


def rerank_onehop_plain(points: torch.Tensor, adj: torch.Tensor,
                        queries: torch.Tensor, cand_ids: torch.Tensor, *,
                        k: int, seeds: int):
    """The plain PyTorch route of ``rerank_onehop`` on any device."""
    B, H = cand_ids.shape
    cap = points.shape[0]
    bd, bi = rerank_exact_plain(points, queries, cand_ids, k=H)
    seed_ids = bi[:, :seeds]
    ok = (seed_ids >= 0) & (seed_ids < cap)
    rows = adj[seed_ids.long().clamp(0, cap - 1)]  # [B, seeds, W]
    rows = torch.where(ok[:, :, None], rows, -1).reshape(B, -1)
    hd, hi = _exact(points, queries, rows)
    d, ids = _drop_repeated_ids(torch.cat([bd, hd], dim=1),
                                torch.cat([bi, hi], dim=1))
    d, ids = sort_by_dist(d, ids)
    return d[:, :k], ids[:, :k]


def _check_rerank(points, queries, cand_ids, adj, k, seeds) -> str:
    """Checks both routes share; returns the device type that serves."""
    dev = queries.device
    named = (("points", points), ("queries", queries),
             ("cand_ids", cand_ids)) + ((("adj", adj),) if adj is not None
                                        else ())
    for name, t in named:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, queries on {dev}")
    if k < 0 or seeds < 0:
        raise ValueError(f"k={k} and seeds={seeds} must be >= 0")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no exact rerank for {dev}")
    return dev.type


def _rerank_kernel(points, queries, cand_ids, adj, *, k, seeds, dedup):
    """Shapes checked, outputs allocated, ``csrc/exact_rerank.cu``
    launched: (d, ids) int32[B, min(k, pool)], the pool the H candidates
    and, with ``seeds``, the ``min(seeds, H)`` seeds' adjacency rows."""
    if points.dim() != 2 or not points.is_contiguous():
        raise ValueError("points must be a contiguous int32[cap, words]")
    if queries.dim() != 2 or queries.shape[1] != points.shape[1]:
        raise ValueError(f"queries must be int32[B, {points.shape[1]}]")
    if cand_ids.dim() != 2 or cand_ids.shape[0] != queries.shape[0]:
        raise ValueError("cand_ids must be int32[B, H], one row a query")
    B, H = cand_ids.shape
    if H > MAX_EF:
        raise ValueError(f"{H} candidates a query > {MAX_EF}")
    seeds = min(seeds, H)
    pool = H
    if seeds:
        if adj.dim() != 2 or not adj.is_contiguous() \
                or adj.shape[0] < points.shape[0]:
            raise ValueError("adj must be a contiguous int32[>= cap, W]")
        pool += seeds * adj.shape[1]
    kout = min(k, pool)
    if kout > MAX_RERANK_K:
        raise ValueError(f"answer width {kout} > {MAX_RERANK_K}")
    d = torch.empty((B, kout), dtype=torch.int32, device=queries.device)
    i = torch.empty_like(d)
    if d.numel():
        _kernels.launch_exact_rerank(
            points, queries.contiguous(), cand_ids.contiguous(),
            adj if seeds else None, d, i, seeds=seeds, dedup=dedup)
    return d, i


def rerank_exact(points: torch.Tensor, queries: torch.Tensor,
                 cand_ids: torch.Tensor, *, k: int, dedup: bool = False):
    """Exact rerank of the search's candidates int32[B, H]: full-sketch
    Hamming distances, ascending (d, id), the first k. ``dedup`` drops
    repeated ids (keeping the best copy) first. Invalid slots come out as
    (DINF, IINF). CPU tensors take ``rerank_exact_plain``, CUDA tensors
    the kernel (H <= ``MAX_EF``)."""
    if _check_rerank(points, queries, cand_ids, None, k, 0) == "cpu":
        _kernels.count(rerank_exact, "plain_calls")
        return rerank_exact_plain(points, queries, cand_ids, k=k,
                                  dedup=dedup)
    out = _rerank_kernel(points, queries, cand_ids, None, k=k, seeds=0,
                         dedup=dedup)
    if out[0].numel():
        _kernels.count(rerank_exact, "kernel_launches")
    return out


rerank_exact.kernel_launches = 0
rerank_exact.plain_calls = 0


def rerank_onehop(points: torch.Tensor, adj: torch.Tensor,
                  queries: torch.Tensor, cand_ids: torch.Tensor, *, k: int,
                  seeds: int):
    """One-hop exact rerank: exact-rank the candidates, take the ``seeds``
    best, add their full adjacency rows to the pool, drop repeated ids and
    return the exact top-k of the union. CPU tensors take
    ``rerank_onehop_plain``, CUDA tensors the kernel (H <= ``MAX_EF``, an
    answer at most ``MAX_RERANK_K`` wide)."""
    if _check_rerank(points, queries, cand_ids, adj, k, seeds) == "cpu":
        _kernels.count(rerank_onehop, "plain_calls")
        return rerank_onehop_plain(points, adj, queries, cand_ids, k=k,
                                   seeds=seeds)
    out = _rerank_kernel(points, queries, cand_ids, adj, k=k, seeds=seeds,
                         dedup=True)
    if out[0].numel():
        _kernels.count(rerank_onehop, "kernel_launches")
    return out


rerank_onehop.kernel_launches = 0
rerank_onehop.plain_calls = 0
