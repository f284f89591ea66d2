"""The plain reference: exact Hamming distances and the exact top-k over
packed words, in plain PyTorch.

* ``hamming`` counts bits by SWAR arithmetic on the XOR of int32 words.
* ``exact_topk`` scans point blocks of at most 2^20 rows. A block's
  distances come from the bit identity d = pop(q) + pop(p) - 2 <q, p>,
  the dot products one matrix product of 0/1 operands: float16 on a card,
  accumulated in float32 with reduced-precision reductions off, float32
  on the CPU. Every product is 0 or 1 and every sum an integer of at most
  1024, which float32 holds exactly and float16 stores exactly (it holds
  every integer up to 2048). Each block's k best come from one
  ``torch.topk`` on the int32 key (d << 20) | row-in-block, unique and in
  (distance, id) order, and merge into the running k best the same way.
  ``check_topk`` recounts the winners by ``hamming``, so a product that
  was not exact would show.
* ``words`` limits both to a prefix of each sketch: the control (the
  reference at the precision below the configuration's 1024 bits).
* ``limits`` gives each query a population of its own, the points before
  its limit: the rows a stream had inserted before a row arrived.

Nothing here imports the program under test.
"""

from __future__ import annotations

import contextlib

import torch

INF = 0x7FFFFFFF  # empty slot: distance and id
_BLOCK_BITS = 20
_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32 word (the sign bit counted apart)."""
    v = x & 0x7FFFFFFF
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    v = v + (v >> 8)
    v = v + (v >> 16)
    return (v & 0x3F) + (x < 0).to(torch.int32)


def hamming(points: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
            words: int | None = None) -> torch.Tensor:
    """int32[B, k] distances from each query to ``points[ids]``; ids out
    of [0, len(points)) give ``INF``."""
    w = words or points.shape[1]
    ok = (ids >= 0) & (ids < points.shape[0])
    rows = points[ids.clamp(0, points.shape[0] - 1).long(), :w]
    d = popcount(rows ^ queries[:, None, :w]).sum(-1, dtype=torch.int32)
    return torch.where(ok, d, INF)


def _unpack(words: torch.Tensor, dtype) -> torch.Tensor:
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(words.shape[0], -1).to(dtype)


@contextlib.contextmanager
def _exact_products():
    m = torch.backends.cuda.matmul
    prev = (m.allow_tf32, m.allow_fp16_reduced_precision_reduction,
            torch.get_float32_matmul_precision())
    m.allow_tf32 = False
    m.allow_fp16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        m.allow_tf32, m.allow_fp16_reduced_precision_reduction = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def exact_topk(points: torch.Tensor, queries: torch.Tensor, k: int, *,
               words: int | None = None, query_block: int = 1024,
               rows: int | None = None, limits: torch.Tensor | None = None):
    """(dists int32[B, k], ids int32[B, k]) of the exact k nearest of the
    first ``rows`` points (default all) to each query, or of the first
    ``limits[b]`` points to query b, ascending by (distance, id); slots
    past the population are (INF, INF)."""
    w = words or points.shape[1]
    n = points.shape[0] if rows is None else rows
    if limits is not None:
        n = min(n, int(limits.max()))
    dev = points.device
    dt = torch.float16 if dev.type == "cuda" else torch.float32
    B = queries.shape[0]
    best_d = torch.full((B, k), INF, dtype=torch.int32, device=dev)
    best_i = torch.full((B, k), INF, dtype=torch.int32, device=dev)
    blk = 1 << _BLOCK_BITS
    with _exact_products():
        for p0 in range(0, n, blk):
            p = points[p0 : min(n, p0 + blk), :w]
            pb = _unpack(p, dt)
            pp = popcount(p).sum(-1, dtype=torch.int32)
            pos = torch.arange(p.shape[0], dtype=torch.int32, device=dev)
            kk = min(k, p.shape[0])
            for q0 in range(0, B, query_block):
                q = queries[q0 : q0 + query_block, :w]
                dots = (_unpack(q, dt) @ pb.T).to(torch.int32)
                d = popcount(q).sum(-1, dtype=torch.int32)[:, None] + pp \
                    - 2 * dots
                del dots
                key = (d << _BLOCK_BITS) | pos
                del d
                if limits is not None:
                    lim = limits[q0 : q0 + q.shape[0], None] - p0
                    key = torch.where(pos < lim, key, INF)
                top = torch.topk(key, kk, dim=1, largest=False).values
                del key
                none = top == INF  # a row past the query's population
                cd = torch.where(none, INF, top >> _BLOCK_BITS)
                ci = torch.where(none, INF, (top & (blk - 1)) + p0)
                md, mi = merge_topk(best_d[q0 : q0 + q.shape[0]],
                                    best_i[q0 : q0 + q.shape[0]], cd, ci, k)
                best_d[q0 : q0 + q.shape[0]] = md
                best_i[q0 : q0 + q.shape[0]] = mi
    return best_d, best_i


def merge_topk(d1, i1, d2, i2, k: int):
    """The k best (distance, id) pairs of two ascending candidate lists."""
    d = torch.cat([d1, d2], dim=1).to(torch.int64)
    i = torch.cat([i1, i2], dim=1).to(torch.int64)
    o = torch.argsort((d << 32) | i, dim=1)[:, :k]
    return d.gather(1, o).to(torch.int32), i.gather(1, o).to(torch.int32)


def check_topk(points, queries, dists, ids, words: int | None = None) -> int:
    """Rows whose listed distances differ from a recount by ``hamming``
    (0 for an exact scan)."""
    ok = ids != INF
    d = hamming(points, queries, torch.where(ok, ids, 0), words)
    bad = ok & (d != dists)
    return int(bad.any(dim=1).sum())
