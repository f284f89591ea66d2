"""Query steps over the two base-layer tables (port of the query side of
hnsw_itu_tpu/models/nsw.py): the fused table (``_fused_query_eligible``,
``_query_step_fused``) and, past the fused table's limits, the mini table
(``_mini_config_for``, ``_query_step_mini``).

The NSW index class and ``NSWBuilder`` are still to port (ROADMAP §1);
HNSW (models/hnsw.py) already queries through these steps.
"""

from __future__ import annotations

import torch

from ..ops.fused_search import (MAX_WIDTH, FusedTable, fused_beam_search,
                                fused_width, key_clamp)
from ..ops.metrics import popcount_sum
from ..ops.mini_search import (IINF, LANES, mini_beam_search, mini_subrows,
                               rerank_exact, rerank_onehop)
from ..ops.topk import inverse_permutation
from .base import ID_INF

# device memory left free beside the fused or mini table for the query
# batch's temporaries (entry block, sort, keys, rerank gathers)
_QUERY_MARGIN_BYTES = 2 << 30


def _free_device_bytes(device: torch.device) -> int:
    """Bytes a new table can take on a CUDA device: the CUDA driver's free
    memory plus what PyTorch's allocator holds cached but unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)


def _id_bits(cap: int) -> int:
    return max(1, (cap - 1).bit_length())


def fused_table_bytes(cap: int, width: int, words: int) -> int:
    """Bytes of the fused table of a ``cap``-row, ``width``-wide graph."""
    return cap * fused_width(width) * (words + 1) * 4


def _fused_query_eligible(points: torch.Tensor, adj: torch.Tensor,
                          metric) -> bool:
    """Can the fused kernel serve queries on this index? Needs the Hamming
    packed-key path, a fusable width, a clamp past half the metric bound
    (so ordering is intact where the beam works), and, on a CUDA device,
    the table to fit the card's free memory (``torch.cuda.mem_get_info``).
    On CPU tensors eligibility is decided by shape alone."""
    if metric.name != "hamming" or points is None:
        return False
    words = points.shape[1]
    cap, width = adj.shape
    if width > MAX_WIDTH:
        return False
    if key_clamp(_id_bits(cap), words * 32) < words * 16:
        return False
    if points.device.type == "cuda":
        need = fused_table_bytes(cap, width, words) + _QUERY_MARGIN_BYTES
        return need <= _free_device_bytes(points.device)
    return True


def _query_step_fused(points: torch.Tensor, fused: FusedTable,
                      qs: torch.Tensor, eps: torch.Tensor, *, k: int,
                      ef: int, max_steps: int):
    """Entry distances + packed init keys, the queries sorted by entry
    distance, the whole beam loop in one kernel, then un-permute and
    decode. ``eps`` are the per-query entry ids (the JAX step computes them
    itself from ``entry_sample``; the caller does it here). Returns
    (dists int32[B, k], ids int32[B, k], visited int32[B], steps
    int32[B])."""
    words = points.shape[1]
    id_bits = _id_bits(fused.cap)
    max_d = key_clamp(id_bits, words * 32)
    d0 = popcount_sum(points[eps.long()] ^ qs)
    # entry distance predicts search depth; sorted batches keep neighboring
    # warps (and the JAX kernel's lockstep blocks) at similar depths
    order = torch.argsort(d0, stable=True)
    inv = inverse_permutation(order)
    qs, d0, eps = qs[order], d0[order], eps[order]
    init = (d0.clamp(max=max_d) << id_bits) | eps
    keys, vis, stp = fused_beam_search(
        fused, qs.contiguous(), init.contiguous(), ef=max(ef, k),
        id_bits=id_bits, max_d=max_d, max_steps=max_steps,
    )
    keys, vis, stp = keys[inv], vis[inv], stp[inv]
    kinf = (max_d + 1) << id_bits
    valid = keys < kinf
    d = torch.where(valid, keys >> id_bits, ID_INF)
    i = torch.where(valid, keys & ((1 << id_bits) - 1), ID_INF)
    return d[:, :k], i[:, :k], vis, stp


def _mini_config_for(points: torch.Tensor, adj: torch.Tensor, metric,
                     budget_bytes: int | None = None) -> tuple[int, int]:
    """(W, mini_words) of the mini table (ops/mini_search.py) under the
    memory budget, or (0, 0) when the mini path cannot serve queries.

    The JAX policy: W in (64, 32), not wider than the graph's padded
    width; for each W the highest ``mini_words <= 31`` with
    ``(1 + mini_words) % (128 // W) == 0`` whose table fits; the highest
    ``mini_words`` wins, and the wider W at equal ``mini_words`` (more
    estimate bits beat more edges at equal bytes; below W=32 the row cuts
    into the forward edges). The same budget gives both packages the same
    pair. ``budget_bytes`` is the table's budget; None means, on a CUDA
    device, the card's free memory less the query margin that
    ``_fused_query_eligible`` also keeps, and on CPU tensors no limit."""
    if metric.name != "hamming" or points is None:
        return 0, 0
    words = points.shape[1]
    cap = adj.shape[0]
    try:
        Wfull = fused_width(adj.shape[1])
    except ValueError:
        return 0, 0
    budget = budget_bytes
    if budget is None and points.device.type == "cuda":
        budget = _free_device_bytes(points.device) - _QUERY_MARGIN_BYTES
    best = (0, 0)  # (mw, W), lexicographic
    for W in (64, 32):
        if W > Wfull:
            continue
        for mw in range(min(words, 31), 0, -1):
            if (1 + mw) % (LANES // W) != 0:
                continue
            table_bytes = cap * mini_subrows(W, mw) * LANES * 4
            if budget is None or table_bytes <= budget:
                best = max(best, (mw, W))
                break
    return best[1], best[0]


def _query_step_mini(points: torch.Tensor, mini: torch.Tensor,
                     qs: torch.Tensor, eps: torch.Tensor, *, k: int,
                     ef: int, max_steps: int, adj: torch.Tensor | None = None,
                     hop: int = 0, tie_bits: int = 0):
    """Prefix entry distances of every seed, the queries sorted by their
    nearest seed, the estimated-distance beam in one kernel, then an exact
    rerank of the whole final beam (``rerank_onehop`` seeded by the
    ``hop`` exact-best ids when ``hop > 0`` and ``adj`` is given), then
    un-permute. ``eps`` are int32[B] or [B, E] distinct seed ids. Returns
    (dists int32[B, k], ids int32[B, k], visited int32[B], steps
    int32[B])."""
    mw = mini.shape[2] - 1
    eps = eps[:, None] if eps.dim() == 1 else eps
    # PREFIX distances of every seed: the kernel ranks on estimates
    d0 = popcount_sum(points[eps.long(), :mw] ^ qs[:, None, :mw])  # [B, E]
    # entry-distance sort: see _query_step_fused
    order = torch.argsort(d0.min(dim=1).values, stable=True)
    inv = inverse_permutation(order)
    qs = qs[order].contiguous()
    _, ids, vis, stp = mini_beam_search(
        mini, qs, d0[order], eps[order], ef=max(ef, k), mini_words=mw,
        max_steps=max_steps, tie_bits=tie_bits,
    )
    if hop > 0 and adj is not None:
        dk, ik = rerank_onehop(points, adj, qs, ids, k=k, seeds=hop)
    else:
        dk, ik = rerank_exact(points, qs, ids, k=k)
    valid = ik < IINF
    d = torch.where(valid, dk, ID_INF)[inv]
    i = torch.where(valid, ik, ID_INF)[inv]
    return d, i, vis[inv], stp[inv]
