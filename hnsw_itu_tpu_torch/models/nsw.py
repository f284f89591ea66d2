"""Fused-kernel query step (port of the query side of
hnsw_itu_tpu/models/nsw.py: ``_query_step_fused`` and
``_fused_query_eligible``).

The NSW index class and its batched build come with slice 2; HNSW
(models/hnsw.py) already queries through this step.
"""

from __future__ import annotations

import torch

from ..ops.fused_search import (MAX_WIDTH, FusedTable, fused_beam_search,
                                fused_width, key_clamp)
from ..ops.metrics import popcount_sum
from ..ops.topk import inverse_permutation
from .base import ID_INF

# device memory left free beside the fused table for the query batch's
# temporaries (entry block, sort, keys)
_QUERY_MARGIN_BYTES = 2 << 30


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
        free, _ = torch.cuda.mem_get_info(points.device)
        need = fused_table_bytes(cap, width, words) + _QUERY_MARGIN_BYTES
        return need <= free
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
