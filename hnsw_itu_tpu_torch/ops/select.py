"""SELECT-NEIGHBORS-HEURISTIC (HNSW paper Alg. 4), batched (port of
hnsw_itu_tpu/ops/select.py).

Pop candidates in ascending (distance, id) order; keep candidate ``e`` iff
fewer than ``m`` are kept so far and, for every already-kept ``r``,
``dist(e, r) > e.distance``. The JAX function is written for one list and
``vmap``-ed; here every function takes a leading axis of R lists and the
sequential kept-set dependency is one loop over the C candidates,
vectorized across the lists. The pop order, ``jnp.lexsort((ids, d))``, is
two stable sorts: by id, then by distance.

``select_neighbors_points`` computes the candidate-to-candidate block
itself, on the candidates' points in pop order, through the metric's
``pairwise_block`` (for Hamming the dense Hamming kernel on the card), so
the block never needs permuting. Distances may be int32 or float32; the
dtype's maximum (+inf for floats) marks an invalid candidate, as in JAX.
"""

from __future__ import annotations

import torch

from .metrics import HAMMING

_INT32_MAX = 0x7FFFFFFF


def _dtype_inf(d: torch.Tensor):
    """The +infinity of ``d``'s dtype: its maximum, or inf for floats."""
    return float("inf") if d.is_floating_point() else \
        torch.iinfo(d.dtype).max


def pop_order(d: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor):
    """Per-list pop order: (perm int64[R, C], sorted d, sorted ids, sorted
    valid). Invalid candidates sort last as (dtype max, INT32_MAX), ties
    in their original order."""
    d = torch.where(valid, d, _dtype_inf(d))
    ids_key = torch.where(valid, ids, _INT32_MAX)
    perm = torch.argsort(ids_key, dim=1, stable=True)
    perm = perm.gather(1, torch.argsort(d.gather(1, perm), dim=1,
                                        stable=True))
    return (perm, d.gather(1, perm), ids_key.gather(1, perm),
            valid.gather(1, perm))


def _select_sorted(d_s, ids_s, valid_s, pd_s, m: int):
    """The heuristic over lists already in pop order, ``pd_s`` [R, C, C]
    in the same order. Returns (sel_ids int32[R, m], sel_d [R, m] of
    d's dtype, n_sel int32[R])."""
    R, C = d_s.shape
    dev = d_s.device
    keep = torch.zeros((R, C), dtype=torch.bool, device=dev)
    cnt = torch.zeros(R, dtype=torch.int32, device=dev)
    for i in range(C):
        # every kept r (all at positions < i) needs dist(e, r) > d(e)
        blocked = (keep & (pd_s[:, i, :] <= d_s[:, i : i + 1])).any(dim=1)
        take = valid_s[:, i] & (cnt < m) & ~blocked
        keep[:, i] = take
        cnt += take.to(torch.int32)
    # compact the kept entries to the front, in pop order
    rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    pos = torch.where(keep, rank, m).long()  # dropped -> the spare column
    sel_ids = torch.full((R, m + 1), -1, dtype=torch.int32, device=dev)
    sel_d = torch.full((R, m + 1), _dtype_inf(d_s), dtype=d_s.dtype,
                       device=dev)
    sel_ids.scatter_(1, pos, ids_s.to(torch.int32))
    sel_d.scatter_(1, pos, d_s)
    return sel_ids[:, :m], sel_d[:, :m], cnt


def select_neighbors(d: torch.Tensor, ids: torch.Tensor,
                     pair_d: torch.Tensor, valid: torch.Tensor, m: int):
    """Diversity-prune R candidate lists.

    Args:
      d:      [R, C] candidate -> query distances (int32 or float32).
      ids:    int32[R, C] candidate ids (tie-break and output).
      pair_d: [R, C, C] candidate <-> candidate distances (d's order).
      valid:  bool[R, C] real candidates.
      m:      max neighbors to keep.

    Returns (sel_ids int32[R, m], sel_d [R, m], n_sel int32[R]): selected
    ids in pop order, padded with -1 / the dtype's maximum.
    """
    perm, d_s, ids_s, valid_s = pop_order(d, ids, valid)
    R, C = perm.shape
    pd_s = pair_d.gather(1, perm[:, :, None].expand(R, C, C))
    pd_s = pd_s.gather(2, perm[:, None, :].expand(R, C, C))
    return _select_sorted(d_s, ids_s, valid_s, pd_s, m)


def select_neighbors_points(cand_pts: torch.Tensor, d: torch.Tensor,
                            ids: torch.Tensor, valid: torch.Tensor, m: int,
                            metric=HAMMING):
    """``select_neighbors`` with the pairwise block computed here from the
    candidates' points ``cand_pts`` [R, C, D], on the points in pop order
    (``metric.pairwise_block``)."""
    perm, d_s, ids_s, valid_s = pop_order(d, ids, valid)
    pts_s = cand_pts.gather(1, perm[:, :, None].expand(-1, -1,
                                                       cand_pts.shape[2]))
    pd_s = metric.pairwise_block(pts_s, pts_s)
    return _select_sorted(d_s, ids_s, valid_s, pd_s, m)
