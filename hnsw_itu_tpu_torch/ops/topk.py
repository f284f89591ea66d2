"""Top-k / ordering primitives (port of hnsw_itu_tpu/ops/topk.py).

The order is the JAX package's two-key (distance, id) order. ``torch.sort``
takes one key, so a two-key sort is two stable passes: by id, then by
distance.
"""

from __future__ import annotations

import torch


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """Inverse of a permutation vector by one scatter."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype,
                              device=order.device)
    return inv


def sort_by_dist(d: torch.Tensor, i: torch.Tensor, *extras: torch.Tensor):
    """Sort parallel tensors ascending by (distance, id) along the last
    axis."""
    cols = (d, i) + extras
    o = torch.argsort(i, dim=-1, stable=True)
    cols = tuple(torch.gather(c, -1, o) for c in cols)
    o = torch.argsort(cols[0], dim=-1, stable=True)
    return tuple(torch.gather(c, -1, o) for c in cols)


def min_k(d: torch.Tensor, i: torch.Tensor, k: int):
    """k smallest (distance, id) pairs, ascending, ties by id."""
    sd, si = sort_by_dist(d, i)
    return sd[..., :k], si[..., :k]


def merge_min_k(d_a, i_a, d_b, i_b, k: int):
    """Merge two candidate lists and keep the k smallest by (dist, id)."""
    return min_k(torch.cat([d_a, d_b], dim=-1),
                 torch.cat([i_a, i_b], dim=-1), k)
