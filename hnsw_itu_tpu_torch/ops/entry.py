"""Sampled entry-point selection (port of hnsw_itu_tpu/ops/entry.py).

Exact distances from every query to a strided sample of the dataset in
one dense block, then the per-query argmin as the entry of the base-layer
search. Ties go to the lowest sample position: ``torch.argmin`` returns
the first minimum, as ``jnp.argmin`` does.
"""

from __future__ import annotations

import torch

from .metrics import Metric


def strided_sample_ids(n: int, sample_size: int, *,
                       device) -> torch.Tensor:
    """sample_size evenly-strided ids over [0, n), on ``device``."""
    s = torch.arange(sample_size, dtype=torch.int64, device=device)
    return ((s * n) // sample_size).clamp(0, n - 1).to(torch.int32)


def sampled_entry(points: torch.Tensor, qs: torch.Tensor, n: int, *,
                  sample_size: int, metric: Metric) -> torch.Tensor:
    """Per-query entry ids int32[B]: argmin over a strided sample."""
    ids = strided_sample_ids(n, sample_size, device=points.device)
    d = metric.pairwise_mxu(qs, points[ids.long()])  # [B, S]
    return ids[torch.argmin(d, dim=1)]


def sampled_entry_topk(points: torch.Tensor, qs: torch.Tensor, n: int, *,
                       sample_size: int, beams: int, metric: Metric):
    """Per-query top-``beams`` entry ids over the strided sample, by
    iterative argmin (column 0 equals ``sampled_entry``). Returns
    (ids int32[B, beams], dists [B, beams] of ``metric.dist_dtype``),
    ascending by distance,
    ties to the lowest sample position; ids are distinct when n >=
    sample_size."""
    if beams > sample_size:
        raise ValueError(f"beams={beams} > sample_size={sample_size}")
    ids = strided_sample_ids(n, sample_size, device=points.device)
    d = metric.pairwise_mxu(qs, points[ids.long()])  # [B, S]
    pos = torch.arange(sample_size, device=d.device)[None, :]
    out_i, out_d = [], []
    for _ in range(beams):
        p0 = torch.argmin(d, dim=1)
        out_i.append(ids[p0])
        out_d.append(d.gather(1, p0[:, None])[:, 0])
        d = torch.where(pos == p0[:, None], metric.inf, d)
    return torch.stack(out_i, dim=1), torch.stack(out_d, dim=1)
