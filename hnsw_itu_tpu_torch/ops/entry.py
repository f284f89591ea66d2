"""Sampled entry-point selection (port of hnsw_itu_tpu/ops/entry.py).

Exact distances from every query to a strided sample of the dataset in
one dense block, then the per-query argmin as the entry of the base-layer
search. Ties go to the lowest sample position: ``torch.argmin`` returns
the first minimum, as ``jnp.argmin`` does.
"""

from __future__ import annotations

import torch

from .metrics import Hamming


def strided_sample_ids(n: int, sample_size: int,
                       device=None) -> torch.Tensor:
    """sample_size evenly-strided ids over [0, n)."""
    s = torch.arange(sample_size, dtype=torch.int64, device=device)
    return ((s * n) // sample_size).clamp(0, n - 1).to(torch.int32)


def sampled_entry(points: torch.Tensor, qs: torch.Tensor, n: int, *,
                  sample_size: int, metric: Hamming) -> torch.Tensor:
    """Per-query entry ids int32[B]: argmin over a strided sample."""
    ids = strided_sample_ids(n, sample_size, device=points.device)
    d = metric.pairwise_mxu(qs, points[ids.long()])  # [B, S]
    return ids[torch.argmin(d, dim=1)]
