"""Sampled entry-point selection (port of hnsw_itu_tpu/ops/entry.py).

Exact distances from every query to a strided sample of the dataset in
dense blocks, then the per-query argmin as the entry of the base-layer
search. Ties go to the lowest sample position: ``torch.argmin`` returns
the first minimum, as ``jnp.argmin`` does.

Two departures from the JAX module, neither of which changes an entry
where the JAX one is right:

* The sample's ids are computed in int64. The JAX ``strided_sample_ids``
  computes ``s * n`` in int32, which wraps once ``(sample_size - 1) * n``
  passes 2^31 - 1 (n past 2,099,202 at a 1024-point sample): its sample then
  repeats ids and piles onto id 0 (ROADMAP §3).
* The query x sample block is computed ``_ENTRY_BLOCK_ELEMS`` elements at
  a time, queries split by rows, so the entry's temporaries stay inside
  the query margin beside a table (``models/nsw.py``) at any query batch
  and sample size: one [8192, 65536] block would be 2.1 GB a temporary.
"""

from __future__ import annotations

import torch

from .metrics import Metric

# elements of one [queries, sample] distance block (256 MiB as int32; the
# float32 products and the sums beside it make about three of these)
_ENTRY_BLOCK_ELEMS = 1 << 26


def strided_sample_ids(n: int, sample_size: int, *,
                       device) -> torch.Tensor:
    """sample_size evenly-strided ids over [0, n), on ``device``."""
    s = torch.arange(sample_size, dtype=torch.int64, device=device)
    return ((s * n) // sample_size).clamp(0, n - 1).to(torch.int32)


def _sample_blocks(qs: torch.Tensor, sample: torch.Tensor, metric: Metric):
    """[rows, S] distance blocks of ``qs`` (in order) against the sample,
    each of at most ``_ENTRY_BLOCK_ELEMS`` elements; one block when ``qs``
    is empty."""
    step = max(1, _ENTRY_BLOCK_ELEMS // max(1, sample.shape[0]))
    for s in range(0, max(1, qs.shape[0]), step):
        yield metric.pairwise_mxu(qs[s : s + step], sample)


def sampled_entry(points: torch.Tensor, qs: torch.Tensor, n: int, *,
                  sample_size: int, metric: Metric) -> torch.Tensor:
    """Per-query entry ids int32[B]: argmin over a strided sample."""
    ids = strided_sample_ids(n, sample_size, device=points.device)
    sample = points[ids.long()]
    return ids[torch.cat([torch.argmin(d, dim=1)
                          for d in _sample_blocks(qs, sample, metric)])]


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
    sample = points[ids.long()]
    pos = torch.arange(sample_size, device=points.device)[None, :]
    out_i, out_d = [], []
    for d in _sample_blocks(qs, sample, metric):  # [rows, S]
        bi, bd = [], []
        for _ in range(beams):
            p0 = torch.argmin(d, dim=1)
            bi.append(ids[p0])
            bd.append(d.gather(1, p0[:, None])[:, 0])
            d = torch.where(pos == p0[:, None], metric.inf, d)
        out_i.append(torch.stack(bi, dim=1))
        out_d.append(torch.stack(bd, dim=1))
    return torch.cat(out_i), torch.cat(out_d)
