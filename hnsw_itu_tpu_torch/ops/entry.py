"""Sampled entry-point selection (port of hnsw_itu_tpu/ops/entry.py).

Exact distances from every query to a strided sample of the dataset, then
the per-query argmin as the entry of the base-layer search. Ties go to the
lowest sample position: ``torch.argmin`` returns the first minimum, as
``jnp.argmin`` does.

``sampled_entry`` routes by what its inputs show. Hamming sketches on
CUDA tensors take ``csrc/sampled_entry.cu``: one launch computes the
sample's ids, gathers its rows, runs the Hamming block on the tensor cores
and takes the argmin, and writes only the int32[B] answer; a shape it
cannot take (more than ``MAX_WORDS`` words, as kernel #7) raises before
the launch. Everything else takes ``sampled_entry_plain`` (CPU tensors;
the ``l2`` and ``l2int`` metrics on any device): the ids, the gathered
sample and ``metric.pairwise_mxu`` blocks, then ``argmin``. There is no
fallback between the two: they give the same ids.
``sampled_entry.kernel_launches`` and ``sampled_entry.plain_calls`` count
the two routes. ``sampled_entry_topk`` (several entry beams) is plain on
every device.

Two departures from the JAX module, neither of which changes an entry
where the JAX one is right:

* The sample's ids are computed in int64. The JAX ``strided_sample_ids``
  computes ``s * n`` in int32, which wraps once ``(sample_size - 1) * n``
  passes 2^31 - 1 (n past 2,099,202 at a 1024-point sample): its sample then
  repeats ids and piles onto id 0 (ROADMAP §3).
* The plain routes compute the query x sample block
  ``_ENTRY_BLOCK_ELEMS`` elements at a time, queries split by rows, so the
  entry's temporaries stay inside the query margin beside a table
  (``models/nsw.py``) at any query batch and sample size: one [8192, 65536]
  block would be 2.1 GB a temporary. The kernel makes no such block.
"""

from __future__ import annotations

import torch

from . import _kernels
from .metrics import Hamming, Metric

# elements of one [queries, sample] distance block (256 MiB as int32; the
# float32 products and the sums beside it make about three of these)
_ENTRY_BLOCK_ELEMS = 1 << 26
MAX_WORDS = 64  # widest sketch the kernel holds in registers
MAX_SAMPLE = 1 << 30  # sample positions the kernel's int arithmetic takes
_MAX_ROWS = 2**31 - 1  # rows the C entry's int arguments carry


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


def sampled_entry_plain(points: torch.Tensor, qs: torch.Tensor, n: int, *,
                        sample_size: int, metric: Metric) -> torch.Tensor:
    """Per-query entry ids int32[B] on any device: the strided sample's ids
    and rows, ``metric.pairwise_mxu`` blocks, ``argmin``."""
    ids = strided_sample_ids(n, sample_size, device=points.device)
    sample = points[ids.long()]
    return ids[torch.cat([torch.argmin(d, dim=1)
                          for d in _sample_blocks(qs, sample, metric)])]


def _check_launch(points: torch.Tensor, qs: torch.Tensor, n: int,
                  sample_size: int) -> None:
    """What the kernel takes: int32 sketches on one device, contiguous,
    1 to ``MAX_WORDS`` words, 1 <= n <= rows of ``points``, 1 <=
    sample_size <= ``MAX_SAMPLE``; raises otherwise."""
    if points.dtype != torch.int32 or qs.dtype != torch.int32:
        raise TypeError(f"sketches must be int32, got {points.dtype}, "
                        f"{qs.dtype}")
    if points.device != qs.device:
        raise ValueError(f"points on {points.device}, queries on {qs.device}")
    if points.dim() != 2 or qs.dim() != 2 or qs.shape[1] != points.shape[1]:
        raise ValueError(f"points {tuple(points.shape)} and queries "
                         f"{tuple(qs.shape)} must be [rows, words] alike")
    if not (points.is_contiguous() and qs.is_contiguous()):
        raise ValueError("points and queries must be contiguous")
    words = points.shape[1]
    if not 1 <= words <= MAX_WORDS:
        raise ValueError(f"words={words} outside [1, {MAX_WORDS}]")
    if max(points.shape[0], qs.shape[0]) > _MAX_ROWS:
        raise ValueError(f"more than {_MAX_ROWS} rows")
    if not 1 <= n <= points.shape[0]:
        raise ValueError(f"n={n} outside [1, {points.shape[0]}]")
    if not 1 <= sample_size <= MAX_SAMPLE:
        raise ValueError(f"sample_size={sample_size} outside "
                         f"[1, {MAX_SAMPLE}]")


def kernel_route(points, metric: Metric) -> bool:
    """Whether ``sampled_entry`` takes the kernel for these points: Hamming
    sketches on a CUDA device."""
    return isinstance(metric, Hamming) and points.device.type == "cuda"


def sampled_entry(points: torch.Tensor, qs: torch.Tensor, n: int, *,
                  sample_size: int, metric: Metric) -> torch.Tensor:
    """Per-query entry ids int32[B]: argmin over a strided sample, on the
    kernel where ``kernel_route`` says so, else ``sampled_entry_plain``."""
    if kernel_route(points, metric):
        n = int(n)
        _check_launch(points, qs, n, sample_size)
        out = torch.empty(qs.shape[0], dtype=torch.int32, device=qs.device)
        if out.numel():
            _kernels.launch_sampled_entry(points, qs, out, n=n,
                                          sample_size=sample_size)
            _kernels.count(sampled_entry, "kernel_launches")
        return out
    _kernels.count(sampled_entry, "plain_calls")
    return sampled_entry_plain(points, qs, n, sample_size=sample_size,
                               metric=metric)


sampled_entry.kernel_launches = 0
sampled_entry.plain_calls = 0


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
