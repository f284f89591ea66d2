"""Exact k-NN by tiled scan — the ground-truth oracle (port of
hnsw_itu_tpu/models/bruteforce.py), for every metric.

The scan walks point tiles; each tile gives a dense query x point block
and its k best by (distance, id) merge into each query's running k best
by a two-key sort (ops/topk.py). ``ef`` is ignored, like the reference
(bruteforce.rs:38).

* Hamming: the bit-unpack identity ``d = pop(q) + pop(p) - 2 <bits_q,
  bits_p>``, one ``torch.matmul`` on float32 0/1 operands with TF32 off
  (exact: every sum is an integer <= 1024). Each point tile is unpacked
  once inside the loop (4 bytes per bit, about 32 MB a tile), never the
  whole table, so the oracle stays on the card at any N.
* Every other metric: ``metric.pairwise_mxu`` (``l2``: the norm
  expansion; ``l2int`` and registered metrics: their ``pairwise``).

A tile's k best come from one ``torch.topk`` on the int64 key ``(d << 32)
| position``, where ``d`` is the distance or, for floats, its bits mapped
to an order-preserving integer. The JAX package scans Hamming and
``l2int`` past 2M points on the host (its TPU cannot hold the bit table);
the port has no such route: the tiled scan gives the same exact (d, id)
top-k on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.metrics import (Hamming, as_points, bit_dots, get_metric,
                           popcount_sum, unpack_bits)
from ..ops.topk import merge_min_k
from .base import ID_INF, KnnResult, search_one


def _order_key(d: torch.Tensor) -> torch.Tensor:
    """int64 keys in the order of ``d``: integers as they are; float32
    bits flipped so that integer order is float order (-0.0 read as
    +0.0)."""
    if not d.is_floating_point():
        return d.to(torch.int64)
    b = (d.to(torch.float32) + 0.0).view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b).to(torch.int64)


def _tile_topk(d: torch.Tensor, start: int, k: int):
    """The k best (distance, id) of a [B, T] tile whose ids start at
    ``start``, ascending."""
    pos = torch.arange(d.shape[1], dtype=torch.int64, device=d.device)
    key = (_order_key(d) << 32) | pos
    idx = torch.topk(key, min(k, d.shape[1]), dim=1, largest=False).indices
    return d.gather(1, idx), (idx + start).to(torch.int32)


class Bruteforce:
    """Exact index; is its own builder. Its tensors live on ``device``."""

    def __init__(self, metric="hamming", tile: int = 8192, *, device):
        self.metric = get_metric(metric) if isinstance(metric, str) else metric
        self.tile = tile
        self.device = torch.device(device)
        self._chunks: list[np.ndarray] = []
        self._points = None
        self._n = 0

    def add(self, point) -> None:
        self.extend(np.asarray(point)[None])

    def extend(self, points) -> None:
        self._chunks.append(np.asarray(points))
        self._n += len(self._chunks[-1])
        self._points = None

    def build(self) -> "Bruteforce":
        self._materialize()
        return self

    def size(self) -> int:
        return self._n

    def _materialize(self) -> torch.Tensor:
        if self._points is None:
            if not self._chunks:
                raise ValueError("empty index")
            self._chunks = [np.concatenate(self._chunks, axis=0)]
            self._points = as_points(self._chunks[0], self.device)
        return self._points

    def search(self, query, k: int, ef: int = 0) -> KnnResult:
        """k nearest neighbors of one query (a [words] row)."""
        return search_one(self, query, k, ef)

    def knns(self, queries, k: int, ef: int = 0,
             batch: int = 1024) -> KnnResult:
        del ef  # ignored, like the reference
        pts = self._materialize()
        qs = as_points(queries, self.device)
        m, dev = self.metric, self.device
        batches = [(s, min(s + batch, qs.shape[0]))
                   for s in range(0, qs.shape[0], batch)]
        best = [(torch.full((e - s, k), m.inf, dtype=m.dist_dtype,
                            device=dev),
                 torch.full((e - s, k), ID_INF, dtype=torch.int32,
                            device=dev)) for s, e in batches]
        hamming = isinstance(m, Hamming)
        if hamming:
            qbits, qpop = unpack_bits(qs), popcount_sum(qs)
        for t in range(0, self._n, self.tile):
            p = pts[t : t + self.tile]
            if hamming:  # this tile's bit table only
                pbits, ppop = unpack_bits(p), popcount_sum(p)
            for j, (s, e) in enumerate(batches):
                if hamming:
                    d = qpop[s:e, None] + ppop[None, :] - 2 * bit_dots(
                        qbits[s:e], pbits)
                else:
                    d = m.pairwise_mxu(qs[s:e], p)
                td, ti = _tile_topk(d, t, k)
                best[j] = merge_min_k(*best[j], td, ti, k)
        if not best:
            empty = torch.empty((0, k), dtype=torch.int32, device=dev)
            return KnnResult(empty.to(m.dist_dtype), empty)
        return KnnResult(torch.cat([b[0] for b in best]),
                         torch.cat([b[1] for b in best]))
