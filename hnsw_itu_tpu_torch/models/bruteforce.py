"""Exact k-NN by tiled scan — the ground-truth oracle (port of
hnsw_itu_tpu/models/bruteforce.py, Hamming).

Each point tile gives a dense query x point distance block through the
bit-unpack identity ``d = pop(q) + pop(p) - 2 <bits_q, bits_p>``: one
``torch.matmul`` on float32 0/1 operands with TF32 off (exact: every sum is
an integer <= 1024), where the JAX package leaves the same product to XLA.
The tile's k best by (distance, id) come from one ``torch.topk`` on the
packed int64 key ``(d << 32) | id``, and merge into the running k best by
a two-key sort (ops/topk.py). ``ef`` is ignored, like the reference
(bruteforce.rs:38).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.metrics import as_sketches, bit_dots, get_metric, popcount_sum, \
    unpack_bits
from ..ops.topk import merge_min_k
from .base import ID_INF, KnnResult

_INT32_MAX = np.iinfo(np.int32).max


class Bruteforce:
    """Exact index; is its own builder. Its tensors live on ``device``."""

    def __init__(self, metric="hamming", tile: int = 8192, *, device):
        self.metric = get_metric(metric) if isinstance(metric, str) else metric
        self.tile = tile
        self.device = torch.device(device)
        self._chunks: list[np.ndarray] = []
        self._points = None
        self._n = 0

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
            self._points = as_sketches(self._chunks[0], self.device)
        return self._points

    def knns(self, queries, k: int, ef: int = 0,
             batch: int = 1024) -> KnnResult:
        del ef  # ignored, like the reference
        pts = self._materialize()
        qs = as_sketches(queries, self.device)
        n, tile = self._n, self.tile
        # call-local bit table (4 bytes per bit), freed on return
        bits = unpack_bits(pts)
        pops = popcount_sum(pts)
        out_d, out_i = [], []
        for s in range(0, qs.shape[0], batch):
            q = qs[s : s + batch]
            qb, pq = unpack_bits(q), popcount_sum(q)
            b = q.shape[0]
            best_d = torch.full((b, k), _INT32_MAX, dtype=torch.int32,
                                device=self.device)
            best_i = torch.full((b, k), ID_INF, dtype=torch.int32,
                                device=self.device)
            for t in range(0, n, tile):
                te = min(t + tile, n)
                d = pq[:, None] + pops[None, t:te] - 2 * bit_dots(
                    qb, bits[t:te])
                ids = torch.arange(t, te, dtype=torch.int64,
                                   device=self.device)
                key = (d.to(torch.int64) << 32) | ids
                kk = min(k, te - t)
                top = torch.topk(key, kk, dim=1, largest=False).values
                best_d, best_i = merge_min_k(
                    best_d, best_i, (top >> 32).to(torch.int32),
                    (top & 0xFFFFFFFF).to(torch.int32), k)
            out_d.append(best_d)
            out_i.append(best_i)
        return KnnResult(torch.cat(out_d), torch.cat(out_i))
