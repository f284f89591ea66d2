"""Index API surface (port of hnsw_itu_tpu/models/base.py).

Results are fixed-shape (distance, id) tensor pairs sorted ascending by
(distance, id), padded with (INT32_MAX, ID_INF), exactly as in the JAX
package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

ID_INF = np.iinfo(np.int32).max


class KnnResult(NamedTuple):
    """Batched k-NN result: [..., k] tensors, ascending (distance, id),
    invalid slots = (INT32_MAX, ID_INF)."""

    dists: torch.Tensor
    ids: torch.Tensor


def search_one(index, query, k: int, ef: int) -> KnnResult:
    """k nearest neighbors of one query (a [words] row) through
    ``index.knns``: [k] tensors."""
    q = query[None] if isinstance(query, torch.Tensor) else \
        np.asarray(query)[None]
    r = index.knns(q, k, ef)
    return KnnResult(r.dists[0], r.ids[0])


@dataclass
class IndexOptions:
    """The JAX package's ``IndexOptions``: same fields, same defaults, so a
    saved index's options load unchanged. ``HNSWBuilder`` and
    ``NSWBuilder`` read them all; with ``reorder=True`` their ``build()``
    relabels the index in BFS order and seals the builder."""

    ef_construction: int = 100
    connections: int = 16
    max_connections: int = 32
    size: int = 0
    expand: int = 1
    batch_size: int = 1024
    reorder: bool = False
    prune_budget: int = 256
    seed: int = 0
    entry_sample: int = 1024
    host_warmup: int = field(default_factory=lambda: int(
        os.environ.get("HNSW_TPU_HOST_WARMUP", 50_000)))
    scan_group: int = field(default_factory=lambda: int(
        os.environ.get("HNSW_TPU_SCAN_GROUP", 8)))

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.batch_size = 1 << (self.batch_size - 1).bit_length()


class LazyStats:
    """Mapping over per-query search stats whose [nq] visited/steps
    tensors stay on their device until first access, so a timed query run
    never waits on a device-to-host copy it does not read."""

    def __init__(self, vis: torch.Tensor, steps: torch.Tensor, nq: int):
        self._vis, self._steps, self._nq = vis, steps, nq
        self._d = None

    def _mat(self):
        if self._d is None:
            vq = self._vis.cpu().numpy()
            sq = self._steps.cpu().numpy()
            self._d = {
                "visited": int(vq.sum()),
                "steps": int(sq.sum()),
                "queries": self._nq,
                "visited_q": vq,
                "steps_q": sq,
            }
            self._vis = self._steps = None
        return self._d

    def __getitem__(self, k):
        return self._mat()[k]

    def get(self, k, default=None):
        return self._mat().get(k, default)

    def __contains__(self, k):
        return k in self._mat()

    def __iter__(self):
        return iter(self._mat())

    def keys(self):
        return self._mat().keys()

    def __repr__(self):
        return repr(self._mat())


def rng_seed(opts: IndexOptions) -> int:
    """Deterministic level-RNG seed derived from the build parameters (the
    JAX package's formula, so both builders draw the same levels)."""
    return (
        opts.size
        ^ opts.ef_construction
        ^ opts.connections
        ^ opts.max_connections
        ^ opts.seed
    ) & 0xFFFFFFFF
