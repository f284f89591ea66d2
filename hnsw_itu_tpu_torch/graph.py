"""Padded-adjacency graph tensors (port of hnsw_itu_tpu/graph.py).

    adj: int32[capacity, width]   (entries < 0 mean "no edge")
    deg: int32[capacity]          (live neighbor count per node)

Slice 1 only reads graphs (the host engine writes them); the vectorized
edge mutations of the batched build come with slice 2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GraphArrays(NamedTuple):
    adj: torch.Tensor  # int32[capacity, width]
    deg: torch.Tensor  # int32[capacity]

    @property
    def capacity(self) -> int:
        return self.adj.shape[0]

    @property
    def width(self) -> int:
        return self.adj.shape[1]
