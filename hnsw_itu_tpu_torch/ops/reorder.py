"""Graph-locality node reordering (port of hnsw_itu_tpu/ops/reorder.py).

A BFS relabel from the entry point: the new id of a node is its BFS visit
rank, so the rows the next expansion reads sit near the expanded node in
the point and adjacency tables, and same-cluster nodes become contiguous
blocks. The relabel is isomorphic; ``knns`` maps results back to the
original dataset ids through ``id_map`` (new -> original). Reorder before
``enable_inline()``: the fused and mini tables embed node ids and are
made from the reordered arrays.

Quality (the JAX package's measurement): on exact paths the relabel is
neutral, only equal-distance tie order shifts; on the estimated-distance
mini path, ties broken by id prefer entry-near nodes, which the
bit-reversed tie order (``tie_bits``, on by default for a reordered
index) undoes.

``bfs_order``, ``full_permutation`` and ``window_shuffle`` are numpy and
copied unchanged, so both packages give the same permutation;
``permute_base`` works on tensors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bfs_order", "full_permutation", "permute_base",
           "window_shuffle"]


def window_shuffle(order: np.ndarray, window: int, seed: int = 0):
    """Shuffle ranks within consecutive ``window``-sized blocks, in place:
    keeps the locality of the relabel while making the tie order inside a
    window random. ``window <= 1`` leaves ``order`` as it is."""
    if window <= 1:
        return order
    rng = np.random.default_rng(seed)
    n = order.shape[0]
    for s in range(0, n, window):
        rng.shuffle(order[s : s + window])
    return order


def bfs_order(adj: np.ndarray, n: int, start: int) -> np.ndarray:
    """BFS visit order over the live graph: ``order[new] = old``.

    Per-level frontier expansion: each level gathers the frontier's
    adjacency rows, masks visited nodes and dedups, so within a level
    neighbors come in old-id order. Nodes not reached from ``start`` are
    appended in original order."""
    adj = np.asarray(adj)
    n = int(n)
    start = int(start)
    if n <= 0:
        return np.empty((0,), np.int32)
    visited = np.zeros(n, bool)
    order = np.empty(n, np.int32)
    pos = 0
    frontier = np.array([start], np.int32)
    visited[start] = True
    while frontier.size:
        order[pos : pos + frontier.size] = frontier
        pos += frontier.size
        nbrs = adj[frontier].ravel()
        nbrs = nbrs[(nbrs >= 0) & (nbrs < n)]
        nbrs = np.unique(nbrs)  # sorted + deduped
        nbrs = nbrs[~visited[nbrs]]
        visited[nbrs] = True
        frontier = nbrs.astype(np.int32)
    if pos < n:
        rest = np.nonzero(~visited)[0].astype(np.int32)
        order[pos : pos + rest.size] = rest
    return order


def full_permutation(order: np.ndarray,
                     cap: int) -> tuple[np.ndarray, np.ndarray]:
    """Extend a live-region order to the full capacity and invert:
    (perm, inv) with ``perm[new] = old`` over [0, cap), dead rows kept in
    place at the tail, and ``inv[old] = new``."""
    n = order.shape[0]
    perm = np.concatenate([order, np.arange(n, cap, dtype=np.int32)])
    inv = np.empty(cap, np.int32)
    inv[perm] = np.arange(cap, dtype=np.int32)
    return perm, inv


def permute_base(points: torch.Tensor, adj: torch.Tensor, deg: torch.Tensor,
                 perm: torch.Tensor, inv: torch.Tensor):
    """Apply a relabel to the base arrays (``NSW._apply_perm`` and
    ``HNSW.reorder``): ``adj`` entries are remapped old -> new through
    ``inv`` (entries < 0 stay), then every row moves to its new id.
    Returns (points, adj, deg). The JAX function also permutes the inline
    rows, which the port does not keep."""
    cap = adj.shape[0]
    p = perm.long()
    mapped = inv[adj.long().clamp(0, cap - 1)]
    adj = torch.where(adj >= 0, mapped, adj)[p]
    return points[p], adj, deg[p]
