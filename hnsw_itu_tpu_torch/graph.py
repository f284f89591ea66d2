"""Padded-adjacency graph tensors and their batched edge mutations (port of
hnsw_itu_tpu/graph.py).

    adj: int32[capacity, width]   (entries < 0 mean "no edge")
    deg: int32[capacity]          (live neighbor count per node)

The JAX functions are pure and write with ``.at[...].set(..., mode="drop")``
to an out-of-range row for the entries they skip. Here the mutations
update ``adj`` and ``deg`` in place (a build holds one copy of its graph)
and mask the skipped entries out instead of writing them anywhere; each
function returns the graph it was given. Each boolean index makes the
host wait for the card; it runs in a ``sync`` range
(``utils/instrument.py`` ``masked``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops.metrics import HAMMING
from .ops.select import select_neighbors, select_neighbors_points
from .utils.instrument import masked, sync


class GraphArrays(NamedTuple):
    adj: torch.Tensor  # int32[capacity, width]
    deg: torch.Tensor  # int32[capacity]

    @property
    def capacity(self) -> int:
        return self.adj.shape[0]

    @property
    def width(self) -> int:
        return self.adj.shape[1]


def make_graph(capacity: int, width: int, *, device) -> GraphArrays:
    return GraphArrays(
        adj=torch.full((capacity, width), -1, dtype=torch.int32,
                       device=device),
        deg=torch.zeros(capacity, dtype=torch.int32, device=device),
    )


def set_rows(g: GraphArrays, ids: torch.Tensor,
             rows: torch.Tensor) -> GraphArrays:
    """Overwrite whole rows (the forward edges of freshly inserted points)
    and their degrees; ``ids`` < 0 are skipped, ``rows`` entries < 0 are
    padding."""
    ok = ids >= 0
    t = masked(ids, ok).long()
    g.adj[t] = masked(rows, ok)
    g.deg[t] = (masked(rows, ok) >= 0).sum(dim=1, dtype=torch.int32)
    return g


class AppendResult(NamedTuple):
    graph: GraphArrays
    # per edge, sorted by (target, source):
    targets: torch.Tensor  # int32[E] target ids (invalid -> capacity)
    sources: torch.Tensor  # int32[E] new-point ids aligned with targets
    cols: torch.Tensor  # int32[E] column each edge was stored at (clamped)
    written: torch.Tensor  # bool[E] stored (False: row full or invalid)
    incoming: torch.Tensor  # int32[capacity+1] per-target incoming count
    pos: torch.Tensor  # int32[E] unclamped landing position (>= W: overflow)


def append_reverse_edges(g: GraphArrays, targets: torch.Tensor,
                         sources: torch.Tensor) -> AppendResult:
    """Place each ``source`` into ``adj[target]`` after the current degree,
    edges grouped by target in (target, source) order. Pairs with target <
    0 are ignored; appends past the row width are not stored
    (``written`` False)."""
    cap, W = g.adj.shape
    t = torch.where(targets >= 0, targets, cap).to(torch.int64)
    s = sources.to(torch.int64)
    # one int64 key in (target, source) order: s + 2^31 fits 32 bits
    o = torch.argsort((t << 32) + (s + (1 << 31)))
    t, s = t[o], s[o]
    n = t.shape[0]
    idx = torch.arange(n, device=t.device)
    run_start = torch.ones(n, dtype=torch.bool, device=t.device)
    run_start[1:] = t[1:] != t[:-1]
    seg_start = torch.cummax(torch.where(run_start, idx, 0), dim=0).values
    pos = g.deg[t.clamp(0, cap - 1)].to(torch.int64) + idx - seg_start
    ok = (t < cap) & (pos < W)
    col = pos.clamp(0, W - 1)
    g.adj[masked(t, ok), masked(col, ok)] = masked(s, ok).to(torch.int32)
    g.deg.index_add_(0, masked(t, ok),
                     torch.ones_like(masked(t, ok), dtype=torch.int32))
    with sync():  # on a card, bincount reads t's minimum and maximum
        incoming = torch.bincount(t, minlength=cap + 1).to(torch.int32)
    return AppendResult(g, t.to(torch.int32), s.to(torch.int32),
                        col.to(torch.int32), ok, incoming,
                        pos.to(torch.int32))


def prune_rows(g: GraphArrays, node_ids: torch.Tensor,
               node_pts: torch.Tensor, nbr_pts: torch.Tensor, m_max: int,
               extra_ids: torch.Tensor | None = None,
               extra_pts: torch.Tensor | None = None,
               metric=HAMMING) -> GraphArrays:
    """Re-run the diversity heuristic over each listed node's neighborhood
    and rebuild its row (the degree-cap prune of insert_neighbors) on
    ``metric``. The JAX function builds the candidate block with
    ``metric.pairwise``. An integer metric takes ``metric.pairwise_block``
    here instead, on the candidates in pop order: the same integers (for
    Hamming, the dense Hamming kernel on the card). A float metric takes
    ``metric.pairwise`` as JAX does (for ``l2`` the direct difference,
    not the norm expansion of its ``pairwise_block``).

    Args:
      node_ids: int32[P] nodes to prune (< 0 entries are skipped).
      node_pts: [P, D] the nodes' own points.
      nbr_pts:  [P, W, D] the points of each node's current row.
      m_max: neighbors kept per row (<= W).
      extra_ids/extra_pts: optional [P, X] spilled candidates (-1 padded)
        and their points, joining each row's candidate set.
    """
    cap, W = g.adj.shape
    rows = g.adj[node_ids.long().clamp(0, cap - 1)]  # [P, W]
    live = (node_ids >= 0)[:, None]
    valid = (rows >= 0) & live
    if extra_ids is not None:
        rows = torch.cat([rows, extra_ids], dim=1)
        valid = torch.cat([valid, (extra_ids >= 0) & live], dim=1)
        nbr_pts = torch.cat([nbr_pts, extra_pts], dim=1)
    d = metric.one_to_many(node_pts, nbr_pts)
    if metric.dist_dtype.is_floating_point:
        sel_rows, _, n_sel = select_neighbors(
            d, rows, metric.pairwise(nbr_pts, nbr_pts), valid, m_max)
    else:
        sel_rows, _, n_sel = select_neighbors_points(nbr_pts, d, rows, valid,
                                                     m_max, metric)
    if W > m_max:
        sel_rows = torch.cat([sel_rows, torch.full(
            (sel_rows.shape[0], W - m_max), -1, dtype=torch.int32,
            device=sel_rows.device)], dim=1)
    ok = node_ids >= 0
    t = masked(node_ids, ok).long()
    g.adj[t] = masked(sel_rows, ok)
    g.deg[t] = masked(n_sel, ok)
    return g
