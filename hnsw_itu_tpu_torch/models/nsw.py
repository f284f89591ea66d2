"""NSW, the single-layer navigable small world index, and its builder
(port of hnsw_itu_tpu/models/nsw.py), with the query steps HNSW
(models/hnsw.py) shares.

Query steps over the two base-layer tables: the fused table
(``_fused_query_eligible``, ``_query_step_fused``) and, past the fused
table's limits, the mini table (``_mini_config_for``,
``_query_step_mini``). Every other call runs the general beam search
(``ops/search.py``), where ``_inline_query_fits`` stands for the JAX
package's inline base rows.

Only Hamming indexes get a fused or mini table; every other metric
(``l2int``, ``l2``, a registered one) serves on the general route.

``NSWBuilder`` builds as the JAX builder does on its gather route: the
native host engine inserts the first ``host_warmup`` points (Hamming and
``l2int``, the metrics it has), then the batched device chunks
(``models/_build.py`` ``chunk_step`` with node map None) insert the rest,
the scanned groups as a loop of chunk steps. The JAX inline build rows and
its scanned dispatch are TPU layout and are not ported.

``reorder`` relabels an index in BFS order (``ops/reorder.py``); with
``IndexOptions.reorder`` the builder does it in ``build()`` and is then
sealed.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import native
from ..graph import GraphArrays, make_graph
from ..ops.entry import sampled_entry, sampled_entry_topk
from ..ops.fused_search import (MAX_EF, MAX_WIDTH, FusedTable,
                                fused_beam_search, fused_width, key_clamp,
                                materialize_fused)
from ..ops.metrics import as_points, get_metric, popcount_sum
from ..ops.mini_search import (IINF, LANES, materialize_mini,
                               mini_beam_search, mini_subrows, rerank_exact,
                               rerank_onehop)
from ..ops.reorder import (bfs_order, full_permutation, permute_base,
                           window_shuffle)
from ..ops.search import batched_beam_search
from ..ops.topk import inverse_permutation
from ..utils.instrument import host_range, span, to_device
from . import _build
from .base import ID_INF, IndexOptions, KnnResult, LazyStats, search_one
from .step_graphs import StepGraphs

# device memory left free beside the fused or mini table for the query
# batch's temporaries (entry block, sort, keys, rerank gathers)
_QUERY_MARGIN_BYTES = 2 << 30


def _free_device_bytes(device: torch.device) -> int:
    """Bytes a new table can take on a CUDA device: the CUDA driver's free
    memory plus what PyTorch's allocator holds cached but unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)


def _id_bits(cap: int) -> int:
    return max(1, (cap - 1).bit_length())


def fused_table_bytes(cap: int, width: int, words: int) -> int:
    """Bytes of the fused table of a ``cap``-row, ``width``-wide graph."""
    return cap * fused_width(width) * (words + 1) * 4


def _fused_query_eligible(points: torch.Tensor, adj: torch.Tensor,
                          metric, tables: int = 1) -> bool:
    """Can the fused kernel serve queries on this index? Needs the Hamming
    packed-key path, a fusable width, a clamp past half the metric bound
    (so ordering is intact where the beam works), and, on a CUDA device,
    ``tables`` tables of this shape to fit the card's free memory
    (``torch.cuda.mem_get_info``) together: the shards of a sharded index
    that share one card (``parallel/sharded.py``) are reckoned at once.
    On CPU tensors eligibility is decided by shape alone."""
    if metric.name != "hamming" or points is None:
        return False
    words = points.shape[1]
    cap, width = adj.shape
    if width > MAX_WIDTH:
        return False
    if key_clamp(_id_bits(cap), words * 32) < words * 16:
        return False
    if points.device.type == "cuda":
        need = tables * fused_table_bytes(cap, width, words) \
            + _QUERY_MARGIN_BYTES
        return need <= _free_device_bytes(points.device)
    return True


def _inline_query_fits(points: torch.Tensor, adj: torch.Tensor) -> bool:
    """Would the JAX package hold inline base rows (each row's neighbor
    sketches, ``cap * W * words`` words) for this index? On a CUDA device
    by the budget rule of ``_fused_query_eligible`` (the card's free
    memory less the query margin); on CPU tensors always."""
    if points.device.type != "cuda":
        return True
    need = adj.shape[0] * adj.shape[1] * points.shape[1] * 4
    return need + _QUERY_MARGIN_BYTES <= _free_device_bytes(points.device)


def _by_entry_distance(d0: torch.Tensor, *xs: torch.Tensor):
    """``xs`` with rows sorted by entry distance ``d0`` [B] (stable), and
    the function that puts its arguments' rows back in the callers' order.
    Entry distance predicts search depth: sorted batches keep neighboring
    warps (and the JAX kernel's lockstep blocks) at similar depths."""
    order = torch.argsort(d0, stable=True)
    inv = inverse_permutation(order)
    return [x[order] for x in xs], lambda *ys: [y[inv] for y in ys]


def _query_step_fused(points: torch.Tensor, fused: FusedTable,
                      qs: torch.Tensor, eps: torch.Tensor, *, k: int,
                      ef: int, max_steps: int):
    """Entry distances + packed init keys, the queries sorted by entry
    distance, the whole beam loop in one kernel, then un-permute and
    decode. ``eps`` are the per-query entry ids (the JAX step computes them
    itself from ``entry_sample``; the caller does it here). Returns
    (dists int32[B, k], ids int32[B, k], visited int32[B], steps
    int32[B])."""
    words = points.shape[1]
    id_bits = _id_bits(fused.cap)
    max_d = key_clamp(id_bits, words * 32)
    d0 = popcount_sum(points[eps.long()] ^ qs)
    (qs, d0, eps), back = _by_entry_distance(d0, qs, d0, eps)
    init = (d0.clamp(max=max_d) << id_bits) | eps
    keys, vis, stp = fused_beam_search(
        fused, qs.contiguous(), init.contiguous(), ef=max(ef, k),
        id_bits=id_bits, max_d=max_d, max_steps=max_steps,
    )
    keys, vis, stp = back(keys, vis, stp)
    kinf = (max_d + 1) << id_bits
    valid = keys < kinf
    d = torch.where(valid, keys >> id_bits, ID_INF)
    i = torch.where(valid, keys & ((1 << id_bits) - 1), ID_INF)
    return d[:, :k], i[:, :k], vis, stp


def _mini_config_for(points: torch.Tensor, adj: torch.Tensor, metric,
                     budget_bytes: int | None = None) -> tuple[int, int]:
    """(W, mini_words) of the mini table (ops/mini_search.py) under the
    memory budget, or (0, 0) when the mini path cannot serve queries.

    The JAX policy: W in (64, 32), not wider than the graph's padded
    width; for each W the highest ``mini_words <= 31`` with
    ``(1 + mini_words) % (128 // W) == 0`` whose table fits; the highest
    ``mini_words`` wins, and the wider W at equal ``mini_words`` (more
    estimate bits beat more edges at equal bytes; below W=32 the row cuts
    into the forward edges). The same budget gives both packages the same
    pair. ``budget_bytes`` is the table's budget; None means, on a CUDA
    device, the card's free memory less the query margin that
    ``_fused_query_eligible`` also keeps, and on CPU tensors no limit."""
    if metric.name != "hamming" or points is None:
        return 0, 0
    words = points.shape[1]
    cap = adj.shape[0]
    try:
        Wfull = fused_width(adj.shape[1])
    except ValueError:
        return 0, 0
    budget = budget_bytes
    if budget is None and points.device.type == "cuda":
        budget = _free_device_bytes(points.device) - _QUERY_MARGIN_BYTES
    best = (0, 0)  # (mw, W), lexicographic
    for W in (64, 32):
        if W > Wfull:
            continue
        for mw in range(min(words, 31), 0, -1):
            if (1 + mw) % (LANES // W) != 0:
                continue
            table_bytes = cap * mini_subrows(W, mw) * LANES * 4
            if budget is None or table_bytes <= budget:
                best = max(best, (mw, W))
                break
    return best[1], best[0]


def _query_step_mini(points: torch.Tensor, mini: torch.Tensor,
                     qs: torch.Tensor, eps: torch.Tensor, *, k: int,
                     ef: int, max_steps: int, adj: torch.Tensor | None = None,
                     hop: int = 0, tie_bits: int = 0, timings=None):
    """Prefix entry distances of every seed, the queries sorted by their
    nearest seed, the estimated-distance beam in one kernel, then an exact
    rerank of the whole final beam (``rerank_onehop`` seeded by the
    ``hop`` exact-best ids when ``hop > 0`` and ``adj`` is given; the span
    "knns.rerank", ``timings``: CUDA event pairs by span,
    ``utils/instrument.py``), then un-permute. ``eps`` are int32[B] or
    [B, E] distinct seed ids. Returns (dists int32[B, k], ids int32[B, k],
    visited int32[B], steps int32[B])."""
    mw = mini.shape[2] - 1
    eps = eps[:, None] if eps.dim() == 1 else eps
    # PREFIX distances of every seed: the kernel ranks on estimates
    d0 = popcount_sum(points[eps.long(), :mw] ^ qs[:, None, :mw])  # [B, E]
    (qs, d0, eps), back = _by_entry_distance(d0.min(dim=1).values, qs, d0,
                                             eps)
    _, ids, vis, stp = mini_beam_search(
        mini, qs, d0, eps, ef=max(ef, k), mini_words=mw,
        max_steps=max_steps, tie_bits=tie_bits,
    )
    with span(timings, "knns.rerank", qs.device):
        if hop > 0 and adj is not None:
            dk, ik = rerank_onehop(points, adj, qs, ids, k=k, seeds=hop)
        else:
            dk, ik = rerank_exact(points, qs, ids, k=k)
    valid = ik < IINF
    return back(torch.where(valid, dk, ID_INF), torch.where(valid, ik, ID_INF),
                vis, stp)


class QueryIndex:
    """The query side NSW and HNSW share, as the JAX classes do: one
    base-layer table built once by ``enable_inline``, the route choice,
    ``knns`` (one ``_step`` a query batch, the step every shard of a
    ``ShardedNSW`` runs too; on a card a table route's step replays as
    one CUDA graph, ``step_graphs.py``) and ``search``. A subclass holds
    ``device``, ``points``, ``n``, ``ep``, ``metric`` and its base graph
    (``_base()``), and gives the entries used without a sampled entry
    (``_walk_entries``)."""

    def _init_query_state(self) -> None:
        self.timings = None  # dict: CUDA event pairs by span (knns.*)
        self.query_expand = 1  # >1: the general route, E-way expansion
        self.query_batch = 1024
        self.query_dedup = "bitmask"  # the general route's dedup
        self.query_entry_sample = 0  # >0: sampled entry (ops/entry.py)
        self.query_entry_beams = 1  # >1: seed with the sample's top-B (mini)
        self.query_hop = 0  # >0: one-hop exact rerank seeds (mini path)
        self.query_tie = "auto"  # tie order: auto, id or bitrev
        self.max_steps = None  # None = auto (2*ef, floor 64)
        self.last_stats = None
        self.last_route = None  # "fused", "mini" or "general": last knns
        # where the JAX enable_inline would hold inline base rows: the
        # general route then dedups by beam, as those rows force in JAX
        self.inline_rows = False
        self.fused = None  # fused query table (ops/fused_search.py)
        self.mini = None  # mini query table (ops/mini_search.py)
        self.mini_words = 0
        self.mini_W = 0
        self.id_map = None  # int32[cap] new->original id (set by reorder)
        self._graphs = StepGraphs()  # the query step's CUDA graphs

    def _base(self) -> GraphArrays:
        raise NotImplementedError

    def _walk_entries(self, q: torch.Tensor, max_steps: int):
        raise NotImplementedError

    def size(self) -> int:
        return self.n

    def _steps_cap(self, ef: int) -> int:
        return self.max_steps if self.max_steps else max(2 * ef, 64)

    def _tie_bits(self) -> int:
        """Bits of the bit-reversed tie order: 0 (ties by id) for "id",
        and for "auto" on an index that was not reordered."""
        tie = self.query_tie
        if tie == "id" or (tie == "auto" and self.id_map is None):
            return 0
        if tie not in ("auto", "bitrev"):
            raise ValueError(f"unknown query_tie {tie!r}")
        return max(1, (self._base().capacity - 1).bit_length())

    def _reorder_perm(self, order: str, start: int):
        """(perm, inv) int32 tensors on the device of the BFS relabel from
        base id ``start`` (the JAX ``reorder``'s shared prologue), or None
        when there is nothing to relabel. The window of
        ``HNSW_TPU_REORDER_SHUFFLE`` (0: none) shuffles ranks as in the
        JAX package, so both give the same permutation."""
        if order != "bfs":
            raise ValueError(f"unknown reorder {order!r}; known: bfs")
        if self.ep is None or self.n <= 1:
            return None
        if self.fused is not None or self.mini is not None:
            raise ValueError(
                "reorder before enable_inline(): the fused/mini tables "
                "embed node ids and are materialized from the reordered "
                "arrays"
            )
        g = self._base()
        o = bfs_order(g.adj[: self.n].cpu().numpy(), self.n, start)
        o = window_shuffle(o, int(os.environ.get("HNSW_TPU_REORDER_SHUFFLE",
                                                 0)))
        perm, inv = full_permutation(o, g.capacity)
        return (torch.from_numpy(perm).to(self.device),
                torch.from_numpy(inv).to(self.device))

    def _relabel_base(self, perm: torch.Tensor, inv: torch.Tensor):
        """Permute points and the base graph; ``id_map`` composes (the
        existing new -> original map, permuted). Returns the new base
        graph for the subclass to hold."""
        g = self._base()
        self.points, adj, deg = permute_base(self.points, g.adj, g.deg,
                                             perm, inv)
        self.id_map = perm if self.id_map is None else self.id_map[perm.long()]
        return GraphArrays(adj, deg)

    def enable_inline(self) -> None:
        """Materialize one base-layer query table, once: the fused table
        when its kernel can serve this index (``_fused_query_eligible``),
        else the mini table of the widest prefix that fits the card's free
        memory less a margin (``_mini_config_for``), built from the first
        ``W`` edges of each row. Where neither serves and the JAX package
        would materialize inline base rows (``_inline_query_fits``), that
        fact is recorded (``inline_rows``): the general route then runs
        ``dedup="beam"``, the one effect of those rows on results, without
        building them. The JAX level inline rows change no descent entry
        and are not ported."""
        if self.fused is not None or self.mini is not None \
                or self.inline_rows:
            return
        adj = self._base().adj
        if _fused_query_eligible(self.points, adj, self.metric):
            self.fused = materialize_fused(self.points, adj)
            return
        W, mw = _mini_config_for(self.points, adj, self.metric)
        if mw > 0:
            self.mini = materialize_mini(self.points, adj[:, :W],
                                         mini_words=mw)
            self.mini_words, self.mini_W = mw, W
            return
        self.inline_rows = _inline_query_fits(self.points, adj)

    def search(self, query, k: int, ef: int) -> KnnResult:
        """k nearest neighbors of one query (a [words] row)."""
        return search_one(self, query, k, ef)

    def route(self, k: int, ef: int) -> str:
        """The base-layer route of ``knns(.., k, ef)``: "fused", "mini" or
        "general" (the JAX ``knns`` choice)."""
        table_ok = max(ef, k) <= MAX_EF and self.query_expand == 1
        if self.fused is not None and table_ok:
            return "fused"
        if self.mini is not None and table_ok:
            return "mini"
        return "general"

    def knns(self, queries, k: int, ef: int) -> KnnResult:
        """k nearest neighbors of every query: ``_step`` on each query
        batch, on the route ``route`` picks. The profiler range "knns"
        (``utils/instrument.py``) spans the call."""
        if self.ep is None:
            raise ValueError("empty index")
        with host_range("knns"):
            qs = as_points(queries, self.device)
            nq = qs.shape[0]
            route = self.route(k, ef)
            out = [self._step(qs[s : s + self.query_batch], k, ef, route)
                   for s in range(0, nq, self.query_batch)]
            d, i, vis, st = (xs[0] if len(xs) == 1 else torch.cat(xs)
                             for xs in zip(*out))
            self.last_stats = LazyStats(vis, st, nq)
            self.last_route = route
            return KnnResult(d, self._original_ids(i))

    def _step(self, q: torch.Tensor, k: int, ef: int, route: str):
        """One query batch on ``route`` (``route()``'s pick): the replay of
        its CUDA graph where ``_graph_key`` gives a key
        (``step_graphs.py``: captured on the key's second batch), else
        ``_step_eager``. Returns (dists, ids [B, k] in this index's ids,
        visited, steps int32[B])."""
        return self._graphs.run(self._graph_key(q, k, ef, route), q,
                                lambda x: self._step_eager(x, k, ef, route))

    def _graph_key(self, q: torch.Tensor, k: int, ef: int, route: str):
        """The key of this batch's step graph: everything a table route's
        step bakes into its launches (the route, the batch's shape, k, ef,
        the steps cap, the entry settings, the tie bits, ``n``, and where
        each tensor it reads lies and its shape: the points, the fused
        table or the mini table and the base graph). None where the step
        runs eager: the general route (its host waits cannot be
        captured), CPU tensors, ``timings`` on (its event pairs need the
        eager ops), the walk entry (it reads ``ep`` and the levels, and
        the descent's general search waits on the host) and an empty
        batch."""
        if route == "general" or q.device.type != "cuda" \
                or self.timings is not None \
                or self.query_entry_sample <= 0 or q.shape[0] == 0:
            return None
        tensors = (self.points, *self.fused) if route == "fused" \
            else (self.points, self.mini, self._base().adj)
        return (route, q.device, q.dtype, tuple(q.shape), k, ef,
                self._steps_cap(ef), self.query_entry_sample,
                self.query_entry_beams, self.query_hop, self._tie_bits(),
                self.n, *((t.data_ptr(), tuple(t.shape)) for t in tensors))

    def _step_eager(self, q: torch.Tensor, k: int, ef: int, route: str):
        """``_step`` op by op: the entries (span "knns.entry": the sampled
        entry, on the mini route its top ``query_entry_beams``, or
        ``_walk_entries``), then the base search at beam width max(ef, k)
        and at most ``_steps_cap(ef)`` steps."""
        steps, sample = self._steps_cap(ef), self.query_entry_sample
        beams = self.query_entry_beams if route == "mini" else 1
        with span(self.timings, "knns.entry", self.device):
            if sample <= 0:
                eps = self._walk_entries(q, steps)
            elif beams > 1:
                eps = sampled_entry_topk(self.points, q, self.n, beams=beams,
                                         sample_size=sample,
                                         metric=self.metric)[0]
            else:
                eps = sampled_entry(self.points, q, self.n,
                                    sample_size=sample, metric=self.metric)
        if route == "fused":
            return _query_step_fused(self.points, self.fused, q, eps, k=k,
                                     ef=ef, max_steps=steps)
        if route == "mini":
            return _query_step_mini(
                self.points, self.mini, q, eps, k=k, ef=ef, max_steps=steps,
                adj=self._base().adj, hop=self.query_hop,
                tie_bits=self._tie_bits(), timings=self.timings)
        return self._query_step_general(q, eps, k=k, ef=ef, max_steps=steps)

    def _original_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """``ids`` as the dataset's: through ``id_map`` (moved to the ids'
        device) on a reordered index, ``ID_INF`` kept."""
        if self.id_map is None:
            return ids
        id_map = self.id_map.to(ids.device)
        mapped = id_map[ids.clamp(0, id_map.shape[0] - 1).long()]
        return torch.where(ids == ID_INF, ids, mapped)

    def _query_step_general(self, q, eps, *, k: int, ef: int,
                            max_steps: int):
        """The base search of the JAX ``_query_step`` and
        ``_hnsw_query_step`` on the general beam search: (dists, ids
        int32[B, k], visited, steps int32[B])."""
        adj = self._base().adj
        res = batched_beam_search(
            lambda ids: self.points[ids], adj, q, eps, ef=max(ef, k),
            metric=self.metric, capacity=adj.shape[0],
            expand=self.query_expand, max_steps=max_steps,
            dedup="beam" if self.inline_rows else self.query_dedup,
            tie_bits=self._tie_bits())
        return res.dists[:, :k], res.ids[:, :k], res.visited, res.steps


class NSW(QueryIndex):
    """Immutable search-side index (the JAX ``NSW``). Its tensors live on
    ``device``. Queries enter at ``ep``, or at the sampled entry when
    ``query_entry_sample`` > 0."""

    def __init__(self, points, n, graph: GraphArrays, ep, metric, opts=None,
                 *, device):
        self.device = torch.device(device)
        self.points = points.to(self.device)
        self.n = int(n)
        self.graph = GraphArrays(graph.adj.to(self.device),
                                 graph.deg.to(self.device))
        self.ep = int(ep) if ep is not None else None
        self.metric = get_metric(metric) if isinstance(metric, str) else metric
        self.opts = opts or IndexOptions()
        self._init_query_state()

    def _base(self) -> GraphArrays:
        return self.graph

    def _walk_entries(self, q: torch.Tensor, max_steps: int):
        return torch.full((q.shape[0],), self.ep, dtype=torch.int32,
                          device=q.device)

    def reorder(self, order: str = "bfs") -> None:
        """Relabel the nodes in BFS order from the entry point
        (``ops/reorder.py``); results keep original ids through
        ``id_map``. Call before ``enable_inline()``."""
        pi = self._reorder_perm(order, self.ep)
        if pi is not None:
            self._apply_perm(*pi)

    def _apply_perm(self, perm: torch.Tensor, inv: torch.Tensor) -> None:
        self.graph = self._relabel_base(perm, inv)
        self.ep = int(inv[self.ep])


class NSWBuilder:
    """Builds an NSW index as the JAX ``NSWBuilder`` does on its gather
    route: the native host engine for the first ``host_warmup`` points,
    then progressive device chunks. The same options and points give the
    same graph, entry point and edge drops in both packages. The
    builder's tensors, and the finished index's, live on ``device``."""

    def __init__(self, options: IndexOptions | None = None, metric="hamming",
                 *, device):
        self.opts = options or IndexOptions()
        if self.opts.size <= 0:
            raise ValueError("IndexOptions.size must be set (preallocation)")
        self.metric = get_metric(metric) if isinstance(metric, str) else metric
        self.device = torch.device(device)
        self.n = 0
        self.ep = None
        self.points = None  # [size, D] on device, first extend
        self._sealed = False  # set by a reorder build
        self.graph = make_graph(self.opts.size, self.opts.max_connections,
                                device=self.device)
        self.spill = _build.make_spill(self.opts.size, device=self.device)
        self.edge_drops = []  # per-chunk reverse-edge drop counts (tensors)
        self.timings = None  # dict: CUDA event pairs by phase (_build)

    def total_edge_drops(self) -> int:
        """Reverse edges lost to full rows across the whole build."""
        return int(sum(int(d) for d in self.edge_drops))

    def _grow_capacity(self, need: int) -> None:
        """Growth past ``size``: see ``_build.grow_base``."""
        grown = _build.grow_base(self.opts.size, need, self.graph,
                                 self.spill, self.points)
        if grown is not None:
            size, self.graph, self.spill, self.points = grown
            self.opts = dataclasses.replace(self.opts, size=size)

    def _check_unsealed(self) -> None:
        """A reorder build leaves these arrays in the new ids:
        further extends or builds would relabel again and corrupt
        ``id_map``."""
        if self._sealed:
            raise RuntimeError(
                "builder is sealed after a reorder build: further "
                "extend/build would compose relabels and corrupt the "
                "id_map; create a new builder (or set reorder=False and "
                "call index.reorder() yourself)"
            )

    def _ensure_points(self, sample: np.ndarray) -> None:
        self._check_unsealed()
        if self.points is None:
            self.points = torch.zeros(
                (self.opts.size, sample.shape[1]),
                dtype=torch.from_numpy(sample[:0]).dtype, device=self.device)

    def add(self, point) -> None:
        self.extend(_build.host_points(point)[None])

    def extend(self, points, sequential: bool = True) -> None:
        """Sequential inserts (chunks of one), or ``extend_batched``."""
        pts = _build.host_points(points)
        self._ensure_points(pts)
        if not sequential:
            self.extend_batched(pts)
            return
        for row in pts:
            self._insert_chunk(row[None])

    def extend_batched(self, points, progress=None) -> None:
        """Host-native sequential warmup of the first ``host_warmup``
        points, then progressive chunks on the device; a scanned group of
        G steady-state chunks runs as G chunk steps. ``progress`` is
        called with the running row count after the warmup and after
        every group. The whole call is the profiler range "extend"
        (``utils/instrument.py``)."""
        with host_range("extend"):
            self._extend_batched(points, progress)

    def _extend_batched(self, points, progress) -> None:
        pts = _build.host_points(points)
        self._ensure_points(pts)
        off = self._host_warmup(pts)
        if off and progress:
            progress(off)
        if self.ep is None and pts.shape[0] > off:
            self._insert_chunk(pts[off : off + 1])
            off += 1
        max_chunk = self.opts.batch_size * 16
        sched = _build.chunk_schedule(self.n, pts.shape[0] - off,
                                      max_chunk=max_chunk)
        i = 0
        while i < len(sched):
            G = _build.scan_group_at(
                sched, i, max_chunk, self.opts.scan_group,
                entry_ready=(self.opts.entry_sample > 0
                             and self.n > self.opts.entry_sample))
            for c in sched[i : i + G]:
                self._insert_chunk(pts[off : off + c])
                off += c
            i += G
            if progress:
                progress(off)

    def _host_warmup(self, pts: np.ndarray) -> int:
        """CPU-native sequential build of the first ``host_warmup`` points
        (the JAX ``NSWBuilder._host_warmup``: the same buffers and call),
        then its arrays go to the device. Returns the number of points
        inserted (0: not run)."""
        warm = min(self.opts.host_warmup, pts.shape[0])
        if (self.n > 0 or warm < 2
                or self.metric.name not in native.METRIC_CODE
                or not native.available()):
            return 0
        cap, W = self.opts.size, self.opts.max_connections
        pts_np = np.zeros((cap, pts.shape[1]), pts.dtype)
        pts_np[:warm] = pts[:warm]
        adj_np = np.full((cap, W), -1, np.int32)
        deg_np = np.zeros((cap,), np.int32)
        native.host_build(pts_np, self.metric.name, adj_np, deg_np, 1, warm,
                          m=self.opts.connections,
                          efc=self.opts.ef_construction, ep=0)
        dev = self.device
        self.points = as_points(pts_np, dev)
        self.graph = GraphArrays(to_device(torch.from_numpy(adj_np), dev),
                                 to_device(torch.from_numpy(deg_np), dev))
        self.ep = 0
        self.n = warm
        return warm

    def build(self) -> NSW:
        """The finished index on ``device``: leftover spill entries get up
        to four prune passes (those still left count as edge drops). With
        ``IndexOptions.reorder`` the index is relabeled in BFS order, the
        builder takes the relabeled arrays and is sealed. Call
        ``enable_inline()`` on the result before querying."""
        self._check_unsealed()
        if self.points is None:
            raise ValueError("empty index: call extend_batched first")
        _build.drain_spill(self.points, self.graph, self.spill, self.opts,
                           timings=self.timings, metric=self.metric)
        self.edge_drops.append((self.spill[:-1] >= 0).sum(dtype=torch.int32))
        nsw = NSW(self.points, self.n, self.graph, self.ep, self.metric,
                  self.opts, device=self.device)
        if self.opts.reorder:
            nsw.reorder()
            # the leftover spill ids are in the old numbering and already
            # counted as drops
            self.points, self.graph, self.ep = nsw.points, nsw.graph, nsw.ep
            self.spill.fill_(-1)
            self._sealed = True
        return nsw

    def _insert_chunk(self, chunk: np.ndarray) -> None:
        """Write and insert a contiguous chunk: the first point ever
        becomes the entry point; the rest enter at the sampled entry once
        there are more than ``entry_sample`` points, else at ``ep``."""
        c = chunk.shape[0]
        if self.n + c > self.opts.size:
            self._grow_capacity(self.n + c)
        if self.ep is None:
            _build.write_points(self.points, as_points(chunk[:1],
                                                       self.device), self.n)
            self.ep = self.n
            self.n += 1
            chunk, c = chunk[1:], c - 1
            if c == 0:
                return
        n0 = self.n
        q = as_points(chunk, self.device)
        _build.write_points(self.points, q, n0)
        # the JAX step's bucket padding shows only in the prune budget
        S = 1 if c == 1 else min(self.opts.batch_size,
                                 1 << (c - 1).bit_length())
        cp = -(-c // S) * S
        use_entry = self.opts.entry_sample > 0 and n0 > self.opts.entry_sample
        new_ids = torch.arange(n0, n0 + c, dtype=torch.int32,
                               device=self.device)
        eps = None if use_entry else torch.full_like(new_ids, self.ep)
        self.graph, self.spill, dropped = _build.chunk_step(
            self.points, None, self.graph, self.spill, q, new_ids, n0, eps,
            efc=self.opts.ef_construction, m=self.opts.connections,
            expand=self.opts.expand,
            prune_budget=min(self.opts.size, max(self.opts.prune_budget, cp)),
            entry_sample=self.opts.entry_sample, use_entry=use_entry,
            timings=self.timings, metric=self.metric)
        self.n += c
        self.edge_drops.append(dropped)
