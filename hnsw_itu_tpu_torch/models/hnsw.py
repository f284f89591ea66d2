"""HNSW — hierarchical navigable small world index (port of
hnsw_itu_tpu/models/hnsw.py: the index's query side and the builder).

Each level holds three tensors, as in the JAX package:

    node_ids: int32[cap_l]  local slot -> base point row
    down:     int32[cap_l]  local slot -> slot in the level below
    graph:    GraphArrays   adjacency over local slots

``HNSWBuilder`` builds as the JAX builder does: the native host engine
inserts the first ``host_warmup`` points sequentially with the full
hierarchy, then the batched device build inserts the rest in progressive
chunks (``models/_build.py``): per-point level draws, per-level groups,
the ef=1 descent and the level inserts, and the base-layer chunk steps,
with the gather beam-search kernel and the dense Hamming kernel on the
card, or the general beam search where the kernel cannot take the shape
(rows wider than 128, ``ef_construction`` above 128, ``expand`` > 1).

``HNSW`` serves queries on the device as the JAX ``HNSW.knns`` does: an
entry per query (the sampled entry when ``query_entry_sample`` > 0, else
the greedy ef=1 descent through the levels, ``descent_eps``), then one
base-layer search on the first route that serves the call:

* the fused kernel, where ``enable_inline`` built the fused table, with
  ``max(ef, k) <= 128`` and ``query_expand == 1``;
* the mini-table kernel and an exact rerank, under the same conditions
  (past 2^21 points, or where the fused table does not fit the card);
* the general beam search (``ops/search.py``) at ``ef = max(ef, k)``: the
  JAX ``_hnsw_query_step``, for every other call (wide rows, ef > 128,
  ``query_expand`` > 1, no table).

The descent runs kernel #6 at ef=1 on each level whose rows it can read
(Hamming only), else the general ``greedy_search``; both give the JAX
``_descent_eps`` entries. Indexes of other metrics (``l2int``, ``l2``, a
registered one) get no table and serve on the general route.

``reorder`` relabels the base layer in BFS order (``ops/reorder.py``);
levels keep their local numbering. With ``IndexOptions.reorder`` the
builder does it in ``build()`` and is then sealed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..graph import GraphArrays, make_graph
from ..ops.metrics import as_points, get_metric
from ..ops.search import greedy_search
from ..utils.instrument import host_range, to_device
from . import _build
from .base import IndexOptions, rng_seed
from .nsw import NSWBuilder, QueryIndex


class Level(NamedTuple):
    node_ids: torch.Tensor  # int32[cap_l]
    down: torch.Tensor  # int32[cap_l]
    graph: GraphArrays


def _make_level(cap: int, width: int, device) -> Level:
    return Level(
        node_ids=torch.zeros(cap, dtype=torch.int32, device=device),
        down=torch.zeros(cap, dtype=torch.int32, device=device),
        graph=make_graph(cap, width, device=device),
    )


def descent_eps(points, levels, qs, ep: int, *, metric,
                max_steps: int) -> torch.Tensor:
    """Base-layer entries int32[B]: the greedy ef=1 descent from ``ep``
    through ``levels`` (top to bottom), following ``down`` (the JAX
    ``_descent_eps`` without its sampled entry). On each level kernel #6
    runs at ef=1 with the level's node map where it reads the level's
    rows (``_build.search_route``), else ``greedy_search``. With one slot
    the beam's key only falls, so a node it left never comes back: the
    kernel's beam dedup, the JAX bitmask mode and its level-inline (beam)
    mode all walk the same nodes and give the same entries."""
    eps = torch.full((qs.shape[0],), int(ep), dtype=torch.int32,
                     device=qs.device)
    for lv in reversed(levels):
        adj, node_ids = lv.graph.adj, lv.node_ids
        cap_l = adj.shape[0]
        if _build.search_route(adj, points, 1, metric=metric) == "kernel":
            best = _build.build_search(points, node_ids, adj, qs, eps, ef=1,
                                       max_steps=max_steps,
                                       metric=metric)[1][:, 0]
        else:
            _, best = greedy_search(
                lambda ids, ni=node_ids: points[ni[ids].long()], adj, qs,
                eps, metric=metric, capacity=cap_l, max_steps=max_steps)
        eps = lv.down[best.long().clamp(0, cap_l - 1)]
    return eps


class HNSW(QueryIndex):
    """Immutable search-side index. Its tensors live on ``device``.
    Without a sampled entry, queries enter through the greedy descent
    (``descent_eps``)."""

    def __init__(self, points, n, base: GraphArrays, levels, level_ns, ep,
                 metric, opts=None, *, device):
        self.device = torch.device(device)
        self.points = points.to(self.device)
        self.n = int(n)
        self.base = GraphArrays(base.adj.to(self.device),
                                base.deg.to(self.device))
        self.levels = [
            Level(lv.node_ids.to(self.device), lv.down.to(self.device),
                  GraphArrays(lv.graph.adj.to(self.device),
                              lv.graph.deg.to(self.device)))
            for lv in levels
        ]
        self.level_ns = list(level_ns)
        self.ep = int(ep) if ep is not None else None
        self.metric = get_metric(metric) if isinstance(metric, str) else metric
        self.opts = opts or IndexOptions()
        self._init_query_state()

    def _base(self) -> GraphArrays:
        return self.base

    def _walk_entries(self, q: torch.Tensor, max_steps: int):
        return descent_eps(self.points, self.levels, q, self.ep,
                           metric=self.metric, max_steps=max_steps)

    def base_ep(self) -> int:
        """Follow the down-pointer chain from the top-level entry point to
        its base id."""
        e = self.ep
        for lv in reversed(self.levels):
            e = int(lv.down[e])
        return e

    def reorder(self, order: str = "bfs") -> None:
        """Relabel the base layer in BFS order from ``base_ep()``
        (``ops/reorder.py``); results keep original ids through
        ``id_map``. Levels keep their local numbering: only ``node_ids``
        on every level and ``down`` on the bottom level point into the
        base and are remapped (slots past a level's count hold -1 or 0,
        clamped as in JAX). With no levels ``ep`` is a base id and moves
        too. Call before ``enable_inline()``."""
        start = self.base_ep() if self.ep is not None else 0
        pi = self._reorder_perm(order, start)
        if pi is None:
            return
        perm, inv = pi
        cap = self.base.capacity
        self.base = self._relabel_base(perm, inv)
        self.levels = [
            Level(inv[lv.node_ids.long().clamp(0, cap - 1)],
                  inv[lv.down.long().clamp(0, cap - 1)] if li == 0
                  else lv.down, lv.graph)
            for li, lv in enumerate(self.levels)]
        if not self.levels:
            self.ep = int(inv[self.ep])


class HNSWBuilder:
    """Builds an HNSW index as the JAX ``HNSWBuilder`` does: the native
    host engine for the first ``host_warmup`` points (the whole build when
    ``host_warmup >= size``, the JAX ``--single-threaded`` route), then the
    batched device build for the rest. The same options and points give
    the same graph, levels, entry point and edge drops in both packages
    (the JAX builder on its gather route; see ``models/_build.py``). The
    builder's tensors, and the finished index's, live on ``device``."""

    MAX_HOST_LEVELS = 16  # geometric draw: P(level >= 16) ~ m^-16

    def __init__(self, options: IndexOptions | None = None, metric="hamming",
                 *, device):
        self.opts = options or IndexOptions()
        if self.opts.size <= 0:
            raise ValueError("IndexOptions.size must be set (preallocation)")
        self.metric = get_metric(metric) if isinstance(metric, str) else metric
        self.device = torch.device(device)
        self.n = 0
        self.ep = None  # local slot in the top level (base id if no levels)
        self.points = None  # [size, D] on device, first extend
        self._sealed = False  # set by a reorder build
        self.base = make_graph(self.opts.size, self.opts.max_connections,
                               device=self.device)
        self.levels: list[Level] = []
        self.level_ns: list[int] = []
        self.spill = _build.make_spill(self.opts.size, device=self.device)
        self.edge_drops = []  # per-step reverse-edge drop counts (tensors)
        self.timings = None  # dict: CUDA event pairs by phase (_build)
        # deterministic level RNG (hnsw.rs:24-30)
        self._rng = np.random.RandomState(rng_seed(self.opts))
        self._ml = 1.0 / math.log(max(2, self.opts.connections))

    def total_edge_drops(self) -> int:
        """Reverse edges lost to full rows across the whole build
        (unrecoverable by the prune pass; see _build.apply_inserts)."""
        return int(sum(int(d) for d in self.edge_drops))

    # -- level machinery ------------------------------------------------------
    def _random_level(self) -> int:
        # floor(-ln(U) * 1/ln(m)) — hnsw.rs:37-40
        u = max(self._rng.random_sample(), 1e-12)
        return int(-math.log(u) * self._ml)

    def _level_capacity(self, l: int) -> int:
        """Initial level-l capacity: 2x the expected occupancy, pow2."""
        m = max(2, self.opts.connections)
        expect = self.opts.size * (m ** -(l + 1))
        cap = max(64, int(2 * expect))
        return 1 << (cap - 1).bit_length()

    def _grow_level(self, l: int, need: int) -> None:
        lv = self.levels[l]
        cap = lv.graph.capacity
        if need <= cap:
            return
        new_cap = max(need, 2 * cap)
        new_cap = 1 << (new_cap - 1).bit_length()
        ext = _make_level(new_cap - cap, lv.graph.width, self.device)
        self.levels[l] = Level(
            torch.cat([lv.node_ids, ext.node_ids]),
            torch.cat([lv.down, ext.down]),
            GraphArrays(torch.cat([lv.graph.adj, ext.graph.adj]),
                        torch.cat([lv.graph.deg, ext.graph.deg])),
        )

    def _grow_capacity(self, need: int) -> None:
        """Base-layer growth past ``size``: see ``_build.grow_base``."""
        grown = _build.grow_base(self.opts.size, need, self.base,
                                 self.spill, self.points)
        if grown is not None:
            size, self.base, self.spill, self.points = grown
            self.opts = dataclasses.replace(self.opts, size=size)

    # -- builder API ----------------------------------------------------------
    _check_unsealed = NSWBuilder._check_unsealed
    _ensure_points = NSWBuilder._ensure_points

    def _write(self, chunk: np.ndarray) -> None:
        _build.write_points(self.points, as_points(chunk, self.device),
                            self.n)
        self.n += chunk.shape[0]

    def add(self, point) -> None:
        self.extend(_build.host_points(point)[None])

    def extend(self, points) -> None:
        """Sequential inserts: chunks of one, per-point level draw."""
        pts = _build.host_points(points)
        self._ensure_points(pts)
        for row in pts:
            self._insert_chunk(row[None])

    def extend_batched(self, points, progress=None) -> None:
        """Host-native sequential warmup of the first ``host_warmup``
        points, then progressive chunks on the device. Levels are drawn
        per point and each chunk is inserted in per-level groups, highest
        first. With ``scan_group = G > 1``, steady-state chunks go in
        groups of G: the upper-level groups span the whole G-chunk window,
        and the base inserts are deferred and run in id order as G chunk
        steps (the JAX scanned dispatch, as a loop). ``progress`` is called
        with the running row count after the warmup and after every
        group. The whole call is the profiler range "extend"
        (``utils/instrument.py``)."""
        with host_range("extend"):
            self._extend_batched(points, progress)

    def _extend_batched(self, points, progress) -> None:
        pts = _build.host_points(points)
        self._ensure_points(pts)
        off = self._host_warmup(pts)
        if off and progress:
            progress(off)
        if self.ep is None and pts.shape[0] > 0:
            self._insert_chunk(pts[:1])
            off = 1
        max_chunk = self.opts.batch_size * 16
        sched = _build.chunk_schedule(self.n, pts.shape[0] - off,
                                      max_chunk=max_chunk)
        i = 0
        while i < len(sched):
            c = sched[i]
            G = _build.scan_group_at(
                sched, i, max_chunk, self.opts.scan_group,
                entry_ready=(self.opts.entry_sample > 0
                             and self.n > self.opts.entry_sample))
            chunk = pts[off : off + G * c]
            n0 = self.n
            if self.n + G * c > self.opts.size:
                self._grow_capacity(self.n + G * c)
            self._write(chunk)
            # one draw per point in id order: the same RNG stream whether
            # or not chunks are grouped
            levels = np.array([self._random_level() for _ in range(G * c)])
            deferred = []
            for lvl in sorted(set(levels.tolist()), reverse=True):
                if lvl == 0 and G > 1:
                    continue  # the grouped base path below
                ids = (n0 + np.nonzero(levels == lvl)[0]).astype(np.int32)
                d = self._insert_registered(ids, int(lvl), defer_base=G > 1)
                if d is not None:
                    deferred.append(d)
            if G > 1:
                ids0 = (n0 + np.nonzero(levels == 0)[0]).astype(np.int32)
                parts = [(ids0, torch.full((ids0.shape[0],), -1,
                                           dtype=torch.int32,
                                           device=self.device))] + deferred
                mids = np.concatenate([p[0] for p in parts])
                meps = torch.cat([p[1] for p in parts])
                order = np.argsort(mids, kind="stable")
                self._insert_base_grouped(
                    mids[order],
                    meps[to_device(torch.from_numpy(order), self.device)],
                    c)
            off += G * c
            i += G
            if progress:
                progress(off)

    def _host_warmup(self, pts: np.ndarray) -> int:
        """CPU-native sequential build of the first ``host_warmup`` points
        with the full hierarchy (the JAX ``HNSWBuilder._host_warmup``: the
        same draws, buffers and call), then its arrays go to the device.
        Returns the number of points inserted (0: not run)."""
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
        # point 0 is pinned at the (empty) top level and consumes no draw
        draws = np.zeros((warm,), np.int32)
        draws[1:] = [self._random_level() for _ in range(warm - 1)]
        ml = self.MAX_HOST_LEVELS
        caps = [self._level_capacity(l) for l in range(ml)]
        total = sum(caps)
        lvl_node_ids = np.zeros((total,), np.int32)
        lvl_down = np.zeros((total,), np.int32)
        lvl_adj = np.full((total, W), -1, np.int32)
        lvl_deg = np.zeros((total,), np.int32)
        level_ns = np.zeros((ml,), np.int64)
        _, ep = native.host_build_hnsw(
            pts_np, self.metric.name, adj_np, deg_np, 1, warm,
            m=self.opts.connections, efc=self.opts.ef_construction,
            draws=draws, level_caps=caps, lvl_node_ids=lvl_node_ids,
            lvl_down=lvl_down, lvl_adj=lvl_adj, lvl_deg=lvl_deg,
            level_ns=level_ns, ep=0,
        )
        dev = self.device
        self.points = as_points(pts_np, dev)
        self.base = GraphArrays(to_device(torch.from_numpy(adj_np), dev),
                                to_device(torch.from_numpy(deg_np), dev))
        off = 0
        for l in range(ml):
            if level_ns[l] <= 0:
                break
            sl = slice(off, off + caps[l])
            t = [to_device(torch.from_numpy(a[sl]), dev)
                 for a in (lvl_node_ids, lvl_down, lvl_adj, lvl_deg)]
            self.levels.append(Level(t[0], t[1], GraphArrays(t[2], t[3])))
            self.level_ns.append(int(level_ns[l]))
            off += caps[l]
        self.ep = int(ep)
        self.n = warm
        return warm

    def build(self) -> HNSW:
        """The finished index on ``device``: leftover spill entries get up
        to four prune passes (those still left count as edge drops), and
        level arrays shrink from build capacity to a pow2 of their node
        count (floor 8), as in the JAX ``build()``. With
        ``IndexOptions.reorder`` the index is relabeled in BFS order, the
        builder takes the relabeled arrays and is sealed. Call
        ``enable_inline()`` on the result before querying."""
        self._check_unsealed()
        if self.points is None:
            raise ValueError("empty index: call extend_batched first")
        _build.drain_spill(self.points, self.base, self.spill, self.opts,
                           timings=self.timings, metric=self.metric)
        self.edge_drops.append((self.spill[:-1] >= 0).sum(dtype=torch.int32))
        levels = []
        for lv, nl in zip(self.levels, self.level_ns):
            m = max(8, 1 << max(0, (nl - 1).bit_length()))
            levels.append(Level(lv.node_ids[:m], lv.down[:m],
                                GraphArrays(lv.graph.adj[:m],
                                            lv.graph.deg[:m])))
        h = HNSW(self.points, self.n, self.base, levels, self.level_ns,
                 self.ep, self.metric, self.opts, device=self.device)
        if self.opts.reorder:
            h.reorder()
            # the leftover spill ids are in the old numbering and already
            # counted as drops; the trimmed levels leave no room to grow
            self.points, self.base, self.levels = h.points, h.base, h.levels
            self.ep = h.ep
            self.spill.fill_(-1)
            self._sealed = True
        return h

    # -- the chunk insert -----------------------------------------------------
    def _insert_chunk(self, chunk: np.ndarray, level: int | None = None):
        """Write + insert a contiguous chunk (the sequential path: chunks
        of one, per-point level draw)."""
        c = chunk.shape[0]
        if self.n + c > self.opts.size:
            self._grow_capacity(self.n + c)
        first = self.ep is None
        n0 = self.n
        self._write(chunk)
        base_ids = (n0 + np.arange(c)).astype(np.int32)
        if first:
            # the first point is the entry point, pinned at the top level
            self.ep = int(base_ids[0])
            base_ids = base_ids[1:]
            if base_ids.shape[0] == 0:
                return
        if level is None:
            level = self._random_level()
        self._insert_registered(base_ids, level)

    def _insert_registered(self, base_ids: np.ndarray, level: int,
                           defer_base: bool = False):
        """Insert already-written points (ids = their base rows) at
        ``level``. With ``defer_base`` the base-layer insert is not run;
        (base_ids, entries) are returned for the grouped base steps.

        The JAX builder pads every group to a bucket of ``cpad`` rows
        (pow2, floor 256; 8 for one point) with id -1. The padding is kept
        where it shows: level registration writes ``cpad`` slots (the
        padding's slots hold node id -1 past ``level_ns`` until the next
        group overwrites them), levels grow for ``cpad`` rows, and prune
        budgets scale with ``cpad``. Searches run on the real rows only."""
        c = base_ids.shape[0]
        if c == 0:
            return None
        cpad = max(256, 1 << (c - 1).bit_length()) if c > 1 else 8
        ids_pad = np.concatenate([base_ids, np.full(cpad - c, -1, np.int32)])
        # this chunk's descent and inserts start from the OLD entry point
        # and layers
        L_old = len(self.levels)
        ep_old = self.ep
        new_ep = False
        while len(self.levels) < level:
            l = len(self.levels)
            self.levels.append(_make_level(self._level_capacity(l),
                                           self.opts.max_connections,
                                           self.device))
            self.level_ns.append(0)
            new_ep = True
        dev = self.device
        slots = []  # padded local slots per occupied level
        for l in range(level):
            nl = self.level_ns[l]
            self._grow_level(l, nl + cpad)
            lv = self.levels[l]
            loc = nl + np.arange(cpad, dtype=np.int32)
            below = ids_pad if l == 0 else slots[l - 1]
            lv.node_ids[nl : nl + cpad] = to_device(
                torch.from_numpy(ids_pad), dev)
            lv.down[nl : nl + cpad] = to_device(torch.from_numpy(below), dev)
            self.level_ns[l] = nl + c
            slots.append(loc)
        if new_ep:
            self.ep = int(slots[-1][0])

        ids_t = to_device(torch.from_numpy(base_ids), dev)
        q = self.points[ids_t.long()]
        n0 = int(base_ids[0])
        # level-0 points take the sampled entry and skip the descent
        if (level == 0 and self.opts.entry_sample > 0
                and n0 > self.opts.entry_sample):
            self._insert_graph(ids_t, q, None, cpad, n0)
            return None
        eps = torch.full((c,), ep_old, dtype=torch.int32, device=dev)
        for l in range(L_old - 1, level - 1, -1):
            lv = self.levels[l]
            eps = _build.level_descend_step(
                self.points, lv.node_ids, lv.graph.adj, lv.down, q, eps,
                timings=self.timings, metric=self.metric)
        # insert top-down; a brand-new layer holds only this group: enter
        # at its first slot and leave the old layers' entry chain alone
        for l in range(level - 1, -1, -1):
            loc = to_device(torch.from_numpy(slots[l][:c]), dev)
            if l >= L_old:
                self._insert_level(l, q, loc,
                                   torch.full_like(loc, int(slots[l][0])),
                                   cpad)
            else:
                eps = self._insert_level(l, q, loc, eps, cpad)
        if defer_base:
            return base_ids, eps
        self._insert_graph(ids_t, q, eps, cpad, n0)
        return None

    def _insert_level(self, l: int, q, loc, eps, cpad: int):
        lv = self.levels[l]
        g, next_eps, dropped = _build.level_chunk_step(
            self.points, lv.node_ids, lv.graph, lv.down, q, loc, eps,
            efc=self.opts.ef_construction, m=self.opts.connections,
            expand=self.opts.expand,
            prune_budget=min(lv.graph.capacity,
                             max(self.opts.prune_budget, cpad)),
            timings=self.timings, metric=self.metric)
        self.edge_drops.append(dropped)
        self.levels[l] = Level(lv.node_ids, lv.down, g)
        return next_eps

    def _insert_graph(self, ids_t, q, eps, cpad: int, n0: int) -> None:
        """One base-layer chunk step; ``eps`` None: the sampled entry over
        the rows before ``n0``, the group's first id."""
        self.base, self.spill, dropped = _build.chunk_step(
            self.points, None, self.base, self.spill, q, ids_t, n0, eps,
            efc=self.opts.ef_construction, m=self.opts.connections,
            expand=self.opts.expand, prune_budget=min(self.opts.size,
                             max(self.opts.prune_budget, cpad)),
            entry_sample=self.opts.entry_sample, use_entry=eps is None,
            timings=self.timings, metric=self.metric)
        self.edge_drops.append(dropped)

    def _insert_base_grouped(self, base_ids: np.ndarray, eps, c: int):
        """A group's base inserts in id order, as consecutive chunk steps
        of ``c`` rows: rows whose entry is >= 0 keep their descent entry,
        the rest take the sampled entry, whose population bound is the
        group's start for every step (as in the JAX scanned dispatch)."""
        n_all = base_ids.shape[0]
        if n_all % c != 0:
            raise AssertionError(f"grouped base insert expects whole chunks: "
                                 f"{n_all} rows vs chunk size {c}")
        n0 = int(base_ids[0])
        ids_t = to_device(torch.from_numpy(base_ids), self.device)
        for s in range(0, n_all, c):
            ids = ids_t[s : s + c]
            self.base, self.spill, dropped = _build.chunk_step(
                self.points, None, self.base, self.spill,
                self.points[ids.long()], ids, n0, eps[s : s + c],
                efc=self.opts.ef_construction, m=self.opts.connections,
                expand=self.opts.expand,
                prune_budget=min(self.opts.size,
                                 max(self.opts.prune_budget, c)),
                entry_sample=self.opts.entry_sample, use_entry=True,
                timings=self.timings, metric=self.metric)
            self.edge_drops.append(dropped)
