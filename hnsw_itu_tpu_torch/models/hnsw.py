"""HNSW — hierarchical navigable small world index (port of
hnsw_itu_tpu/models/hnsw.py, query side and host build).

Each level holds three tensors, as in the JAX package:

    node_ids: int32[cap_l]  local slot -> base point row
    down:     int32[cap_l]  local slot -> slot in the level below
    graph:    GraphArrays   adjacency over local slots

The port builds the whole hierarchy on the host with the native engine
(the JAX package's ``host_warmup = size`` route, ``--single-threaded``) and
serves queries on the device: a sampled entry, then one beam-search
kernel over the base layer: the fused kernel where the fused table can
serve the index, else the mini-table kernel with an exact rerank (past
2^21 points, or where the fused table does not fit the card). Paths not
ported yet raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..graph import GraphArrays
from ..ops.entry import sampled_entry, sampled_entry_topk
from ..ops.fused_search import MAX_EF, materialize_fused
from ..ops.metrics import as_sketches, get_metric
from ..ops.mini_search import materialize_mini
from .base import ID_INF, IndexOptions, KnnResult, LazyStats, rng_seed
from .nsw import (_fused_query_eligible, _mini_config_for, _query_step_fused,
                  _query_step_mini)


class Level(NamedTuple):
    node_ids: torch.Tensor  # int32[cap_l]
    down: torch.Tensor  # int32[cap_l]
    graph: GraphArrays


class HNSW:
    """Immutable search-side index. Its tensors live on ``device``."""

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
        self.query_batch = 1024
        self.query_entry_sample = 0  # >0: sampled entry (ops/entry.py)
        self.query_entry_beams = 1  # >1: seed with the sample's top-B (mini)
        self.query_hop = 0  # >0: one-hop exact rerank seeds (mini path)
        self.query_tie = "auto"  # mini-path tie order: auto, id or bitrev
        self.max_steps = None  # None = auto (2*ef, floor 64)
        self.last_stats = None
        self.fused = None  # fused query table (ops/fused_search.py)
        self.mini = None  # mini query table (ops/mini_search.py)
        self.mini_words = 0
        self.mini_W = 0
        self.id_map = None  # int32[cap] new->original id (set by reorder)

    def size(self) -> int:
        return self.n

    def _steps_cap(self, ef: int) -> int:
        return self.max_steps if self.max_steps else max(2 * ef, 64)

    def _tie_bits(self) -> int:
        """Bits of the mini path's bit-reversed tie order: 0 (ties by id)
        for "id", and for "auto" on an index that was not reordered."""
        tie = self.query_tie
        if tie == "id" or (tie == "auto" and self.id_map is None):
            return 0
        if tie not in ("auto", "bitrev"):
            raise ValueError(f"unknown query_tie {tie!r}")
        return max(1, (self.base.capacity - 1).bit_length())

    def enable_inline(self) -> None:
        """Materialize one base-layer query table, once: the fused table
        when its kernel can serve this index (models/nsw.py
        ``_fused_query_eligible``), else the mini table of the widest
        prefix that fits the card's free memory less a margin
        (``_mini_config_for``), built from the first ``W`` edges of each
        row. The JAX package's level inline rows serve only the greedy
        descent, which is not ported yet."""
        if self.fused is not None or self.mini is not None:
            return
        if _fused_query_eligible(self.points, self.base.adj, self.metric):
            self.fused = materialize_fused(self.points, self.base.adj)
            return
        W, mw = _mini_config_for(self.points, self.base.adj, self.metric)
        if mw > 0:
            self.mini = materialize_mini(self.points, self.base.adj[:, :W],
                                         mini_words=mw)
            self.mini_words, self.mini_W = mw, W

    def _mini_entry(self, q: torch.Tensor) -> torch.Tensor:
        """Seed ids of the mini path: the sampled entry, or its top
        ``query_entry_beams`` when that is above 1 ([B] or [B, E])."""
        kw = dict(sample_size=self.query_entry_sample, metric=self.metric)
        if self.query_entry_beams > 1:
            return sampled_entry_topk(self.points, q, self.n,
                                      beams=self.query_entry_beams, **kw)[0]
        return sampled_entry(self.points, q, self.n, **kw)

    def base_ep(self) -> int:
        """Follow the down-pointer chain from the top-level entry point to
        its base id."""
        e = self.ep
        for lv in reversed(self.levels):
            e = int(lv.down[e])
        return e

    def knns(self, queries, k: int, ef: int) -> KnnResult:
        """k nearest neighbors of every query: sampled entry, then the
        base-layer beam search at beam width max(ef, k) on the fused
        table, or on the mini table followed by an exact rerank."""
        if self.ep is None:
            raise ValueError("empty index")
        if max(ef, k) > MAX_EF:
            raise NotImplementedError(
                f"ef > {MAX_EF}: the two-plane beam search is not ported "
                "yet (ROADMAP §1, item 19)"
            )
        if self.query_entry_sample <= 0:
            raise NotImplementedError(
                "greedy descent through the levels (query_entry_sample=0) "
                "is not ported yet (ROADMAP §1, item 18); "
                "set query_entry_sample"
            )
        if self.fused is None and self.mini is None:
            raise NotImplementedError(
                "no fused or mini table: call enable_inline() first; "
                "indexes neither table can serve need the general beam "
                "search (ROADMAP §1, item 4)"
            )
        qs = as_sketches(queries, self.device)
        nq = qs.shape[0]
        B = self.query_batch
        out_d, out_i, out_v, out_s = [], [], [], []
        for s in range(0, nq, B):
            q = qs[s : s + B]
            if self.fused is not None:
                eps = sampled_entry(self.points, q, self.n,
                                    sample_size=self.query_entry_sample,
                                    metric=self.metric)
                d, i, vis, st = _query_step_fused(
                    self.points, self.fused, q, eps, k=k, ef=ef,
                    max_steps=self._steps_cap(ef),
                )
            else:
                d, i, vis, st = _query_step_mini(
                    self.points, self.mini, q, self._mini_entry(q), k=k,
                    ef=ef, max_steps=self._steps_cap(ef), adj=self.base.adj,
                    hop=self.query_hop, tie_bits=self._tie_bits(),
                )
            out_d.append(d)
            out_i.append(i)
            out_v.append(vis)
            out_s.append(st)
        cat = (lambda xs: xs[0] if len(xs) == 1 else torch.cat(xs))
        self.last_stats = LazyStats(cat(out_v), cat(out_s), nq)
        ids = cat(out_i)
        if self.id_map is not None:  # reordered index: original ids out
            mapped = self.id_map[ids.clamp(0, self.id_map.shape[0] - 1).long()]
            ids = torch.where(ids == ID_INF, ids, mapped)
        return KnnResult(cat(out_d), ids)


class HNSWBuilder:
    """Builds an HNSW index with the native host engine, as the JAX
    ``HNSWBuilder`` does with ``host_warmup = size``: the same options give
    the same graph, levels and entry point in both packages. The finished
    index's tensors go to ``device``."""

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
        self.points = None  # numpy uint32[cap, words] until build()
        self.adj = self.deg = None
        self.levels_np: list[tuple[np.ndarray, ...]] = []
        self.level_ns: list[int] = []
        # deterministic level RNG (hnsw.rs:24-30)
        self._rng = np.random.RandomState(rng_seed(self.opts))
        self._ml = 1.0 / math.log(max(2, self.opts.connections))

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

    def extend_batched(self, points) -> None:
        """Insert ``points`` with the host engine. Only the whole build on
        the host is ported: fewer than all points in ``host_warmup``, or a
        second call, needs the batched device build."""
        pts = np.ascontiguousarray(points)
        if pts.dtype == np.int32:
            pts = pts.view(np.uint32)
        warm = min(self.opts.host_warmup, pts.shape[0])
        if self.n > 0 or warm < 2 or warm < pts.shape[0]:
            raise NotImplementedError("batched device build: slice 2, see ROADMAP")
        if pts.shape[0] > self.opts.size:
            raise ValueError(f"{pts.shape[0]} points > size {self.opts.size}")
        self._host_warmup(pts)

    def _host_warmup(self, pts: np.ndarray) -> None:
        """CPU-native sequential build with the full hierarchy (the JAX
        ``HNSWBuilder._host_warmup``: the same draws, buffers and call)."""
        warm = pts.shape[0]
        cap, W = self.opts.size, self.opts.max_connections
        pts_np = np.zeros((cap, *pts.shape[1:]), pts.dtype)
        pts_np[:warm] = pts
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
        self.points, self.adj, self.deg = pts_np, adj_np, deg_np
        off = 0
        for l in range(ml):
            if level_ns[l] <= 0:
                break
            sl = slice(off, off + caps[l])
            self.levels_np.append((lvl_node_ids[sl], lvl_down[sl],
                                   lvl_adj[sl], lvl_deg[sl]))
            self.level_ns.append(int(level_ns[l]))
            off += caps[l]
        self.ep = int(ep)
        self.n = warm

    def build(self) -> HNSW:
        """The finished index on ``device``. Level arrays shrink from build
        capacity to a pow2 of their node count (floor 8), as in the JAX
        ``build()``. Call ``enable_inline()`` on the result before
        querying."""
        if self.points is None:
            raise ValueError("empty index: call extend_batched first")
        levels = []
        for (node_ids, down, adj, deg), nl in zip(self.levels_np,
                                                  self.level_ns):
            m = max(8, 1 << max(0, (nl - 1).bit_length()))
            levels.append((node_ids[:m], down[:m], adj[:m], deg[:m]))
        from ..utils.serialize import from_numpy

        return from_numpy(self.points, self.adj, self.deg, levels,
                          self.level_ns, self.ep, self.n, self.opts,
                          self.device, metric=self.metric.name)
