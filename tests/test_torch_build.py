"""The port's batched build against the JAX package on CPU tensors,
bit-exact (tolerance 0): select-neighbors, the graph mutations, the spill
buffer, ``apply_inserts`` and ``chunk_step`` from a mid-build state carried
across with ``builder_from_numpy``, and whole ``HNSWBuilder`` builds
(``extend_batched`` with and without scanned groups, ``extend``).

The JAX builder runs on its gather route (``HNSW_TPU_INLINE_BUILD_BYTES=0``:
no inline build rows), the search the port's build always runs. Its default
route keeps inline rows that a prune leaves stale (ROADMAP §3); the last
test shows that divergence."""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_itu_tpu import graph as jgraph
from hnsw_itu_tpu.models import IndexOptions as JaxOptions
from hnsw_itu_tpu.models import _build as jbuild
from hnsw_itu_tpu.models.hnsw import HNSWBuilder as JaxBuilder
from hnsw_itu_tpu.models.nsw import _materialize_inline
from hnsw_itu_tpu.ops import HAMMING as JAX_HAMMING
from hnsw_itu_tpu.ops import L2 as JAX_L2
from hnsw_itu_tpu.ops.select import select_neighbors as jax_select
from hnsw_itu_tpu_torch import graph as pgraph
from hnsw_itu_tpu_torch.models import IndexOptions
from hnsw_itu_tpu_torch.models import _build as pbuild
from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
from hnsw_itu_tpu_torch.ops.metrics import HAMMING, L2, as_sketches
from hnsw_itu_tpu_torch.ops.select import select_neighbors
from hnsw_itu_tpu_torch.utils import builder_from_numpy, make_dataset
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

N, NQ, K, EF = 2400, 48, 10, 32
# batch_size 16: 256-row chunks from n = 1068 on, so scan_group 4 forms
# one whole group of four at N = 2400
OPTS = dict(ef_construction=48, connections=12, max_connections=24, size=N,
            batch_size=16, host_warmup=300, entry_sample=256)
MID = 1200  # rows of the mid-build state


@contextlib.contextmanager
def gather_route():
    """The JAX builder without inline build rows."""
    key = "HNSW_TPU_INLINE_BUILD_BYTES"
    old = os.environ.get(key)
    os.environ[key] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ[key]
        else:
            os.environ[key] = old


def _np(x):
    return np.asarray(x)


def _t(a):
    """numpy -> CPU int32 tensor (a copy, bit patterns kept)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def jax_state(b) -> dict:
    """A JAX builder's state as host arrays (``builder_from_numpy``'s
    input)."""
    return {
        "points": _np(b.points), "adj": _np(b.base.adj),
        "deg": _np(b.base.deg), "spill": _np(b.spill),
        "levels": [tuple(_np(x) for x in (lv.node_ids, lv.down, lv.graph.adj,
                                          lv.graph.deg)) for lv in b.levels],
        "level_ns": list(b.level_ns), "ep": b.ep, "n": b.n,
        "rng_state": b._rng.get_state(),
    }


def assert_same_builder(pb, jb, drops_before=0):
    """Port and JAX builders hold the same build; ``drops_before``: edge
    drops the JAX builder counted before the port's builder took over."""
    assert pb.n == jb.n and pb.ep == jb.ep and pb.level_ns == jb.level_ns
    np.testing.assert_array_equal(pb.base.adj.numpy(), _np(jb.base.adj))
    np.testing.assert_array_equal(pb.base.deg.numpy(), _np(jb.base.deg))
    np.testing.assert_array_equal(pb.spill[:-1].numpy(), _np(jb.spill)[:-1])
    assert len(pb.levels) == len(jb.levels)
    for lp, lj in zip(pb.levels, jb.levels):
        for p, j in ((lp.node_ids, lj.node_ids), (lp.down, lj.down),
                     (lp.graph.adj, lj.graph.adj),
                     (lp.graph.deg, lj.graph.deg)):
            np.testing.assert_array_equal(p.numpy(), _np(j))
    assert pb.total_edge_drops() == jb.total_edge_drops() - drops_before


@pytest.fixture(scope="module")
def data():
    return make_dataset(11, N, NQ)


# -- select-neighbors ---------------------------------------------------------

def test_select_neighbors_golden():
    """Query 10 over {1, 5, 6, 7, 16, 18}, m=3, squared L2: keeps exactly
    {7, 16} (tests/test_select.py::test_heuristic_golden)."""
    xs = np.array([1, 5, 6, 7, 16, 18], np.int64)
    d = torch.from_numpy((xs - 10) ** 2).int()[None]
    pair = torch.from_numpy((xs[:, None] - xs[None, :]) ** 2).int()[None]
    ids = torch.arange(6, dtype=torch.int32)[None]
    valid = torch.ones((1, 6), dtype=torch.bool)
    sel, _, n = select_neighbors(d, ids, pair, valid, 3)
    assert [int(xs[i]) for i in sel[0, : int(n[0])]] == [7, 16]


@pytest.mark.parametrize("C,m", [(40, 12), (96, 24), (9, 9)])
def test_select_neighbors_matches_jax(C, m):
    """Random lists with distance ties, id ties and invalid slots."""
    rng = np.random.default_rng(C + m)
    R = 64
    d = rng.integers(0, 8, size=(R, C)).astype(np.int32)
    ids = rng.integers(0, 3 * C, size=(R, C)).astype(np.int32)
    pair = rng.integers(0, 16, size=(R, C, C)).astype(np.int32)
    pair = np.minimum(pair, pair.transpose(0, 2, 1))
    valid = rng.random((R, C)) < 0.8
    want = jax.vmap(lambda *a: jax_select(*a, m))(
        jnp.asarray(d), jnp.asarray(ids), jnp.asarray(pair),
        jnp.asarray(valid))
    got = select_neighbors(_t(d), _t(ids), _t(pair), torch.from_numpy(valid),
                           m)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


# -- graph mutations ----------------------------------------------------------

def _random_graph(rng, cap, W, full_share=0.3):
    """A graph whose rows hold distinct ids, a share of them full."""
    adj = np.full((cap, W), -1, np.int32)
    deg = np.zeros(cap, np.int32)
    for i in range(cap):
        k = W if rng.random() < full_share else int(rng.integers(0, W))
        adj[i, :k] = rng.choice(cap, size=k, replace=False)
        deg[i] = k
    return adj, deg


def _port_graph(adj, deg):
    return pgraph.GraphArrays(_t(adj), _t(deg))


def test_set_rows_matches_jax():
    rng = np.random.default_rng(1)
    adj, deg = _random_graph(rng, 64, 8)
    ids = rng.permutation(64)[:20].astype(np.int32)
    ids[[3, 11]] = -1
    rows = rng.integers(0, 64, size=(20, 8)).astype(np.int32)
    rows[rows % 3 == 0] = -1
    want = jgraph.set_rows(jgraph.GraphArrays(jnp.asarray(adj),
                                              jnp.asarray(deg)),
                           jnp.asarray(ids), jnp.asarray(rows))
    got = pgraph.set_rows(_port_graph(adj, deg), _t(ids), _t(rows))
    np.testing.assert_array_equal(got.adj.numpy(), _np(want.adj))
    np.testing.assert_array_equal(got.deg.numpy(), _np(want.deg))


def test_append_reverse_edges_matches_jax():
    """Repeated targets past the row width (overflow), invalid targets."""
    rng = np.random.default_rng(2)
    cap, W = 64, 8
    adj, deg = _random_graph(rng, cap, W)
    targets = rng.integers(0, 16, size=300).astype(np.int32)
    targets[rng.random(300) < 0.1] = -1
    sources = (cap + rng.permutation(300)).astype(np.int32)
    want = jgraph.append_reverse_edges(
        jgraph.GraphArrays(jnp.asarray(adj), jnp.asarray(deg)),
        jnp.asarray(targets), jnp.asarray(sources))
    got = pgraph.append_reverse_edges(_port_graph(adj, deg), _t(targets),
                                      _t(sources))
    assert int(got.written.sum()) < int((targets >= 0).sum())  # overflow
    np.testing.assert_array_equal(got.graph.adj.numpy(), _np(want.graph.adj))
    np.testing.assert_array_equal(got.graph.deg.numpy(), _np(want.graph.deg))
    for f in ("targets", "sources", "cols", "written", "incoming", "pos"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("extra,m_max", [(False, 8), (True, 8), (True, 5)])
def test_prune_rows_matches_jax(extra, m_max):
    rng = np.random.default_rng(3 + extra + m_max)
    cap, W, words, P, X = 64, 8, 4, 24, 3
    adj, deg = _random_graph(rng, cap, W, full_share=0.7)
    pts = rng.integers(0, 2**32, size=(cap, words), dtype=np.uint32)
    node_ids = rng.permutation(cap)[:P].astype(np.int32)
    node_ids[[0, 7]] = -1
    safe = np.clip(node_ids, 0, cap - 1)
    node_pts, nbr_pts = pts[safe], pts[np.clip(adj[safe], 0, cap - 1)]
    kw_j, kw_p = {}, {}
    if extra:
        ex = rng.integers(0, cap, size=(P, X)).astype(np.int32)
        ex[rng.random((P, X)) < 0.4] = -1
        ex_pts = pts[np.clip(ex, 0, cap - 1)]
        kw_j = dict(extra_ids=jnp.asarray(ex), extra_pts=jnp.asarray(ex_pts))
        kw_p = dict(extra_ids=_t(ex), extra_pts=_t(ex_pts))
    want = jgraph.prune_rows(
        jgraph.GraphArrays(jnp.asarray(adj), jnp.asarray(deg)),
        jnp.asarray(node_ids), jnp.asarray(node_pts), jnp.asarray(nbr_pts),
        m_max, JAX_HAMMING, **kw_j)
    got = pgraph.prune_rows(_port_graph(adj, deg), _t(node_ids),
                            _t(node_pts), _t(nbr_pts), m_max, **kw_p)
    np.testing.assert_array_equal(got.adj.numpy(), _np(want.adj))
    np.testing.assert_array_equal(got.deg.numpy(), _np(want.deg))



@pytest.mark.parametrize("extra", [False, True])
def test_prune_rows_l2_matches_jax(extra):
    """``l2`` prunes on the direct difference, as the JAX function does:
    points far from the origin and close to each other, where the norm
    expansion of ``pairwise_mxu`` loses every digit of a pair's distance
    to float32 rounding, keep the rows JAX keeps."""
    rng = np.random.default_rng(9 + extra)
    cap, W, dim, P, X, m_max = 64, 8, 16, 24, 3, 5
    adj, deg = _random_graph(rng, cap, W, full_share=0.7)
    pts = (100.0 + 0.01 * rng.normal(size=(cap, dim))).astype(np.float32)
    node_ids = rng.permutation(cap)[:P].astype(np.int32)
    node_ids[[0, 7]] = -1
    safe = np.clip(node_ids, 0, cap - 1)
    node_pts, nbr_pts = pts[safe], pts[np.clip(adj[safe], 0, cap - 1)]
    kw_j, kw_p = {}, {}
    if extra:
        ex = rng.integers(0, cap, size=(P, X)).astype(np.int32)
        ex[rng.random((P, X)) < 0.4] = -1
        ex_pts = pts[np.clip(ex, 0, cap - 1)]
        kw_j = dict(extra_ids=jnp.asarray(ex), extra_pts=jnp.asarray(ex_pts))
        kw_p = dict(extra_ids=_t(ex), extra_pts=torch.from_numpy(ex_pts))
    want = jgraph.prune_rows(
        jgraph.GraphArrays(jnp.asarray(adj), jnp.asarray(deg)),
        jnp.asarray(node_ids), jnp.asarray(node_pts), jnp.asarray(nbr_pts),
        m_max, JAX_L2, **kw_j)
    got = pgraph.prune_rows(_port_graph(adj, deg), _t(node_ids),
                            torch.from_numpy(node_pts),
                            torch.from_numpy(nbr_pts), m_max, **kw_p,
                            metric=L2)
    np.testing.assert_array_equal(got.adj.numpy(), _np(want.adj))
    np.testing.assert_array_equal(got.deg.numpy(), _np(want.deg))

# -- build steps from a mid-build state ---------------------------------------

@pytest.fixture(scope="module")
def mid(data):
    """The JAX builder after MID points (host warmup, then device chunks):
    (state as host arrays, its options)."""
    with gather_route():
        b = JaxBuilder(JaxOptions(**OPTS, scan_group=1))
        b.extend_batched(data[0][:MID])
    return jax_state(b), b.opts, b


def _port_from(mid):
    state, opts, _ = mid
    return builder_from_numpy(state, IndexOptions(**dataclasses.asdict(opts)),
                              "cpu")


def test_builder_from_numpy_carries_state(mid):
    state = mid[0]
    pb = _port_from(mid)
    assert pb.n == state["n"] == MID and pb.ep == state["ep"]
    assert pb.level_ns == state["level_ns"] and len(pb.levels) > 1
    np.testing.assert_array_equal(pb.points.numpy().view(np.uint32),
                                  state["points"])
    np.testing.assert_array_equal(pb.spill[:-1].numpy(), state["spill"][:-1])
    assert bool((pb.spill[-1] == -1).all())
    r = np.random.RandomState()
    r.set_state(state["rng_state"])
    assert pb._rng.random_sample() == r.random_sample()
    pb.base.adj[0, 0] = -2  # the builder owns its arrays
    assert state["adj"][0, 0] != -2


def test_apply_inserts_matches_jax(mid, data):
    """Two apply_inserts in a row on the same state, reverse edges crowded
    onto 100 targets with a prune budget of 8: rows overflow, the spill
    buffer fills past its width (drops) and carries into the second call."""
    state, opts, _ = mid
    rng = np.random.default_rng(4)
    pb = _port_from(mid)
    cap = opts.size
    pts_j = jnp.asarray(state["points"])
    g_j = jgraph.GraphArrays(jnp.asarray(state["adj"]),
                             jnp.asarray(state["deg"]))
    spill_j = jnp.asarray(state["spill"])
    for c0 in (MID, MID + 64):
        new_ids = np.arange(c0, c0 + 64, dtype=np.int32)
        sel = np.stack([rng.choice(100, size=12, replace=False)
                        for _ in range(64)]).astype(np.int32)
        sel[rng.random(sel.shape) < 0.1] = -1
        sel[5] = -1  # a row that selected nothing
        new_ids[9] = -1  # a padding row
        g_j, _, spill_j, drop_j = jbuild.apply_inserts(
            pts_j, jnp.arange(cap, dtype=jnp.int32), g_j,
            jnp.asarray(new_ids), jnp.asarray(sel), None, spill_j,
            metric_name="hamming", prune_budget=8)
        pb.base, pb.spill, drop_p = pbuild.apply_inserts(
            pb.points, None, pb.base, _t(new_ids), _t(sel), pb.spill,
            prune_budget=8)
        np.testing.assert_array_equal(pb.base.adj.numpy(), _np(g_j.adj))
        np.testing.assert_array_equal(pb.base.deg.numpy(), _np(g_j.deg))
        np.testing.assert_array_equal(pb.spill[:-1].numpy(),
                                      _np(spill_j)[:-1])
        assert int(drop_p) == int(drop_j)
    assert int(drop_p) > 0 and bool((pb.spill[:-1] >= 0).any())


@pytest.mark.parametrize("use_entry", [True, False])
def test_chunk_step_matches_jax(mid, data, use_entry):
    """One 128-row base chunk_step: the sampled entry over the rows before
    the chunk, or given per-row entries; then search, select, mutation."""
    state, opts, _ = mid
    cap, c = opts.size, 128
    chunk = data[0][MID : MID + c]
    new_ids = np.arange(MID, MID + c, dtype=np.int32)
    eps = np.random.default_rng(5).integers(0, MID, size=c).astype(np.int32)
    kw = dict(efc=opts.ef_construction, m=opts.connections,
              prune_budget=max(opts.prune_budget, c),
              entry_sample=opts.entry_sample, use_entry=use_entry)
    _, g_j, _, spill_j, drop_j = jbuild.chunk_step(
        jnp.asarray(state["points"]), jnp.arange(cap, dtype=jnp.int32),
        jgraph.GraphArrays(jnp.asarray(state["adj"]),
                           jnp.asarray(state["deg"])),
        None, jnp.asarray(state["spill"]), jnp.asarray(chunk),
        jnp.asarray(new_ids), jnp.int32(MID), jnp.asarray(eps),
        jnp.int32(c), S=opts.batch_size, metric_name="hamming", **kw)
    pb = _port_from(mid)
    q = as_sketches(chunk, "cpu")
    pbuild.write_points(pb.points, q, MID)
    calls = dma_beam_search.plain_calls
    g_p, spill_p, drop_p = pbuild.chunk_step(
        pb.points, None, pb.base, pb.spill, q, _t(new_ids), MID,
        None if use_entry else _t(eps), **kw)
    assert dma_beam_search.plain_calls == calls + 1  # one search per chunk
    np.testing.assert_array_equal(g_p.adj.numpy(), _np(g_j.adj))
    np.testing.assert_array_equal(g_p.deg.numpy(), _np(g_j.deg))
    np.testing.assert_array_equal(spill_p[:-1].numpy(), _np(spill_j)[:-1])
    assert int(drop_p) == int(drop_j)


# -- whole builders -----------------------------------------------------------

_JAX_BUILDS = {}


def jax_build(pts, scan_group):
    """The JAX builder's gather-route build of ``pts`` (built once per
    ``scan_group``): (builder, index)."""
    if scan_group not in _JAX_BUILDS:
        with gather_route():
            jb = JaxBuilder(JaxOptions(**OPTS, scan_group=scan_group))
            jb.extend_batched(pts)
            _JAX_BUILDS[scan_group] = (jb, jb.build())
    return _JAX_BUILDS[scan_group]


def _jax_knns(idx, qs):
    idx.enable_inline()
    idx.query_entry_sample = OPTS["entry_sample"]
    r = idx.knns(qs, K, EF)
    return _np(r.dists), _np(r.ids)


@pytest.mark.parametrize("scan_group", [1, 4])
def test_extend_batched_matches_jax(data, scan_group):
    """Host warmup, progressive chunks, per-level groups; with scan_group
    4 one group of four 256-row chunks (upper levels over the whole group,
    base inserts deferred and run in id order); build(); then knns."""
    pts, qs = data
    jb, jidx = jax_build(pts, scan_group)
    pb = HNSWBuilder(IndexOptions(**OPTS, scan_group=scan_group),
                     device="cpu")
    sizes = []
    pb.extend_batched(pts, progress=sizes.append)
    pidx = pb.build()
    assert sizes[0] == OPTS["host_warmup"] and sizes[-1] == N
    assert (1024 in np.diff(sizes)) == (scan_group == 4)  # one whole group
    assert_same_builder(pb, jb)
    assert len(pidx.levels) > 1 and pidx.level_ns == jidx.level_ns
    pidx.enable_inline()
    pidx.query_entry_sample = OPTS["entry_sample"]
    r = pidx.knns(qs, K, EF)
    jd, ji = _jax_knns(jidx, qs)
    np.testing.assert_array_equal(r.dists.numpy(), jd)
    np.testing.assert_array_equal(r.ids.numpy(), ji)


def test_continued_build_matches_jax(mid, data):
    """A port builder carried across from the JAX mid-build state finishes
    the build as the JAX builder does (level draws included)."""
    jb = mid[2]  # the other tests read only the host-array state
    before = jb.total_edge_drops()
    with gather_route():
        jb.extend_batched(data[0][MID : MID + 600])
    pb = _port_from(mid)
    pb.extend_batched(data[0][MID : MID + 600])
    assert_same_builder(pb, jb, before)


def test_extend_matches_jax(data):
    """Sequential inserts (chunks of one, add), past the preallocated size
    (the base layer grows to the next power of two)."""
    pts = data[0][:40]
    opts = dict(OPTS, size=24, host_warmup=0, entry_sample=16)
    with gather_route():
        jb = JaxBuilder(JaxOptions(**opts))
        jb.extend(pts[:39])
        jb.add(pts[39])
    pb = HNSWBuilder(IndexOptions(**opts), device="cpu")
    pb.extend(pts[:39])
    pb.add(pts[39])
    assert pb.opts.size == jb.opts.size == 48
    assert_same_builder(pb, jb)


def test_jax_inline_build_rows_go_stale(data):
    """The JAX builder's default route keeps each row's neighbor sketches
    inline (``adj_pts``) but ``apply_inserts`` does not rewrite them after a
    prune, so rows go stale and later searches read wrong distances. Its
    graph then differs from the gather route's, which the port follows."""
    pts = data[0]
    jb = JaxBuilder(JaxOptions(**OPTS, scan_group=1))
    jb.extend_batched(pts)
    assert jb.adj_pts is not None and jb.inline_words == 0
    fresh = _np(_materialize_inline(jb.points, jb.base.adj, 0))
    W = OPTS["max_connections"]
    stale = (_np(jb.adj_pts).reshape(N, W, -1) != fresh.reshape(N, W, -1)
             ).any(-1) & (_np(jb.base.adj) >= 0)
    assert stale.any(axis=1).sum() > 0
    gb, _ = jax_build(pts, 1)
    assert not np.array_equal(_np(jb.base.adj), _np(gb.base.adj))
    assert jb.level_ns == gb.level_ns  # the level draws do not depend on it
