"""The port's index and query sharding (``hnsw_itu_tpu_torch.parallel``)
against the JAX package's (``hnsw_itu_tpu.parallel``) on the same numpy
inputs, bit-exact (tolerance 0), for Hamming and ``l2int``.

The JAX side runs on the 8-device virtual CPU mesh of ``conftest.py``
(``make_mesh(S)``); the port on a mesh that names the CPU S times
(``make_mesh(devices=["cpu"] * S)``). The JAX fused sharded query runs its
Pallas kernel in interpret mode (``HNSW_TPU_MINI_INTERPRET=1``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_itu_tpu.models import IndexOptions as JaxOptions
from hnsw_itu_tpu.models import _build as jax_build
from hnsw_itu_tpu.models.hnsw import HNSWBuilder as JaxHNSWBuilder
from hnsw_itu_tpu.models.nsw import NSWBuilder as JaxNSWBuilder
from hnsw_itu_tpu.parallel import ShardedHNSW as JaxShardedHNSW
from hnsw_itu_tpu.parallel import ShardedNSW as JaxShardedNSW
from hnsw_itu_tpu.parallel import knns_query_sharded as jax_query_sharded
from hnsw_itu_tpu.parallel import make_mesh as jax_make_mesh
from hnsw_itu_tpu.parallel import shard_leading as jax_shard_leading
from hnsw_itu_tpu.parallel import sharded_build_step as jax_build_step
from hnsw_itu_tpu_torch.graph import GraphArrays
from hnsw_itu_tpu_torch.models import IndexOptions
from hnsw_itu_tpu_torch.models import _build
from hnsw_itu_tpu_torch.models.base import ID_INF
from hnsw_itu_tpu_torch.models.nsw import NSW, NSWBuilder
from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
from hnsw_itu_tpu_torch.ops.metrics import as_points
from hnsw_itu_tpu_torch.parallel import (AXIS, ShardedHNSW, ShardedNSW,
                                         knns_query_sharded, make_mesh,
                                         replicate, shard_leading,
                                         sharded_build_step)
from hnsw_itu_tpu_torch.utils import from_numpy, make_dataset
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

S, N, NQ, K = 4, 1203, 24, 10  # N not a multiple of S: a ragged last shard
OPTS = dict(host_warmup=0, ef_construction=48, connections=12,
            max_connections=24, size=N, batch_size=32, entry_sample=0,
            scan_group=1)


def cpu_mesh(s):
    return make_mesh(devices=["cpu"] * s)


def _np(x):
    return np.asarray(x)


def assert_same(got, want):
    """A port result (tensors) equal to a JAX one (arrays), bit for bit."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


@pytest.fixture(scope="module")
def data():
    return make_dataset(17, N, NQ)


def _port_index_state(idx):
    return ([a.numpy() for a in idx.adj_s], [d.numpy() for d in idx.deg_s],
            idx.ns, idx.offsets, [int(d) for d in idx.edge_drops_s])


def _jax_index_state(idx):
    return (list(_np(idx.adj_s)), list(_np(idx.deg_s)), _np(idx.ns),
            _np(idx.offsets), _np(idx.edge_drops_s).tolist())


def assert_same_build(pidx, jidx):
    padj, pdeg, pns, poff, pdrops = _port_index_state(pidx)
    jadj, jdeg, jns, joff, jdrops = _jax_index_state(jidx)
    np.testing.assert_array_equal(pns, jns)
    np.testing.assert_array_equal(poff, joff)
    assert pdrops == jdrops
    for s in range(len(pns)):
        np.testing.assert_array_equal(padj[s], jadj[s])
        np.testing.assert_array_equal(pdeg[s], jdeg[s])
    np.testing.assert_array_equal(
        np.stack([p.numpy() for p in pidx.points_s]).view(np.uint32),
        _np(jidx.points_s).view(np.uint32))


_BUILT = {}


def built_hnsw(pts):
    """(JAX ShardedHNSW, port ShardedHNSW) over ``pts``, built once."""
    if "hnsw" not in _BUILT:
        _BUILT["hnsw"] = (
            JaxShardedHNSW.build(pts, JaxOptions(**OPTS),
                                 mesh=jax_make_mesh(S)),
            ShardedHNSW.build(pts, IndexOptions(**OPTS), mesh=cpu_mesh(S)))
    return _BUILT["hnsw"]


def carried(jidx, cls=ShardedNSW, s=S):
    """The port's sharded index over a JAX sharded index's arrays."""
    return cls.from_numpy(_np(jidx.points_s), _np(jidx.adj_s),
                          _np(jidx.deg_s), _np(jidx.eps), _np(jidx.offsets),
                          _np(jidx.ns), jidx.metric.name, IndexOptions(**OPTS),
                          mesh=cpu_mesh(s))


# --- mesh helpers ----------------------------------------------------------


def test_mesh_helpers():
    mesh = make_mesh(devices=["cpu"] * 3)
    assert AXIS == "shard" and mesh.size == 3
    assert mesh.devices == (torch.device("cpu"),) * 3
    x = np.arange(3 * 4 * 2, dtype=np.uint32).reshape(3, 4, 2)
    x[0, 0, 0] = 2**32 - 1
    parts = shard_leading(mesh, x)
    assert [tuple(p.shape) for p in parts] == [(4, 2)] * 3
    assert all(p.device == torch.device("cpu") for p in parts)
    np.testing.assert_array_equal(
        np.stack([p.numpy() for p in parts]).view(np.uint32), x)
    t = torch.arange(6)
    reps = replicate(mesh, t)
    assert len(reps) == 3 and all(r is t for r in reps)  # one shared copy
    with pytest.raises(ValueError):
        shard_leading(mesh, x[:2])
    with pytest.raises(ValueError):
        make_mesh(2, devices=["cpu"] * 3)


def test_make_mesh_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError):
        ShardedNSW.build(np.zeros((8, 4), np.uint32), IndexOptions(size=8))


def test_shard_state_must_lie_on_its_device():
    idx = ShardedNSW.from_numpy(
        np.zeros((2, 4, 2), np.uint32), np.full((2, 4, 4), -1, np.int32),
        np.zeros((2, 4), np.int32), [0, 0], [0, 4], [4, 4], "hamming",
        IndexOptions(size=8), mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="mesh device"):
        ShardedNSW(make_mesh(devices=["cpu", "meta"]), idx.points_s,
                   (idx.adj_s, idx.deg_s), idx.eps, idx.offsets, idx.ns,
                   "hamming", idx.opts)


# --- the build -------------------------------------------------------------


def test_sharded_build_step_matches_jax():
    """tests/test_sharded.py's step: S=8, a ragged last shard."""
    s, cap, W, c = 8, 64, 8, 6
    rng = np.random.default_rng(5)
    pts0 = rng.integers(0, 2**32, size=(s, cap, 32), dtype=np.uint32)
    valid = np.ones((s, c), bool)
    valid[-1, -2:] = False
    jm = jax_make_mesh(s)
    want = jax_build_step(
        jax_shard_leading(jm, jnp.asarray(pts0)),
        jax_shard_leading(jm, jnp.full((s, cap, W), -1, jnp.int32)),
        jax_shard_leading(jm, jnp.zeros((s, cap), jnp.int32)),
        jax_shard_leading(jm, jnp.full(
            (s, cap + 1, jax_build.SPILL_WIDTH), -1, jnp.int32)),
        jax_shard_leading(jm, jnp.zeros((s,), jnp.int32)),
        jax_shard_leading(jm, jnp.ones((s,), jnp.int32)),
        jax_shard_leading(jm, jnp.asarray(pts0[:, 1 : 1 + c])),
        jax_shard_leading(jm, jnp.asarray(valid)),
        efc=16, m=4, metric_name="hamming", expand=1, prune_budget=16,
        mesh=jm)
    pm = cpu_mesh(s)
    pts_in = pts0.copy()
    pts_in[:, 1 : 1 + c] = 0  # the step writes the chunk itself
    got = sharded_build_step(
        shard_leading(pm, pts_in),
        [torch.full((cap, W), -1, dtype=torch.int32) for _ in range(s)],
        [torch.zeros(cap, dtype=torch.int32) for _ in range(s)],
        [_build.make_spill(cap, device="cpu") for _ in range(s)],
        [0] * s, [1] * s, pts0[:, 1 : 1 + c], valid,
        efc=16, m=4, metric="hamming", expand=1, prune_budget=16, mesh=pm)
    points_s, adj_s, deg_s, spill_s, n_s, drops_s = got
    jp, ja, jd, jsp, jn, jdr = (_np(x) for x in want)
    np.testing.assert_array_equal(
        np.stack([p.numpy() for p in points_s]).view(np.uint32), jp)
    np.testing.assert_array_equal(np.stack([a.numpy() for a in adj_s]), ja)
    np.testing.assert_array_equal(np.stack([d.numpy() for d in deg_s]), jd)
    np.testing.assert_array_equal(
        np.stack([x[:-1].numpy() for x in spill_s]), jsp[:, :-1])
    np.testing.assert_array_equal(n_s, jn)
    assert n_s.tolist() == [1 + c] * (s - 1) + [1 + c - 2]
    assert [int(d) for d in drops_s] == jdr.tolist()


def test_sharded_build_step_takes_any_valid_mask():
    """Valid rows that are not a prefix: ids ``n + row`` as in the JAX
    step."""
    s, cap, W, c = 2, 32, 8, 6
    rng = np.random.default_rng(8)
    pts0 = rng.integers(0, 2**32, size=(s, cap, 8), dtype=np.uint32)
    valid = np.array([[True, False, True, True, False, True],
                      [False] * c])
    jm = jax_make_mesh(s)
    want = jax_build_step(
        jax_shard_leading(jm, jnp.asarray(pts0)),
        jax_shard_leading(jm, jnp.full((s, cap, W), -1, jnp.int32)),
        jax_shard_leading(jm, jnp.zeros((s, cap), jnp.int32)),
        jax_shard_leading(jm, jnp.full(
            (s, cap + 1, jax_build.SPILL_WIDTH), -1, jnp.int32)),
        jax_shard_leading(jm, jnp.zeros((s,), jnp.int32)),
        jax_shard_leading(jm, jnp.ones((s,), jnp.int32)),
        jax_shard_leading(jm, jnp.asarray(pts0[:, 1 : 1 + c])),
        jax_shard_leading(jm, jnp.asarray(valid)),
        efc=16, m=4, metric_name="hamming", expand=1, prune_budget=16,
        mesh=jm)
    pm = cpu_mesh(s)
    got = sharded_build_step(
        shard_leading(pm, pts0),
        [torch.full((cap, W), -1, dtype=torch.int32) for _ in range(s)],
        [torch.zeros(cap, dtype=torch.int32) for _ in range(s)],
        [_build.make_spill(cap, device="cpu") for _ in range(s)],
        [0] * s, [1] * s, pts0[:, 1 : 1 + c], valid,
        efc=16, m=4, expand=1, prune_budget=16, mesh=pm)
    np.testing.assert_array_equal(np.stack([a.numpy() for a in got[1]]),
                                  _np(want[1]))
    np.testing.assert_array_equal(got[4], _np(want[4]))


@pytest.mark.parametrize("scan_group", [1, 2])
def test_sharded_build_matches_jax(data, scan_group):
    """ShardedNSW.build: contiguous shards, a ragged last one, progressive
    chunks of at most batch_size rows (the JAX build runs its scanned
    G-chunk dispatch at scan_group 2), leftover spills counted."""
    pts = data[0]
    if scan_group == OPTS["scan_group"]:
        jidx, pidx = built_hnsw(pts)  # ShardedNSW.build, by inheritance
    else:
        opts = dict(OPTS, scan_group=scan_group)
        jidx = JaxShardedNSW.build(pts, JaxOptions(**opts),
                                   mesh=jax_make_mesh(S))
        pidx = ShardedNSW.build(pts, IndexOptions(**opts), mesh=cpu_mesh(S))
    assert pidx.ns.tolist() == [301, 301, 301, 300]
    assert_same_build(pidx, jidx)
    assert pidx.size() == N == jidx.size()
    assert pidx.total_edge_drops() == jidx.total_edge_drops()


def test_sharded_build_l2int_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.integers(-20, 20, size=(401, 6), dtype=np.int32)
    qs = rng.integers(-20, 20, size=(NQ, 6), dtype=np.int32)
    opts = dict(OPTS, size=401, batch_size=16)
    jidx = JaxShardedNSW.build(pts, JaxOptions(**opts), metric="l2int",
                               mesh=jax_make_mesh(S))
    pidx = ShardedNSW.build(pts, IndexOptions(**opts), metric="l2int",
                            mesh=cpu_mesh(S))
    assert_same_build(pidx, jidx)
    assert_same(pidx.knns(qs, K, 32), jidx.knns(qs, K, 32))


def test_empty_shards_give_only_sentinels():
    """S=8 over 10 points: shards 5-7 are empty. Their slots are
    (inf, ID_INF) in both packages, and every point is still found."""
    rng = np.random.default_rng(4)
    pts = rng.integers(0, 2**32, size=(10, 8), dtype=np.uint32)
    opts = dict(OPTS, size=10)
    jidx = JaxShardedNSW.build(pts, JaxOptions(**opts),
                               mesh=jax_make_mesh(8))
    pidx = ShardedNSW.build(pts, IndexOptions(**opts), mesh=cpu_mesh(8))
    assert pidx.ns.tolist() == [2] * 5 + [0] * 3
    assert_same_build(pidx, jidx)
    got = pidx.knns(pts, 12, 16)
    assert_same(got, jidx.knns(pts, 12, 16))
    ids, d = got.ids.numpy(), got.dists.numpy()
    assert (ids[:, 0] == np.arange(10)).all()
    assert (ids[:, 10:] == np.iinfo(np.int32).max).all()
    assert (d[:, 10:] == np.iinfo(np.int32).max).all()


# --- index-sharded queries ---------------------------------------------------


def test_sharded_knns_general_route_matches_jax(data):
    """ShardedNSW at its fixed entries and ShardedHNSW at the per-shard
    sampled entry, on the JAX index carried over by from_numpy."""
    pts, qs = data
    jidx, _ = built_hnsw(pts)
    assert jidx.fused_s is None
    for cls, sample in ((ShardedNSW, 0), (ShardedHNSW, 1024)):
        pidx = carried(jidx, cls)
        assert pidx.query_entry_sample == (0 if cls is ShardedNSW else 1024)
        pidx.query_entry_sample = jidx.query_entry_sample = sample
        got = pidx.knns(qs, K, 32)
        assert pidx.last_route == "general"
        assert_same(got, jidx.knns(qs, K, 32))
        assert got.ids.shape == (NQ, K)
    jidx.query_entry_sample = JaxShardedHNSW.DEFAULT_ENTRY_SAMPLE
    # one query through search
    pidx = carried(jidx, ShardedHNSW)
    one = pidx.search(qs[3], K, 32)
    assert_same(one, [x[3] for x in jidx.knns(qs, K, 32)])


def test_sharded_fused_knns_matches_jax(data, monkeypatch):
    """enable_inline() builds one fused table per shard in both packages;
    knns runs kernel #1's path once per shard (the plain version on CPU
    tensors) and merges: dists and ids equal to the JAX fused sharded
    query (interpret mode)."""
    monkeypatch.setenv("HNSW_TPU_MINI_INTERPRET", "1")
    pts, qs = data
    jidx, _ = built_hnsw(pts)
    pidx = carried(jidx, ShardedHNSW)
    jidx.enable_inline()
    pidx.enable_inline()
    assert jidx.fused_s is not None and len(pidx.fused_s) == S
    before = fused_beam_search.plain_calls
    got = pidx.knns(qs, K, 48)
    assert pidx.last_route == "fused"
    assert fused_beam_search.plain_calls - before == S
    want = jidx.knns(qs, K, 48)
    assert_same(got, want)
    d, ids = got.dists.numpy(), got.ids.numpy()
    assert (np.diff(d, axis=1) >= 0).all()
    assert ((ids >= 0) & (ids < N)).all()
    # the general route on the same index agrees on the top hit
    for sh in pidx.shards:
        sh.fused = None
    assert (pidx.knns(qs, K, 48).ids[:, 0] == got.ids[:, 0]).all()


def test_sharded_slice_matches_jax(data, monkeypatch):
    """The slice as a whole: ShardedHNSW.build, enable_inline(), knns on
    the fused route, in both packages from the same points."""
    monkeypatch.setenv("HNSW_TPU_MINI_INTERPRET", "1")
    pts, qs = data
    jidx, pidx = built_hnsw(pts)
    assert_same_build(pidx, jidx)
    jidx.enable_inline()
    pidx.enable_inline()
    for ef in (16, 32):
        assert_same(pidx.knns(qs, K, ef), jidx.knns(qs, K, ef))
    assert pidx.last_route == "fused"


@pytest.mark.parametrize("route,sample", [
    ("general", 0), ("general", 1024), ("fused", 0), ("fused", 1024)])
def test_shard_topk_is_the_shards_own_knns(data, route, sample):
    """The seam between a sharded index and the one-card query step: each
    shard's ``_shard_topk`` equals ``knns`` of an NSW made apart over that
    shard's tensors (at its entry, with its own fused table, the sharded
    index's knobs set on it), its ids offset by the shard's: the knobs
    reach every shard."""
    pts, qs = data
    jidx, _ = built_hnsw(pts)
    pidx = carried(jidx, ShardedHNSW)
    # two steps: the answers still depend on the entry
    pidx.query_entry_sample, pidx.max_steps = sample, 2
    if route == "fused":
        pidx.enable_inline()
    assert pidx.route(K, 32) == route
    q = as_points(qs, "cpu")
    for s in range(S):
        one = NSW(pidx.points_s[s], pidx.ns[s],
                  GraphArrays(pidx.adj_s[s], pidx.deg_s[s]), pidx.eps[s],
                  "hamming", device="cpu")
        one.query_entry_sample, one.max_steps = sample, 2
        if route == "fused":
            one.enable_inline()
        want = one.knns(q, K, 32)
        assert one.last_route == route
        d, i = pidx._shard_topk(s, q, K, 32, route)
        valid = want.ids != ID_INF
        assert torch.equal(i, torch.where(
            valid, want.ids + int(pidx.offsets[s]), ID_INF))
        assert torch.equal(d, torch.where(valid, want.dists,
                                          pidx.metric.inf))


def test_shard_independence(data):
    """Each shard of a 4-shard build equals a 1-shard build of its own
    rows: shards share no edges and no state."""
    pts = data[0]
    _, pidx = built_hnsw(pts)
    cap_s = pidx.adj_s[0].shape[0]
    for s in range(S):
        ns = int(pidx.ns[s])
        rows = pts[s * cap_s : s * cap_s + ns]
        one = ShardedHNSW.build(rows, IndexOptions(**dict(OPTS, size=ns)),
                                mesh=cpu_mesh(1))
        assert one.ns.tolist() == [ns]
        np.testing.assert_array_equal(one.adj_s[0].numpy(),
                                      pidx.adj_s[s][:ns].numpy())
        np.testing.assert_array_equal(one.deg_s[0].numpy(),
                                      pidx.deg_s[s][:ns].numpy())
        assert int(one.edge_drops_s[0]) == int(pidx.edge_drops_s[s])


# --- query sharding ----------------------------------------------------------


# the single-device indexes are built by the native host engine (quick);
# what is compared is the query
_QS_OPTS = dict(ef_construction=32, connections=8, max_connections=16)


def _qs_opts(n):
    return dict(_QS_OPTS, size=n, host_warmup=n)


def _nsw_pair(pts):
    """(JAX NSW, the port's NSW over its arrays)."""
    jb = JaxNSWBuilder(JaxOptions(**_qs_opts(len(pts))))
    jb.extend_batched(pts)
    j = jb.build()
    j.adj_pts = None
    p = NSW(torch.from_numpy(np.array(_np(j.points)).view(np.int32)), j.n,
            GraphArrays(torch.from_numpy(np.array(_np(j.graph.adj))),
                        torch.from_numpy(np.array(_np(j.graph.deg)))),
            j.ep, "hamming", IndexOptions(**_qs_opts(len(pts))),
            device="cpu")
    return j, p


def _check_query_sharded(pidx, jidx, qs):
    """The port's knns_query_sharded on 8 shards equal to the JAX one's
    and to the port's single-device general route; on 3 shards equal to
    that route too."""
    got = knns_query_sharded(pidx, qs, 5, 32, mesh=cpu_mesh(8))
    assert_same(got, jax_query_sharded(jidx, qs, 5, 32,
                                       mesh=jax_make_mesh(8)))
    single = pidx.knns(qs, 5, 32)
    assert pidx.last_route == "general"
    assert_same(got, [x.numpy() for x in single])
    assert_same(knns_query_sharded(pidx, qs, 5, 32, mesh=cpu_mesh(3)),
                [x.numpy() for x in single])
    return got


def test_query_sharded_nsw_matches_jax():
    rng = np.random.default_rng(9)
    pts = rng.integers(0, 2**32, size=(500, 32), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(13, 32), dtype=np.uint32)  # padded
    jidx, pidx = _nsw_pair(pts)
    _check_query_sharded(pidx, jidx, qs)


@pytest.mark.parametrize("entry_sample", [0, 128])
def test_query_sharded_hnsw_matches_jax(entry_sample):
    """The replicated hierarchy: the greedy descent (entry_sample 0) and
    the sampled entry."""
    rng = np.random.default_rng(11)
    pts = rng.integers(0, 2**32, size=(600, 32), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(16, 32), dtype=np.uint32)
    if "qs_hnsw" not in _BUILT:
        jb = JaxHNSWBuilder(JaxOptions(**_qs_opts(600)))
        jb.extend_batched(pts)
        _BUILT["qs_hnsw"] = jb.build()
    j = _BUILT["qs_hnsw"]
    assert len(j.levels) >= 1
    p = from_numpy(_np(j.points), _np(j.base.adj), _np(j.base.deg),
                   [(_np(lv.node_ids), _np(lv.down), _np(lv.graph.adj),
                     _np(lv.graph.deg)) for lv in j.levels],
                   j.level_ns, j.ep, j.n, IndexOptions(**_qs_opts(600)),
                   "cpu")
    j.query_entry_sample = p.query_entry_sample = entry_sample
    _check_query_sharded(p, j, qs)


def test_query_sharded_reordered_returns_original_ids():
    rng = np.random.default_rng(13)
    pts = rng.integers(0, 2**32, size=(500, 32), dtype=np.uint32)
    qs = pts[:16] ^ np.uint32(3)  # near-duplicate queries
    jidx, pidx = _nsw_pair(pts)
    jidx.reorder()
    pidx.reorder()
    np.testing.assert_array_equal(pidx.id_map.numpy(), _np(jidx.id_map))
    got = _check_query_sharded(pidx, jidx, qs)
    assert (got.ids.numpy()[:, 0] == np.arange(16)).all()


def test_query_sharded_warns_on_a_table():
    rng = np.random.default_rng(14)
    pts = rng.integers(0, 2**32, size=(200, 8), dtype=np.uint32)
    b = NSWBuilder(IndexOptions(**_qs_opts(200)), device="cpu")
    b.extend_batched(pts)
    pidx = b.build()
    pidx.enable_inline()
    assert pidx.fused is not None
    with pytest.warns(UserWarning, match="general beam search"):
        knns_query_sharded(pidx, pts[:4], 5, 32, mesh=cpu_mesh(2))


def test_sharded_tables_share_one_card_budget(monkeypatch):
    """The fused gate reckons every table bound for one device together:
    on a card with room for three tables, four shards there get none."""
    import hnsw_itu_tpu_torch.models.nsw as nsw_mod

    seen = []

    def gate(points, adj, metric, tables=1):
        seen.append(tables)
        return tables <= 3

    monkeypatch.setattr("hnsw_itu_tpu_torch.parallel.sharded."
                        "_fused_query_eligible", gate)
    assert nsw_mod._fused_query_eligible is not gate
    idx = ShardedNSW.from_numpy(
        np.zeros((4, 8, 2), np.uint32), np.full((4, 8, 4), -1, np.int32),
        np.zeros((4, 8), np.int32), [0] * 4, [0, 8, 16, 24], [8] * 4,
        "hamming", IndexOptions(size=32), mesh=cpu_mesh(4))
    idx.enable_inline()
    assert idx.fused_s is None and seen == [4]
    idx2 = ShardedNSW(make_mesh(devices=["cpu", "cpu", "meta", "meta"]),
                      [torch.zeros(8, 2, dtype=torch.int32)] * 2 + [
                          torch.zeros(8, 2, dtype=torch.int32,
                                      device="meta")] * 2,
                      ([torch.full((8, 4), -1, dtype=torch.int32)] * 2 + [
                          torch.empty(8, 4, dtype=torch.int32,
                                      device="meta")] * 2,
                       [torch.zeros(8, dtype=torch.int32)] * 2 + [
                           torch.empty(8, dtype=torch.int32,
                                       device="meta")] * 2),
                      [0] * 4, [0, 8, 16, 24], [8] * 4, "hamming",
                      IndexOptions(size=32))
    seen.clear()
    monkeypatch.setattr("hnsw_itu_tpu_torch.parallel.sharded."
                        "materialize_fused", lambda p, a: (p.device, a))
    idx2.enable_inline()
    assert seen == [2, 2]
    assert [t[0].type for t in idx2.fused_s] == ["cpu", "cpu", "meta",
                                                  "meta"]
