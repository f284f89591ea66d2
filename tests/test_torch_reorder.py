"""The port's BFS reorder (``ops/reorder.py``, ``NSW.reorder``,
``HNSW.reorder``, ``IndexOptions.reorder``) against the JAX package on CPU
tensors, bit-exact (tolerance 0): the permutation helpers, the relabeled
arrays, ``knns`` after a reorder on the general, fused and mini routes
(the JAX fused and mini paths in Pallas interpret mode), the sealed
builder and ``.npz`` files in both directions. Mirrors
tests/test_reorder.py."""

import numpy as np
import pytest

from hnsw_itu_tpu.models import IndexOptions as JaxOptions
from hnsw_itu_tpu.models import nsw as jax_nsw
from hnsw_itu_tpu.models.hnsw import HNSWBuilder as JaxHNSWBuilder
from hnsw_itu_tpu.models.nsw import NSWBuilder as JaxNSWBuilder
from hnsw_itu_tpu.ops import reorder as jax_reorder
from hnsw_itu_tpu.utils import load_index as jax_load
from hnsw_itu_tpu.utils import save_index as jax_save
from hnsw_itu_tpu_torch.models import IndexOptions
from hnsw_itu_tpu_torch.models import nsw as port_nsw
from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
from hnsw_itu_tpu_torch.models.nsw import NSWBuilder
from hnsw_itu_tpu_torch.ops import reorder
from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
from hnsw_itu_tpu_torch.ops.mini_search import mini_beam_search
from hnsw_itu_tpu_torch.utils import load_index, make_dataset, save_index
from test_torch_build import gather_route
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

N, NQ, K, EF = 800, 24, 10, 32
# host-built in both packages (the same arrays); W=32 rows so a mini
# table can serve
OPTS = dict(ef_construction=32, connections=8, max_connections=32, size=N,
            batch_size=64, host_warmup=N)
CLS = {"nsw": (NSWBuilder, JaxNSWBuilder), "hnsw": (HNSWBuilder,
                                                    JaxHNSWBuilder)}


@pytest.fixture(scope="module")
def data():
    return make_dataset(31, N, NQ)


def _build(kind, pts, **kw):
    """(port index, JAX index) of the same options, no query tables."""
    pcls, jcls = CLS[kind]
    opts = {**OPTS, **kw}
    with gather_route():
        jb = jcls(JaxOptions(**opts), metric="hamming")
        jb.extend_batched(pts)
        jidx = jb.build()
    pb = pcls(IndexOptions(**opts), device="cpu")
    pb.extend_batched(pts)
    return pb.build(), jidx


def _base(idx):
    return idx.base if hasattr(idx, "base") else idx.graph


def assert_same_arrays(p, j):
    np.testing.assert_array_equal(p.points.numpy().view(np.uint32),
                                  np.asarray(j.points))
    for t, u in ((_base(p).adj, _base(j).adj), (_base(p).deg, _base(j).deg),
                 (p.id_map, j.id_map)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(u))
    assert p.ep == j.ep
    for lp, lj in zip(getattr(p, "levels", []), getattr(j, "levels", [])):
        for t, u in ((lp.node_ids, lj.node_ids), (lp.down, lj.down),
                     (lp.graph.adj, lj.graph.adj)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(u))


def _knns(idx, qs, k=K, ef=EF):
    r = idx.knns(qs, k, ef)
    return (np.asarray(r.dists), np.asarray(r.ids),
            np.asarray(idx.last_stats["visited_q"]),
            np.asarray(idx.last_stats["steps_q"]))


def test_permutation_helpers_match_jax():
    adj = np.array([
        [1, 2, -1], [0, 3, -1], [0, 4, -1], [1, -1, -1],
        [2, 5, -1], [4, -1, -1], [-1, -1, -1],  # 6 disconnected
    ], np.int32)
    order = reorder.bfs_order(adj, 7, start=0)
    assert order[0] == 0 and order[-1] == 6
    np.testing.assert_array_equal(order, jax_reorder.bfs_order(adj, 7, 0))
    rng = np.random.default_rng(1)
    big = rng.integers(-1, 500, size=(500, 12)).astype(np.int32)
    for start in (0, 77):
        got = reorder.bfs_order(big, 480, start)
        want = jax_reorder.bfs_order(big, 480, start)
        np.testing.assert_array_equal(got, want)
        for a, b in zip(reorder.full_permutation(got, 512),
                        jax_reorder.full_permutation(want, 512)):
            np.testing.assert_array_equal(a, b)
        for win in (0, 1, 7, 64):
            np.testing.assert_array_equal(
                reorder.window_shuffle(got.copy(), win),
                jax_reorder.window_shuffle(want.copy(), win))


@pytest.mark.parametrize("kind", ["nsw", "hnsw"])
def test_reorder_arrays_match_jax(data, kind):
    """Points, adjacency, degrees, level node_ids/down (levels keep their
    local numbering), ep and id_map; the tie order then turns bit-reversed
    in both."""
    p, j = _build(kind, data[0])
    assert p._tie_bits() == j._tie_bits() == 0
    p.reorder()
    j.reorder()
    assert_same_arrays(p, j)
    assert p._tie_bits() == j._tie_bits() == 10


def _reordered_hnsw(pts):
    p, j = _build("hnsw", pts)
    p.reorder()
    j.reorder()
    return p, j


@pytest.mark.parametrize("route", ["general", "fused", "mini"])
def test_reordered_knns_matches_jax(data, route, monkeypatch):
    """knns of the reordered HNSW through the greedy descent, in original
    ids: the general route (bit-reversed ties), the fused plain version
    and the mini plain version (``tie_bits`` auto: the capacity's bits),
    each against the same JAX route."""
    pts, qs = data
    if route == "mini":
        monkeypatch.setattr(jax_nsw, "_fused_query_eligible",
                            lambda *a, **kw: False)
        monkeypatch.setattr(port_nsw, "_fused_query_eligible",
                            lambda *a, **kw: False)
    p, j = _reordered_hnsw(pts)
    if route != "general":
        monkeypatch.setenv("HNSW_TPU_MINI_INTERPRET", "1")
        p.enable_inline()
        j.enable_inline()
        j.level_adj_pts = None  # the port's descent dedups by bitmask
        assert (p.fused is None) == (j.fused is None) == (route == "mini")
        assert (p.mini is None) == (j.mini is None) == (route == "fused")
    kernel = {"fused": fused_beam_search, "mini": mini_beam_search}
    calls = kernel[route].plain_calls if route in kernel else 0
    got = _knns(p, qs)
    assert p.last_route == route
    if route in kernel:
        assert kernel[route].plain_calls == calls + 1
    want = _knns(j, qs)
    for name, g, w in zip(("dists", "ids", "visited", "steps"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_reorder_nsw_general_matches_jax(data):
    p, j = _build("nsw", data[0])
    p.reorder()
    j.reorder()
    for g, w in zip(_knns(p, data[1]), _knns(j, data[1])):
        np.testing.assert_array_equal(g, w)


def test_reorder_refuses_after_tables(data):
    p, _ = _build("nsw", data[0])
    p.enable_inline()
    assert p.fused is not None
    with pytest.raises(ValueError, match="enable_inline"):
        p.reorder()
    with pytest.raises(ValueError, match="unknown reorder"):
        p.reorder("dfs")


def test_reorder_hnsw_no_levels_remaps_ep(data):
    """With no levels ``ep`` is a base id and follows the relabel (BFS
    rank 0)."""
    pts, qs = data
    p, j = _build("hnsw", pts)
    for idx in (p, j):
        idx.ep = idx.base_ep()
        idx.levels, idx.level_ns = [], []
        idx.query_tie = "id"
    before = _knns(p, qs)
    p.reorder()
    j.reorder()
    assert p.ep == j.ep == 0
    assert_same_arrays(p, j)
    after = _knns(p, qs)
    np.testing.assert_array_equal(before[0], after[0])
    for g, w in zip(after, _knns(j, qs)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["nsw", "hnsw"])
def test_opts_reorder_build_and_seal(data, kind):
    """``IndexOptions.reorder=True``: build() relabels, the builder holds
    the relabeled arrays and is sealed with the JAX error."""
    pts, qs = data
    pcls, jcls = CLS[kind]
    opts = {**OPTS, "host_warmup": 200, "reorder": True}
    pb = pcls(IndexOptions(**opts), device="cpu")
    pb.extend_batched(pts)
    p = pb.build()
    with gather_route():
        jb = jcls(JaxOptions(**opts), metric="hamming")
        jb.extend_batched(pts)
        j = jb.build()
    assert p.id_map is not None and pb.points is p.points
    assert _base(pb).adj is _base(p).adj
    assert_same_arrays(p, j)
    for g, w in zip(_knns(p, qs), _knns(j, qs)):
        np.testing.assert_array_equal(g, w)
    for call in (pb.build, lambda: pb.extend_batched(pts[:4]),
                 lambda: pb.extend(pts[:1])):
        with pytest.raises(RuntimeError, match="sealed"):
            call()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reordered_npz_both_ways(data, tmp_path, writer):
    """A reordered index written by one package and read by the other
    keeps its id_map and gives the same knns."""
    pts, qs = data
    p, j = _reordered_hnsw(pts)
    f = tmp_path / "r.npz"
    if writer == "jax":
        jax_save(str(f), j)
        got, _ = load_index(str(f), "cpu")
        assert_same_arrays(got, j)
        ref = j
    else:
        save_index(str(f), p)
        got, _ = jax_load(str(f))
        assert_same_arrays(p, got)
        got, ref = p, got
    for g, w in zip(_knns(got, qs), _knns(ref, qs)):
        np.testing.assert_array_equal(g, w)


def test_shuffle_window_env_gives_the_same_permutation(data, monkeypatch):
    monkeypatch.setenv("HNSW_TPU_REORDER_SHUFFLE", "16")
    p, j = _reordered_hnsw(data[0])
    assert_same_arrays(p, j)
    monkeypatch.delenv("HNSW_TPU_REORDER_SHUFFLE")
    plain, _ = _reordered_hnsw(data[0])
    assert not np.array_equal(p.id_map.numpy(), plain.id_map.numpy())
