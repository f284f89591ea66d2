"""The HNSW query side end to end on CPU tensors: the port's host-built
HNSW, its ``.npz`` load of a JAX-saved index, its ``knns`` on the fused
and the general routes, with the sampled entry and with the greedy
descent, ``search``, and its brute-force oracle, each bit-exact
(tolerance 0) against ``hnsw_itu_tpu`` on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest

from hnsw_itu_tpu.graph import GraphArrays as JaxGraph
from hnsw_itu_tpu.models import Bruteforce as JaxBruteforce
from hnsw_itu_tpu.models import IndexOptions as JaxOptions
from hnsw_itu_tpu.models.hnsw import HNSW as JaxHNSW
from hnsw_itu_tpu.models.hnsw import HNSWBuilder as JaxBuilder
from hnsw_itu_tpu.utils import load_index as jax_load
from hnsw_itu_tpu.utils import save_index as jax_save
from hnsw_itu_tpu.utils.synth import make_dataset as jax_make_dataset
from hnsw_itu_tpu_torch import native
from hnsw_itu_tpu_torch.models import Bruteforce, IndexOptions
from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
from hnsw_itu_tpu_torch.utils import (from_numpy, load_index, make_dataset,
                                      recall_at_k, save_index)
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

N, NQ, K, EF, SAMPLE = 2000, 64, 10, 32, 64
OPTS = dict(ef_construction=48, connections=12, max_connections=24, size=N,
            batch_size=128, host_warmup=N)


@pytest.fixture(scope="module")
def data():
    return make_dataset(3, N, NQ)


@pytest.fixture(scope="module")
def jax_index(data, tmp_path_factory):
    """The JAX package's host-built index, saved to .npz."""
    pts, _ = data
    b = JaxBuilder(JaxOptions(**OPTS), metric="hamming")
    b.extend_batched(pts)
    idx = b.build()
    path = tmp_path_factory.mktemp("idx") / "jax.npz"
    jax_save(str(path), idx)
    return idx, path


@pytest.fixture(scope="module")
def jax_knns(jax_index, data):
    """JAX query results on the inline-row path: with enable_inline() the
    CPU path runs _beam_search_packed, the function the kernel computes."""
    idx, _ = jax_index
    idx.enable_inline()
    idx.query_entry_sample = SAMPLE
    r = idx.knns(data[1], K, EF)
    return (np.asarray(r.dists), np.asarray(r.ids),
            idx.last_stats["visited_q"], idx.last_stats["steps_q"])


@pytest.fixture(scope="module")
def port_index(data):
    b = HNSWBuilder(IndexOptions(**OPTS), metric="hamming", device="cpu")
    b.extend_batched(data[0])
    return b.build()


def test_synth_same_arrays():
    for a, b in zip(make_dataset(7, 3000, 50), jax_make_dataset(7, 3000, 50)):
        np.testing.assert_array_equal(a, b)


def test_host_build_matches_jax(jax_index, port_index):
    jidx, _ = jax_index
    assert port_index.ep == jidx.ep
    assert port_index.n == jidx.n
    assert port_index.level_ns == jidx.level_ns
    assert len(port_index.levels) == len(jidx.levels) > 0
    np.testing.assert_array_equal(
        port_index.points.numpy().view(np.uint32), np.asarray(jidx.points))
    np.testing.assert_array_equal(port_index.base.adj.numpy(),
                                  np.asarray(jidx.base.adj))
    np.testing.assert_array_equal(port_index.base.deg.numpy(),
                                  np.asarray(jidx.base.deg))
    for lp, lj in zip(port_index.levels, jidx.levels):
        np.testing.assert_array_equal(lp.node_ids.numpy(),
                                      np.asarray(lj.node_ids))
        np.testing.assert_array_equal(lp.down.numpy(), np.asarray(lj.down))
        np.testing.assert_array_equal(lp.graph.adj.numpy(),
                                      np.asarray(lj.graph.adj))
        np.testing.assert_array_equal(lp.graph.deg.numpy(),
                                      np.asarray(lj.graph.deg))
    assert port_index.base_ep() == jidx.base_ep()


def _port_knns(idx, qs, batch=1024):
    idx.enable_inline()
    idx.query_entry_sample = SAMPLE
    idx.query_batch = batch
    calls = fused_beam_search.plain_calls
    r = idx.knns(qs, K, EF)
    assert fused_beam_search.plain_calls == calls + -(-len(qs) // batch)
    return (r.dists.numpy(), r.ids.numpy(), idx.last_stats["visited_q"],
            idx.last_stats["steps_q"])


@pytest.mark.parametrize("batch", [1024, 24])
def test_knns_on_jax_saved_index(jax_index, jax_knns, data, batch):
    """Load the JAX-saved .npz and query: dists, ids, visited and steps
    equal the JAX query, whole batch or cut into ragged batches."""
    idx, _ = load_index(str(jax_index[1]), "cpu")
    got = _port_knns(idx, data[1], batch)
    for g, w in zip(got, jax_knns):
        np.testing.assert_array_equal(g, w)


def test_knns_on_port_built_index(port_index, jax_knns, data):
    got = _port_knns(port_index, data[1])
    for g, w in zip(got, jax_knns):
        np.testing.assert_array_equal(g, w)
    _, bf_ids = native.host_bruteforce(data[0], "hamming", data[1], K)
    assert recall_at_k(got[1], bf_ids, K) >= 0.9


def test_save_loads_in_jax(port_index, tmp_path):
    path = tmp_path / "port.npz"
    save_index(str(path), port_index)
    jidx, attrs = jax_load(str(path))
    assert jidx.ep == port_index.ep and jidx.level_ns == port_index.level_ns
    np.testing.assert_array_equal(np.asarray(jidx.points),
                                  port_index.points.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(jidx.base.adj),
                                  port_index.base.adj.numpy())
    assert attrs.data == "hamming"


def test_bruteforce_matches_jax():
    pts, qs = make_dataset(5, 3000, 40)
    qs[:4] = pts[[0, 17, 17, 2999]]  # exact hits and ties
    want = JaxBruteforce("hamming", tile=1024)
    want.extend(pts[:1500])
    want.extend(pts[1500:])
    want = want.build().knns(qs, K, batch=16)
    got = Bruteforce("hamming", tile=1024, device="cpu")
    got.extend(pts[:1500])
    got.extend(pts[1500:])
    got = got.build().knns(qs, K, batch=16)
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    d_host, _ = native.host_bruteforce(pts, "hamming", qs, K)
    np.testing.assert_array_equal(got.dists.numpy(), d_host)


@pytest.fixture(scope="module")
def jax_loaded(jax_index):
    """Fresh JAX indexes loaded from the saved .npz: (without tables: the
    general route with bitmask dedup, with enable_inline(): inline rows,
    the general route with beam dedup)."""
    plain, _ = jax_load(str(jax_index[1]))
    inline, _ = jax_load(str(jax_index[1]))
    inline.enable_inline()
    assert inline.adj_pts is not None and inline.level_adj_pts is not None
    return plain, inline


def _run(idx, qs, k, ef, *, sample=0, expand=1):
    """knns as numpy: (dists, ids, visited, steps)."""
    idx.query_entry_sample, idx.query_expand = sample, expand
    r = idx.knns(qs, k, ef)
    return (np.asarray(r.dists), np.asarray(r.ids),
            np.asarray(idx.last_stats["visited_q"]),
            np.asarray(idx.last_stats["steps_q"]))


@pytest.mark.parametrize("case", ["descent", "ef129", "reorder", "expand"])
def test_deferred_paths_raise(port_index, jax_loaded, jax_index, data,
                              case):
    """Paths that once raised now serve, each equal to the JAX route it
    ports: the greedy descent (query_entry_sample=0) before the fused
    kernel; ef > 128 and query_expand=2 on the general route (the port's
    fused table leaves the general route on bitmask dedup, as a JAX index
    without inline rows); the BFS reorder, on fresh loads of the JAX
    file, then the general route with bit-reversed ties."""
    jplain, jinline = jax_loaded
    idx = port_index
    idx.enable_inline()
    assert idx.fused is not None
    if case == "reorder":
        HNSWBuilder(IndexOptions(**{**OPTS, "reorder": True}), device="cpu")
        idx, _ = load_index(str(jax_index[1]), "cpu")
        jre, _ = jax_load(str(jax_index[1]))
        idx.reorder()
        jre.reorder()
        got = _run(idx, data[1], K, EF)
        assert idx.last_route == "general" and idx._tie_bits() > 0
        want = _run(jre, data[1], K, EF)
    elif case == "descent":
        calls = dma_beam_search.plain_calls
        got = _run(idx, data[1], K, EF)
        # kernel #6's plain route ran the descent, one call per level
        assert dma_beam_search.plain_calls == calls + len(idx.levels)
        assert idx.last_route == "fused"
        want = _run(jinline, data[1], K, EF)
    elif case == "ef129":
        got = _run(idx, data[1], K, 129, sample=SAMPLE)
        assert idx.last_route == "general"
        want = _run(jplain, data[1], K, 129, sample=SAMPLE)
    else:
        HNSWBuilder(IndexOptions(**{**OPTS, "expand": 2}), device="cpu")
        got = _run(idx, data[1], K, EF, expand=2)
        idx.query_expand = 1
        assert idx.last_route == "general"
        want = _run(jplain, data[1], K, EF, expand=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_search_one_query(port_index, jax_loaded, data):
    """HNSW.search: one query, the greedy descent, the JAX result."""
    jplain, _ = jax_loaded
    for idx in (port_index, jplain):
        idx.query_entry_sample, idx.query_expand = 0, 1
    got = port_index.search(data[1][3], K, EF)
    want = jplain.search(data[1][3], K, EF)
    assert got.ids.shape == (K,)
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))


@pytest.mark.parametrize("sample", [SAMPLE, 0])
def test_unfusable_index_refuses_queries(data, sample):
    """An adjacency wider than the kernel's 128 lanes gets no fused or mini
    table; enable_inline records the JAX inline rows instead and knns runs
    the general route with beam dedup, equal to the JAX index."""
    pts = data[0][:300]
    adj = np.full((300, 130), -1, np.int32)
    adj[:, 0] = (np.arange(300) + 1) % 300
    adj[:, 1] = (np.arange(300) * 7 + 3) % 300
    deg = (adj >= 0).sum(1).astype(np.int32)
    idx = from_numpy(pts, adj, deg, [], [], 0, 300, IndexOptions(size=300),
                     "cpu")
    idx.enable_inline()
    assert idx.fused is None and idx.mini is None and idx.inline_rows
    jidx = JaxHNSW(jnp.asarray(pts), 300,
                   JaxGraph(jnp.asarray(adj), jnp.asarray(deg)), [], [], 0,
                   "hamming", JaxOptions(size=300))
    jidx.enable_inline()
    assert jidx.adj_pts is not None
    got = _run(idx, data[1], K, EF, sample=sample)
    assert idx.last_route == "general"
    want = _run(jidx, data[1], K, EF, sample=sample)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
