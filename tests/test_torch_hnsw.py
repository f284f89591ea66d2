"""Slice 1 end to end on CPU tensors: the port's host-built HNSW, its
``.npz`` load of a JAX-saved index, its fused ``knns`` and its brute-force
oracle, each bit-exact (tolerance 0) against ``hnsw_itu_tpu`` on the same
numpy inputs."""

import numpy as np
import pytest

from hnsw_itu_tpu.models import Bruteforce as JaxBruteforce
from hnsw_itu_tpu.models import IndexOptions as JaxOptions
from hnsw_itu_tpu.models.hnsw import HNSWBuilder as JaxBuilder
from hnsw_itu_tpu.utils import load_index as jax_load
from hnsw_itu_tpu.utils import save_index as jax_save
from hnsw_itu_tpu.utils.synth import make_dataset as jax_make_dataset
from hnsw_itu_tpu_torch import native
from hnsw_itu_tpu_torch.models import Bruteforce, IndexOptions
from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
from hnsw_itu_tpu_torch.utils import (from_numpy, load_index, make_dataset,
                                      recall_at_k, save_index)

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


def test_deferred_paths_raise(port_index, data):
    idx = port_index
    idx.enable_inline()
    idx.query_entry_sample = 0
    with pytest.raises(NotImplementedError, match="greedy descent"):
        idx.knns(data[1][:4], K, EF)
    idx.query_entry_sample = SAMPLE
    with pytest.raises(NotImplementedError, match="ef > 128"):
        idx.knns(data[1][:4], K, 129)
    b = HNSWBuilder(IndexOptions(**{**OPTS, "host_warmup": N // 2}),
                    device="cpu")
    with pytest.raises(NotImplementedError, match="slice 2"):
        b.extend_batched(data[0])


def test_unfusable_index_refuses_queries(data):
    """An adjacency wider than the kernel's 128 lanes gets no fused table;
    knns then refuses instead of running another algorithm."""
    pts = data[0][:300]
    adj = np.full((300, 130), -1, np.int32)
    adj[:, 0] = (np.arange(300) + 1) % 300
    idx = from_numpy(pts, adj, (adj >= 0).sum(1).astype(np.int32), [], [],
                     0, 300, IndexOptions(size=300), "cpu")
    idx.enable_inline()
    assert idx.fused is None
    idx.query_entry_sample = SAMPLE
    with pytest.raises(NotImplementedError, match="no fused table"):
        idx.knns(data[1][:4], K, EF)
