"""Builds, queries and the oracle of the port on the metrics past Hamming,
against the JAX package on CPU tensors.

* ``l2int`` (int32 squared L2): bit-exact (tolerance 0), both through the
  native host warmup and through the device chunks; the JAX builder runs
  its gather route (``HNSW_TPU_INLINE_BUILD_BYTES=0``).
* ``l2`` (float32 squared L2): the same graph (every level's adj and deg)
  and the same ``knns`` ids as JAX; XLA and PyTorch sum float32 products
  in different orders, so returned distances may differ in their last
  bits (``rtol=1e-5``). Recall@10 within 0.01 of the JAX index's on the
  same data, and returned distances within ``rtol=1e-5`` of the exact
  ones.
* A registered custom metric (Chebyshev) end to end, through ``.npz``.
* The oracle: ``l2int`` exact against JAX; ``l2`` distances within
  ``rtol=1e-5`` and ids equal where the row's k-th distance is not tied;
  the tiled Hamming scan equal to the native host scan, the route the JAX
  oracle takes past 2M points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hnsw_itu_tpu.ops.metrics as jax_metrics_mod
import hnsw_itu_tpu_torch.ops.metrics as metrics_mod
from hnsw_itu_tpu import Metric as JaxMetric
from hnsw_itu_tpu import register_metric as jax_register
from hnsw_itu_tpu.models import Bruteforce as JaxBruteforce
from hnsw_itu_tpu.models import IndexOptions as JaxOptions
from hnsw_itu_tpu.models.hnsw import HNSWBuilder as JaxHNSWBuilder
from hnsw_itu_tpu_torch import Metric, native, register_metric
from hnsw_itu_tpu_torch.models import Bruteforce, IndexOptions
from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
from hnsw_itu_tpu_torch.models.nsw import NSWBuilder
from hnsw_itu_tpu_torch.utils import (load_index, make_dataset, recall_at_k,
                                      save_index)
from test_torch_build import assert_same_builder, gather_route
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

N, NQ, K, EF = 600, 24, 10, 32
OPTS = dict(ef_construction=48, connections=12, max_connections=24, size=N,
            batch_size=16, entry_sample=64)
RTOL = 1e-5


def _l2int_data(seed):
    """Small integer coordinates: many equal distances, so ties are
    exercised."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(-20, 20, size=(N, 6), dtype=np.int32)
    qs = rng.integers(-20, 20, size=(NQ, 6), dtype=np.int32)
    return pts, qs


def _l2_data(seed, dim=16):
    """Clustered unit-norm float32 vectors."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, dim))
    pts = centers[rng.integers(0, 12, N)] + 0.3 * rng.normal(size=(N, dim))
    qs = centers[rng.integers(0, 12, NQ)] + 0.3 * rng.normal(size=(NQ, dim))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    return pts.astype(np.float32), qs.astype(np.float32)


def _build_both(pts, metric, **kw):
    opts = {**OPTS, **kw}
    with gather_route():
        jb = JaxHNSWBuilder(JaxOptions(**opts), metric=metric)
        jb.extend_batched(pts)
        jidx = jb.build()
    pb = HNSWBuilder(IndexOptions(**opts), metric, device="cpu")
    pb.extend_batched(pts)
    return jb, jidx, pb, pb.build()


def _knns(idx, qs, k=K, ef=EF):
    r = idx.knns(qs, k, ef)
    return np.asarray(r.dists), np.asarray(r.ids)


@pytest.mark.parametrize("warmup", [200, 0], ids=["host_warmup", "device"])
def test_l2int_hnsw_matches_jax(warmup):
    """Graph, level sizes, entry point, edge drops, then knns dists and
    ids (the greedy descent on the general route), all equal."""
    pts, qs = _l2int_data(3)
    jb, jidx, pb, pidx = _build_both(pts, "l2int", host_warmup=warmup)
    assert_same_builder(pb, jb)
    assert pidx.points.dtype == torch.int32
    pidx.enable_inline()
    assert pidx.fused is None and pidx.mini is None
    for ef in (EF, 64):
        got, want = _knns(pidx, qs, ef=ef), _knns(jidx, qs, ef=ef)
        assert pidx.last_route == "general"
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_l2int_sampled_entry_matches_jax():
    pts, qs = _l2int_data(4)
    _, jidx, _, pidx = _build_both(pts, "l2int", host_warmup=0)
    pidx.query_entry_sample = jidx.query_entry_sample = 64
    for g, w in zip(_knns(pidx, qs), _knns(jidx, qs)):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def l2_built():
    """One ``l2`` build of each package on the same data: (pts, qs, JAX
    builder, JAX index, port builder, port index)."""
    pts, qs = _l2_data(5)
    return (pts, qs, *_build_both(pts, "l2", host_warmup=0))


def test_l2_hnsw_graph_matches_jax(l2_built):
    """Both packages prune ``l2`` rows on the direct difference and select
    on the norm expansion, so the graphs are equal: every level's adj and
    deg, entry point, level sizes, spill and edge drops. ``knns`` returns
    the same ids; its distances, summed over D in XLA's order and in
    PyTorch's, within ``RTOL``."""
    _, qs, jb, jidx, pb, pidx = l2_built
    assert_same_builder(pb, jb)
    (pd, pi), (jd, ji) = _knns(pidx, qs), _knns(jidx, qs)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=RTOL, atol=1e-6)


def test_l2_hnsw_is_recall_equal_to_jax(l2_built):
    """Recall within 0.01 of the JAX index's and exact distances."""
    pts, qs, _, jidx, pb, pidx = l2_built
    assert pidx.points.dtype == torch.float32
    bf = Bruteforce("l2", device="cpu")
    bf.extend(pts)
    gt = bf.build().knns(qs, K).ids.numpy()
    pd, pi = _knns(pidx, qs)
    _, ji = _knns(jidx, qs)
    rp, rj = recall_at_k(pi, gt, K), recall_at_k(ji, gt, K)
    assert rp >= 0.9 and abs(rp - rj) <= 0.01, (rp, rj)
    exact = ((pts[pi] - qs[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(pd, exact, rtol=RTOL, atol=1e-6)
    assert pb.n == N and sum(pb.level_ns) > 0


def test_host_warmup_runs_for_native_metrics_only():
    """The native engine has Hamming and l2int: an l2 builder skips the
    warmup (as the JAX builder does) and builds on the general search,
    never reaching kernel #6."""
    from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search

    ipts, _ = _l2int_data(6)
    fpts, _ = _l2_data(6)
    opts = IndexOptions(**{**OPTS, "host_warmup": 100})
    assert HNSWBuilder(opts, "l2int", device="cpu")._host_warmup(ipts) == 100
    b = HNSWBuilder(opts, "l2", device="cpu")
    assert b._host_warmup(fpts) == 0
    calls = dma_beam_search.plain_calls
    b.extend_batched(fpts[:200])
    assert b.n == 200 and dma_beam_search.plain_calls == calls


class _Chebyshev(Metric):
    def __init__(self, name="chebyshev-torch-test"):
        super().__init__(name=name)

    def one_to_many(self, q, pts):
        return (pts.to(torch.int32) - q.to(torch.int32).unsqueeze(-2)) \
            .abs().amax(dim=-1)


class _JaxChebyshev(JaxMetric):
    def __init__(self, name="chebyshev-torch-test"):
        super().__init__(name=name)

    def one_to_many(self, q, pts):
        return jnp.max(jnp.abs(pts.astype(jnp.int32) - q.astype(jnp.int32)),
                       axis=-1)


@pytest.fixture
def chebyshev():
    m = register_metric(_Chebyshev(), overwrite=True)
    jm = jax_register(_JaxChebyshev(), overwrite=True)
    yield m
    metrics_mod._REGISTRY.pop(m.name, None)
    jax_metrics_mod._REGISTRY.pop(jm.name, None)


def test_custom_metric_end_to_end(chebyshev, tmp_path):
    """A registered metric builds (device chunks), queries, serves the
    oracle and round-trips through ``save_index``/``load_index``, and
    equals the JAX package on the same registered metric."""
    rng = np.random.default_rng(2)
    pts = rng.integers(-100, 100, size=(400, 6), dtype=np.int32)
    qs = rng.integers(-100, 100, size=(8, 6), dtype=np.int32)
    opts = dict(host_warmup=0, ef_construction=32, connections=8,
                max_connections=16, size=len(pts))
    bf = Bruteforce(chebyshev.name, device="cpu")
    bf.extend(pts)
    gt = bf.build().knns(qs, 5)
    d0 = np.max(np.abs(pts[None, :, :] - qs[:, None, :]), axis=-1)
    np.testing.assert_array_equal(gt.dists.numpy(),
                                  np.sort(d0, axis=1)[:, :5])
    b = NSWBuilder(IndexOptions(**opts), chebyshev.name, device="cpu")
    b.extend_batched(pts)
    idx = b.build()
    r = idx.knns(qs, 5, 48)
    assert recall_at_k(r.ids.numpy(), gt.ids.numpy(), 5) >= 0.8
    from hnsw_itu_tpu.models.nsw import NSWBuilder as JaxNSWBuilder

    with gather_route():
        jb = JaxNSWBuilder(JaxOptions(**opts), metric=chebyshev.name)
        jb.extend_batched(pts)
    np.testing.assert_array_equal(b.graph.adj.numpy(),
                                  np.asarray(jb.graph.adj))
    p = tmp_path / "idx.npz"
    save_index(str(p), idx)
    idx2, _ = load_index(str(p), "cpu")
    assert idx2.metric is chebyshev
    r2 = idx2.knns(qs, 5, 48)
    np.testing.assert_array_equal(r.ids.numpy(), r2.ids.numpy())
    np.testing.assert_array_equal(r.dists.numpy(), r2.dists.numpy())


def test_bruteforce_l2int_matches_jax():
    pts, qs = _l2int_data(7)
    got = Bruteforce("l2int", tile=256, device="cpu")
    got.extend(pts)
    want = JaxBruteforce("l2int", tile=256)
    want.extend(pts)
    g, w = got.build().knns(qs, K), want.build().knns(qs, K)
    np.testing.assert_array_equal(g.dists.numpy(), np.asarray(w.dists))
    np.testing.assert_array_equal(g.ids.numpy(), np.asarray(w.ids))


def test_bruteforce_l2_matches_jax():
    pts, qs = _l2_data(8, dim=24)
    got = Bruteforce("l2", tile=256, device="cpu")
    got.extend(pts)
    want = JaxBruteforce("l2", tile=256)
    want.extend(pts)
    g, w = got.build().knns(qs, K), want.build().knns(qs, K + 1)
    gd, wd = g.dists.numpy(), np.asarray(w.dists)
    assert g.dists.dtype == torch.float32
    np.testing.assert_allclose(gd, wd[:, :K], rtol=RTOL, atol=1e-6)
    # ids agree wherever a row's k-th distance is clear of its neighbors
    # in the order (the JAX scan's k+1-th tells the boundary)
    gap = np.diff(wd, axis=1)
    untied = np.ones((NQ, K), bool)
    untied[:, :-1] &= gap[:, :-1] > 1e-5 * wd[:, 1:K]
    untied[:, 1:] &= gap[:, : K - 1] > 1e-5 * wd[:, 1:K]
    untied[:, -1] &= gap[:, K - 1] > 1e-5 * wd[:, K]
    assert untied.mean() > 0.5
    np.testing.assert_array_equal(g.ids.numpy()[untied],
                                  np.asarray(w.ids)[:, :K][untied])


def test_tiled_hamming_oracle_matches_host_scan():
    """The JAX oracle's route past 2M points (``native.host_bruteforce``)
    against the port's tiled scan, which unpacks each tile in the loop:
    dists equal, ids in (d, id) order."""
    pts, qs = make_dataset(9, 3000, 40)
    bf = Bruteforce("hamming", tile=512, device="cpu")
    bf.extend(pts)
    got = bf.build().knns(qs, K)
    hd, hi = native.host_bruteforce(np.ascontiguousarray(pts), "hamming",
                                    qs, K)
    np.testing.assert_array_equal(got.dists.numpy(), hd)
    o = np.lexsort((hi, hd), axis=-1)
    np.testing.assert_array_equal(got.ids.numpy(),
                                  np.take_along_axis(hi, o, axis=-1))
