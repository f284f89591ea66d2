"""The port's Hamming metric, top-k order and sampled entry against
``hnsw_itu_tpu`` on the same numpy inputs, bit-exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_itu_tpu.ops.entry import sampled_entry as jax_sampled_entry
from hnsw_itu_tpu.ops.entry import strided_sample_ids as jax_strided
from hnsw_itu_tpu.ops.metrics import get_metric as jax_get_metric
from hnsw_itu_tpu.ops.topk import merge_min_k as jax_merge_min_k
from hnsw_itu_tpu_torch import native
from hnsw_itu_tpu_torch.ops import entry as port_entry
from hnsw_itu_tpu_torch.ops.entry import sampled_entry, strided_sample_ids
from hnsw_itu_tpu_torch.ops.metrics import (HAMMING, L2, L2INT, as_sketches,
                                            get_metric, popcount,
                                            unpack_bits)
from hnsw_itu_tpu_torch.ops.topk import inverse_permutation, merge_min_k
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

JM = jax_get_metric("hamming")
TM = get_metric("hamming")


def _sketches(rng, n, words=32):
    """Random words, with all-ones, sign-bit-only and zero words mixed in."""
    x = rng.integers(0, 2**32, size=(n, words), dtype=np.uint32)
    x[0, :] = 0xFFFFFFFF
    x[1, ::2] = 0x80000000
    x[2, :] = 0
    return x


def test_popcount_matches_numpy():
    rng = np.random.default_rng(0)
    x = _sketches(rng, 64)
    want = np.unpackbits(x.view(np.uint8), axis=-1).reshape(64, 32, 32).sum(-1)
    np.testing.assert_array_equal(popcount(as_sketches(x, "cpu")).numpy(), want)


def test_native_hamming_matches_one_to_many():
    rng = np.random.default_rng(6)
    a, b = _sketches(rng, 6), _sketches(rng, 6)
    got = TM.one_to_many(as_sketches(a[0], "cpu"), as_sketches(b, "cpu"))
    assert got.tolist() == [native.hamming(a[0], row) for row in b]


def test_unpack_bits_order():
    rng = np.random.default_rng(1)
    x = _sketches(rng, 8, 4)
    got = unpack_bits(as_sketches(x, "cpu")).numpy()
    want = ((x[..., None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(8, -1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["one_to_many", "pairwise", "pairwise_mxu"])
def test_hamming_matches_jax(fn):
    rng = np.random.default_rng(2)
    a, b = _sketches(rng, 24), _sketches(rng, 40)
    ta, tb = as_sketches(a, "cpu"), as_sketches(b, "cpu")
    if fn == "one_to_many":
        got = TM.one_to_many(ta[5], tb)
        want = JM.one_to_many(jnp.asarray(a[5]), jnp.asarray(b))
    else:
        got = getattr(TM, fn)(ta, tb)
        want = getattr(JM, fn)(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_strided_sample_ids_match_jax():
    for n, s in ((100, 64), (5000, 1024), (7, 7), (1000, 3)):
        np.testing.assert_array_equal(strided_sample_ids(n, s,
                                                         device="cpu").numpy(),
                                      np.asarray(jax_strided(n, s)))


def test_sampled_entry_matches_jax_with_ties():
    """Several sample positions hold the same sketch: the entry is the
    lowest sample position, as jnp.argmin picks it."""
    rng = np.random.default_rng(3)
    n, S = 512, 64
    pts = _sketches(rng, n)
    ids = np.asarray(jax_strided(n, S))
    pts[ids[[5, 9, 40]]] = pts[ids[40]]  # a three-way tie in the sample
    qs = np.concatenate([pts[ids[[40, 9]]], _sketches(rng, 30)])
    got = sampled_entry(as_sketches(pts, "cpu"), as_sketches(qs, "cpu"), n,
                        sample_size=S, metric=TM)
    want = jax_sampled_entry(jnp.asarray(pts), jnp.asarray(qs), n,
                             sample_size=S, metric=JM)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0] == got[1] == ids[5]


class _Points:
    """Stands in for a points tensor on a device this machine may lack:
    ``kernel_route`` reads only the device and the shape."""

    def __init__(self, device, words):
        self.device, self.shape = torch.device(device), (100, words)


@pytest.mark.parametrize("metric,device,words,kernel", [
    (HAMMING, "cuda", 32, True), (HAMMING, "cuda", 1, True),
    (HAMMING, "cuda", 64, True), (HAMMING, "cuda", 65, True),
    (HAMMING, "cpu", 32, False), (HAMMING, "meta", 32, False),
    (L2, "cuda", 32, False), (L2INT, "cuda", 3, False)])
def test_sampled_entry_routes_by_its_inputs(metric, device, words, kernel):
    """The kernel for Hamming sketches on a card at any width (past 64
    words it raises there, as the next test shows); the plain version
    (``pairwise_mxu`` blocks) for CPU tensors and the other metrics."""
    assert port_entry.kernel_route(_Points(device, words), metric) is kernel


def test_sampled_entry_past_64_words_raises_on_the_kernel_route(
        monkeypatch):
    """Sketches wider than the kernel's on the kernel route raise before
    any launch and take no plain route (meta tensors stand in for the
    card's; ``kernel_route`` is made to say card)."""
    monkeypatch.setattr(port_entry, "kernel_route", lambda *a: True)
    before = (sampled_entry.kernel_launches, sampled_entry.plain_calls)
    with pytest.raises(ValueError, match="words=65"):
        sampled_entry(_meta((1000, 65)), _meta((64, 65)), 1000,
                      sample_size=1024, metric=HAMMING)
    assert (sampled_entry.kernel_launches, sampled_entry.plain_calls) == \
        before


def test_sampled_entry_on_cpu_takes_the_plain_version():
    rng = np.random.default_rng(11)
    pts, qs = _sketches(rng, 700), _sketches(rng, 40)
    p, q = as_sketches(pts, "cpu"), as_sketches(qs, "cpu")
    before = (sampled_entry.kernel_launches, sampled_entry.plain_calls)
    got = sampled_entry(p, q, 700, sample_size=96, metric=TM)
    assert (sampled_entry.kernel_launches, sampled_entry.plain_calls) == \
        (before[0], before[1] + 1)
    assert torch.equal(got, port_entry.sampled_entry_plain(
        p, q, 700, sample_size=96, metric=TM))
    ids = strided_sample_ids(700, 96, device="cpu")
    want = ids[torch.argmin(TM.pairwise(q, p[ids.long()]), dim=1)]
    assert torch.equal(got, want)


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,err", [
    ("int64 points", TypeError), ("int64 queries", TypeError),
    ("non-contiguous points", ValueError),
    ("non-contiguous queries", ValueError), ("65 words", ValueError),
    ("0 words", ValueError), ("words differ", ValueError),
    ("devices differ", ValueError), ("n 0", ValueError),
    ("n past the rows", ValueError), ("sample 0", ValueError),
    ("sample past 2^30", ValueError)])
def test_sampled_entry_kernel_checks_before_any_launch(case, err):
    """What the kernel does not take raises in ``_check_launch`` (meta
    tensors: nothing is allocated or launched)."""
    p, q, n, S = _meta((1000, 32)), _meta((64, 32)), 1000, 1024
    if case == "int64 points":
        p = _meta((1000, 32), torch.int64)
    elif case == "int64 queries":
        q = _meta((64, 32), torch.int64)
    elif case == "non-contiguous points":
        p = _meta((32, 1000)).t()
    elif case == "non-contiguous queries":
        q = _meta((64, 64))[:, ::2]
    elif case == "65 words":
        p, q = _meta((1000, 65)), _meta((64, 65))
    elif case == "0 words":
        p, q = _meta((1000, 0)), _meta((64, 0))
    elif case == "words differ":
        q = _meta((64, 31))
    elif case == "devices differ":
        q = torch.zeros((64, 32), dtype=torch.int32)
    elif case == "n 0":
        n = 0
    elif case == "n past the rows":
        n = 1001
    elif case == "sample 0":
        S = 0
    else:
        S = port_entry.MAX_SAMPLE + 1
    port_entry._check_launch(_meta((1000, 32)), _meta((64, 32)), 1000, 1024)
    with pytest.raises(err):
        port_entry._check_launch(p, q, n, S)


@pytest.mark.parametrize("metric", [L2, L2INT])
def test_other_metrics_keep_pairwise_mxu(metric, monkeypatch):
    """``l2`` and ``l2int`` entries run ``metric.pairwise_mxu`` blocks and
    count a plain call, never a kernel launch."""
    rng = np.random.default_rng(12)
    dtype = np.float32 if metric is L2 else np.int32
    pts = rng.integers(-20, 20, size=(500, 6)).astype(dtype)
    p = torch.from_numpy(pts)
    q = p[::7].contiguous()
    calls = []
    real = type(metric).pairwise_mxu

    def counted(self, a, b):
        calls.append(a.shape[0])
        return real(self, a, b)

    monkeypatch.setattr(type(metric), "pairwise_mxu", counted)
    before = (sampled_entry.kernel_launches, sampled_entry.plain_calls)
    got = sampled_entry(p, q, 500, sample_size=64, metric=metric)
    assert calls == [q.shape[0]]
    assert (sampled_entry.kernel_launches, sampled_entry.plain_calls) == \
        (before[0], before[1] + 1)
    ids = strided_sample_ids(500, 64, device="cpu")
    want = ids[torch.argmin(metric.pairwise(q, p[ids.long()]), dim=1)]
    assert torch.equal(got, want)


def _packed_key_entry(d: torch.Tensor) -> torch.Tensor:
    """A model of the kernel's argmin (csrc/sampled_entry.cu): each
    distance d at sample position pos as the 64-bit key (d << 32) | pos,
    the least key of each row, its position."""
    pos = torch.arange(d.shape[1], dtype=torch.int64)
    keys = (d.long() << 32) | pos
    return keys.min(dim=1).values & 0xFFFFFFFF


@pytest.mark.parametrize("S,words", [(1, 32), (7, 1), (1024, 32),
                                     (1025, 8), (65_536, 64)])
def test_packed_key_rule_takes_the_lowest_position(S, words):
    """The least packed key is the least distance and, among equal
    distances, the lowest sample position: torch.argmin's rule, which the
    plain version follows."""
    rng = np.random.default_rng(S + words)
    d = torch.from_numpy(rng.integers(0, 5, size=(64, S)).astype(np.int32))
    d[0] = 2  # one distance throughout: position 0
    d[1] = d[1].clamp(min=1)
    d[1, -1] = d[1, S // 2] = 0  # two minima, the later one last
    d = d * (32 * words // 4)  # up to the largest distance of the width
    got = _packed_key_entry(d)
    assert torch.equal(got, torch.argmin(d, dim=1))
    assert int(got[0]) == 0
    assert int(got[1]) == (S // 2 if S > 1 else 0)


def test_knns_on_cpu_launches_no_entry_kernel():
    """A CPU index's knns with an entry sample runs the plain entry once
    a query batch and never the kernel."""
    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
    from hnsw_itu_tpu_torch.utils import make_dataset

    pts, qs = make_dataset(5, 600, 40)
    b = HNSWBuilder(IndexOptions(ef_construction=24, connections=6,
                                 max_connections=16, size=600,
                                 batch_size=64, host_warmup=600),
                    device="cpu")
    b.extend_batched(pts)
    idx = b.build()
    idx.query_entry_sample, idx.query_batch = 64, 16
    before = (sampled_entry.kernel_launches, sampled_entry.plain_calls)
    res = idx.knns(qs, 10, 32)
    assert res.ids.shape == (40, 10)
    assert (sampled_entry.kernel_launches, sampled_entry.plain_calls) == \
        (before[0], before[1] + 3)  # 40 queries in batches of 16


def test_merge_min_k_matches_jax():
    rng = np.random.default_rng(4)
    d = rng.integers(0, 6, size=(5, 2, 12)).astype(np.int32)  # many ties
    i = rng.permutation(5 * 2 * 12).reshape(5, 2, 12).astype(np.int32)
    got = merge_min_k(*(torch.from_numpy(x) for x in
                        (d[:, 0], i[:, 0], d[:, 1], i[:, 1])), 9)
    want = jax_merge_min_k(*(jnp.asarray(x) for x in
                             (d[:, 0], i[:, 0], d[:, 1], i[:, 1])), 9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_inverse_permutation():
    order = torch.from_numpy(np.random.default_rng(5).permutation(50))
    inv = inverse_permutation(order)
    assert (order[inv] == torch.arange(50)).all()


def test_unported_metrics_raise():
    """Every JAX metric is ported now; an unknown name raises as in JAX."""
    assert get_metric("l2int").name == "l2int"
    assert get_metric("l2").dist_dtype == torch.float32
    with pytest.raises(ValueError, match="unknown metric 'cosine'"):
        get_metric("cosine")
    with pytest.raises(ValueError, match="unknown metric 'cosine'"):
        jax_get_metric("cosine")


def _l2int_points(rng, n, dim=7):
    """int32 coordinates with a few huge ones, whose squares wrap int32
    in both packages."""
    x = rng.integers(-300, 300, size=(n, dim), dtype=np.int32)
    x[0, 0] = 2**31 - 1
    x[1, 1] = -(2**31)
    x[2, :] = 50_000
    return x


@pytest.mark.parametrize("fn", ["one_to_many", "pairwise", "pairwise_mxu"])
def test_l2int_matches_jax(fn):
    rng = np.random.default_rng(7)
    a, b = _l2int_points(rng, 24), _l2int_points(rng, 40)
    pm, jm = get_metric("l2int"), jax_get_metric("l2int")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if fn == "one_to_many":
        got = pm.one_to_many(ta[5], tb)
        want = jm.one_to_many(jnp.asarray(a[5]), jnp.asarray(b))
    else:
        got = getattr(pm, fn)(ta, tb)
        want = getattr(jm, fn)(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fn", ["one_to_many", "pairwise", "pairwise_mxu"])
def test_l2_matches_jax(fn):
    rng = np.random.default_rng(8)
    a = rng.normal(size=(24, 48)).astype(np.float32)
    b = rng.normal(size=(40, 48)).astype(np.float32)
    b[3] = a[4]  # a zero distance: the norm expansion clamps at 0
    pm, jm = get_metric("l2"), jax_get_metric("l2")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if fn == "one_to_many":
        got = pm.one_to_many(ta[5], tb)
        want = jm.one_to_many(jnp.asarray(a[5]), jnp.asarray(b))
    else:
        got = getattr(pm, fn)(ta, tb)
        want = getattr(jm, fn)(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.float32 and pm.inf == float("inf")
    assert (got >= 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_batched_blocks_match_per_row():
    """The leading axes of the port's distance blocks (the build's select
    blocks) give the rows' own blocks, for both new metrics."""
    rng = np.random.default_rng(9)
    for name, x in (("l2int", _l2int_points(rng, 3 * 12)),
                    ("l2", rng.normal(size=(36, 16)).astype(np.float32))):
        m = get_metric(name)
        t = torch.from_numpy(x).reshape(3, 12, -1)
        got = m.pairwise_block(t, t)
        for r in range(3):
            np.testing.assert_array_equal(got[r].numpy(),
                                          m.pairwise_mxu(t[r], t[r]).numpy())


def test_sketches_u64_match_jax_and_round_trip():
    from hnsw_itu_tpu.ops.metrics import sketches_from_u64 as jax_from
    from hnsw_itu_tpu.ops.metrics import sketches_to_u64 as jax_to
    from hnsw_itu_tpu_torch.ops.metrics import (sketches_from_u64,
                                                sketches_to_u64)

    rng = np.random.default_rng(10)
    rows = rng.integers(0, 2**64, size=(9, 16), dtype=np.uint64)
    rows[0] = 2**64 - 1
    got = sketches_from_u64(rows)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), jax_from(rows))
    np.testing.assert_array_equal(sketches_to_u64(got), rows)
    np.testing.assert_array_equal(sketches_to_u64(got.view(np.uint32)),
                                  jax_to(jax_from(rows)))
    with pytest.raises(ValueError, match="32 uint32 words"):
        sketches_from_u64(rows[:, :8])


def test_register_metric_mirrors_jax():
    """Duplicates, junk and overwrite, as tests/test_register_metric.py
    holds the JAX registry to."""
    import hnsw_itu_tpu_torch.ops.metrics as mod
    from hnsw_itu_tpu_torch import Metric, register_metric

    class _L1(Metric):
        def __init__(self):
            super().__init__(name="l1-registry-test")

        def one_to_many(self, q, pts):
            return (pts - q.unsqueeze(-2)).abs().sum(dim=-1,
                                                     dtype=torch.int32)

    try:
        m = register_metric(_L1())
        assert get_metric("l1-registry-test") is m
        with pytest.raises(ValueError, match="already registered"):
            register_metric(_L1())
        with pytest.raises(TypeError):
            register_metric(object())
        with pytest.raises(ValueError, match="non-empty"):
            register_metric(Metric(""))
        m2 = register_metric(_L1(), overwrite=True)  # rebinds the name
        assert get_metric("l1-registry-test") is m2 is not m
        a = torch.tensor([[0, 0], [3, -4]], dtype=torch.int32)
        assert m2.pairwise(a, a).tolist() == [[0, 7], [7, 0]]
    finally:
        mod._REGISTRY.pop("l1-registry-test", None)
