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
from hnsw_itu_tpu_torch.ops.entry import sampled_entry, strided_sample_ids
from hnsw_itu_tpu_torch.ops.metrics import (as_sketches, get_metric,
                                            popcount, unpack_bits)
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
    with pytest.raises(NotImplementedError):
        get_metric("l2int")
    with pytest.raises(ValueError):
        get_metric("cosine")
