"""The port's fused beam search against the JAX package's packed XLA beam
search (``batched_beam_search(dedup="beam")``): the plain PyTorch version
on CPU tensors, bit-exact (tolerance 0) in distances, ids, visited and
steps. The CUDA kernel is held against the plain version on the card in
tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_itu_tpu.ops.metrics import get_metric
from hnsw_itu_tpu.ops.search import batched_beam_search
from hnsw_itu_tpu_torch.ops.fused_search import (fused_beam_search,
                                                 fused_width, key_clamp,
                                                 materialize_fused)
from hnsw_itu_tpu_torch.ops.metrics import as_sketches
from hnsw_itu_tpu_torch.ops.search import beam_search_packed
from test_torch_kernels import PAIRS, fused_inputs, random_graph

INT32_MAX = np.iinfo(np.int32).max


def _decode(keys, id_bits, max_d):
    kinf = (max_d + 1) << id_bits
    keys = np.asarray(keys)
    d = np.where(keys < kinf, keys >> id_bits, INT32_MAX)
    i = np.where(keys < kinf, keys & ((1 << id_bits) - 1), INT32_MAX)
    return d, i


def _reference(pts, adj, qs, ef, cap):
    pts_j = jnp.asarray(pts)
    return batched_beam_search(
        lambda ids: pts_j[ids], jnp.asarray(adj), jnp.asarray(qs),
        jnp.zeros((qs.shape[0],), jnp.int32), ef=ef,
        metric=get_metric("hamming"), capacity=cap, expand=1,
        max_steps=256, dedup="beam",
    )


def _port(pts, adj, qs, id_bits, max_d):
    return fused_inputs(pts, adj, qs, id_bits, max_d, "cpu")


@pytest.mark.parametrize("w,ef", PAIRS)
def test_plain_matches_xla_packed(w, ef):
    cap, words, B = 256, 32, 32
    rng = np.random.default_rng(w * 1000 + ef)
    pts, adj = random_graph(rng, cap, w, words)
    qs = rng.integers(0, 2**32, size=(B, words), dtype=np.uint32)
    max_d, id_bits = words * 32, max(1, (cap - 1).bit_length())
    ref = _reference(pts, adj, qs, ef, cap)

    table, q, init = _port(pts, adj, qs, id_bits, max_d)
    calls = fused_beam_search.plain_calls
    keys, vis, stp = fused_beam_search(table, q, init, ef=ef,
                                       id_bits=id_bits, max_d=max_d,
                                       max_steps=256)
    assert fused_beam_search.plain_calls == calls + 1
    got_d, got_i = _decode(keys, id_bits, max_d)
    np.testing.assert_array_equal(got_d, np.asarray(ref.dists))
    np.testing.assert_array_equal(got_i, np.asarray(ref.ids))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(ref.visited))
    np.testing.assert_array_equal(stp.numpy(), np.asarray(ref.steps))


def test_plain_dedups_repeated_neighbors():
    """Rows that list a neighbor twice: the second copy is a duplicate, not
    a fresh visit, exactly as in the XLA merge."""
    cap, words, B, w, ef = 128, 32, 16, 32, 24
    rng = np.random.default_rng(5)
    pts, adj = random_graph(rng, cap, w, words)
    adj[:, w // 2 :] = adj[:, : w // 2]  # every row repeats its first half
    qs = rng.integers(0, 2**32, size=(B, words), dtype=np.uint32)
    max_d, id_bits = words * 32, max(1, (cap - 1).bit_length())
    ref = _reference(pts, adj, qs, ef, cap)
    table, q, init = _port(pts, adj, qs, id_bits, max_d)
    keys, vis, stp = beam_search_packed(table.ids, table.data, q, init,
                                        ef=ef, id_bits=id_bits, max_d=max_d,
                                        max_steps=256)
    got_d, got_i = _decode(keys, id_bits, max_d)
    np.testing.assert_array_equal(got_d, np.asarray(ref.dists))
    np.testing.assert_array_equal(got_i, np.asarray(ref.ids))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(ref.visited))
    np.testing.assert_array_equal(stp.numpy(), np.asarray(ref.steps))


def _clamped_case():
    cap, w, words, B, ef = 256, 16, 32, 32, 24
    id_bits = 25  # dist bits = 6 -> clamp = 62
    rng = np.random.default_rng(9)
    base = rng.integers(0, 2**32, size=(words,), dtype=np.uint32)
    flips = np.packbits(
        rng.random((cap, words * 32)) < 0.02, axis=-1
    ).view(np.uint32)  # ~20 bit flips -> pairwise distances <= ~45 < 62
    pts = base[None] ^ flips
    adj = np.full((cap, w), -1, np.int32)
    for i in range(cap):
        adj[i] = rng.choice(cap, size=w, replace=False)
    qs = pts[rng.integers(0, cap, size=B)]
    return pts, adj, qs, cap, ef, id_bits, words * 32


def test_plain_clamped_keys():
    """id_bits past the raw-bound limit: distances are clamped into the
    key, and the search still matches the XLA path on low-diameter data."""
    pts, adj, qs, cap, ef, id_bits, raw_max = _clamped_case()
    max_d = key_clamp(id_bits, raw_max)
    assert max_d == 62
    ref = _reference(pts, adj, qs, ef, cap)
    table, q, init = _port(pts, adj, qs, id_bits, raw_max)
    keys, _, _ = fused_beam_search(table, q, init, ef=ef, id_bits=id_bits,
                                   max_d=raw_max, max_steps=256)
    got_d, got_i = _decode(keys, id_bits, max_d)
    np.testing.assert_array_equal(got_d, np.asarray(ref.dists))
    np.testing.assert_array_equal(got_i, np.asarray(ref.ids))


def test_fused_table_layout():
    rng = np.random.default_rng(3)
    cap, w, words = 64, 24, 32
    pts, adj = random_graph(rng, cap, w, words)
    adj[5, 3] = -1
    ft = materialize_fused(as_sketches(pts, "cpu"), torch.from_numpy(adj),
                           tile=16)
    ids, data = ft.ids.numpy(), ft.data.numpy().view(np.uint32)
    W = fused_width(w)
    assert W == 32 and ft.width == W and ft.cap == cap
    assert ids.shape == (cap, W) and data.shape == (cap, W, words)
    np.testing.assert_array_equal(ids[:, :w], adj)
    assert (ids[:, w:] == -1).all()
    # neighbor j's whole sketch, contiguous; zero for absent edges and pad
    want = np.where((adj >= 0)[..., None], pts[np.clip(adj, 0, cap - 1)], 0)
    np.testing.assert_array_equal(data[:, :w], want)
    assert (data[:, w:] == 0).all()
    assert (data[5, 3] == 0).all()


def test_fused_rejects_bad_inputs():
    rng = np.random.default_rng(1)
    pts, adj = random_graph(rng, 16, 8, 32)
    table = materialize_fused(as_sketches(pts, "cpu"), torch.from_numpy(adj))
    q = as_sketches(pts[:2], "cpu")
    init = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_beam_search(table, q, init, ef=129, id_bits=4, max_d=1024)
    with pytest.raises(TypeError):
        fused_beam_search(table, q.long(), init, ef=8, id_bits=4, max_d=1024)
    with pytest.raises(ValueError):
        fused_beam_search(table, q, init, ef=8, id_bits=3, max_d=1024)

