"""The port's two build kernels' plain versions against the JAX package on
CPU tensors, bit-exact (tolerance 0): the dense Hamming block (2-D and
batched) against the JAX Pallas ``hamming_block_padded`` in interpret mode
and ``Hamming.pairwise``; the gather beam search against the XLA two-key
beam (``batched_beam_search(..., dedup="beam", expand=1)``) on d, ids,
visited and steps, and against the JAX Pallas ``dma_beam_search`` in
interpret mode. The CUDA kernels are held against these plain versions on
the card in tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_itu_tpu.ops import HAMMING as JAX_HAMMING
from hnsw_itu_tpu.ops import pallas_dma_search as jdma
from hnsw_itu_tpu.ops.metrics import get_metric as jax_metric
from hnsw_itu_tpu.ops.pallas_hamming import hamming_block_padded
from hnsw_itu_tpu.ops.search import batched_beam_search
from hnsw_itu_tpu_torch.ops import hamming as hamming_mod
from hnsw_itu_tpu_torch.ops.dma_search import (dma_beam_search,
                                               dma_beam_search_plain)
from hnsw_itu_tpu_torch.ops.hamming import hamming_block, hamming_block_plain
from hnsw_itu_tpu_torch.ops.metrics import HAMMING, as_sketches
from hnsw_itu_tpu_torch.ops.mini_search import DINF, IINF, split_keys
from test_torch_kernels import gather_inputs, random_graph
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

INT32_MAX = np.iinfo(np.int32).max


def _sketches(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


@pytest.mark.parametrize("m,n,words", [(130, 70, 32), (1, 129, 32),
                                       (96, 96, 32), (33, 5, 7)])
def test_hamming_block_matches_pallas(m, n, words):
    """Sizes that are not multiples of the TPU kernel's 128 tiles."""
    rng = np.random.default_rng(m * n + words)
    a, b = _sketches(rng, m, words), _sketches(rng, n, words)
    calls = hamming_block.plain_calls
    got = hamming_block(as_sketches(a, "cpu"), as_sketches(b, "cpu"))
    assert hamming_block.plain_calls == calls + 1
    want = np.asarray(hamming_block_padded(jnp.asarray(a), jnp.asarray(b),
                                           interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JAX_HAMMING.pairwise(a, b)))


@pytest.mark.parametrize("m,n,words", [(95, 97, 1), (97, 95, 31),
                                       (96, 96, 33), (40, 264, 64)])
def test_hamming_identity_matches_pallas_at_edge_words(m, n, words):
    """The identity the CUDA kernel computes, popc(a) + popc(b) - 2 <bits
    of a, bits of b> (``Hamming.pairwise_mxu``), and the plain version
    equal the Pallas kernel at word counts that are not a multiple of its
    8-word k slices (1, 31, 33) and at the widest sketch (64)."""
    rng = np.random.default_rng(m + n + words)
    a, b = _sketches(rng, m, words), _sketches(rng, n, words)
    want = np.asarray(hamming_block_padded(jnp.asarray(a), jnp.asarray(b),
                                           interpret=True))
    ta, tb = as_sketches(a, "cpu"), as_sketches(b, "cpu")
    np.testing.assert_array_equal(hamming_block_plain(ta, tb).numpy(), want)
    np.testing.assert_array_equal(HAMMING.pairwise_mxu(ta, tb).numpy(), want)
    # a is b, as the build calls it
    np.testing.assert_array_equal(
        hamming_block_plain(ta, ta).numpy(),
        np.asarray(hamming_block_padded(jnp.asarray(a), jnp.asarray(a),
                                        interpret=True)))


def test_hamming_launch_limits():
    """The kernel's limits, checked before any launch (meta tensors hold
    no data): words in [1, 64]; rows of a and of b and blocks in the
    batch up to the C entry's int, which the persistent grid walks
    whatever the count (the earlier grid took 65535 * 32 rows of a)."""
    limit = hamming_mod._MAX_ROWS
    assert limit == 2**31 - 1

    def meta(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    hamming_mod._check_launch(meta(65535 * 32 + 1, 32), meta(8, 32))
    hamming_mod._check_launch(meta(limit, 32), meta(limit, 32))
    hamming_mod._check_launch(meta(70_000, 12, 32), meta(70_000, 12, 32))
    with pytest.raises(ValueError, match="rows of a"):
        hamming_mod._check_launch(meta(limit + 1, 32), meta(8, 32))
    with pytest.raises(ValueError, match="rows of b"):
        hamming_mod._check_launch(meta(8, 32), meta(limit + 1, 32))
    with pytest.raises(ValueError, match="blocks"):
        hamming_mod._check_launch(meta(limit + 1, 1, 32),
                                  meta(limit + 1, 1, 32))
    for words in (0, 65):
        with pytest.raises(ValueError, match="words"):
            hamming_mod._check_launch(meta(4, words), meta(4, words))
    with pytest.raises(ValueError, match="contiguous"):
        hamming_mod._check_launch(meta(4, 64)[:, :32], meta(4, 32))


@pytest.mark.parametrize("p,m,n,words", [(5, 96, 96, 32), (3, 72, 72, 32),
                                         (4, 17, 130, 5)])
def test_hamming_block_batched_matches_jax(p, m, n, words, monkeypatch):
    """The batched form equals the JAX block of every leading index."""
    rng = np.random.default_rng(p + m + n + words)
    a, b = _sketches(rng, p, m, words), _sketches(rng, p, n, words)
    got = hamming_block(as_sketches(a, "cpu"), as_sketches(b, "cpu")).numpy()
    assert got.shape == (p, m, n) and got.dtype == np.int32
    for i in range(p):
        np.testing.assert_array_equal(
            got[i], np.asarray(JAX_HAMMING.pairwise(a[i], b[i])))
    # passes of a few rows each (the plain version's memory cap) agree
    monkeypatch.setattr(hamming_mod, "_PLAIN_ELEMS", 3 * n * words)
    split = hamming_block_plain(as_sketches(a, "cpu"), as_sketches(b, "cpu"))
    np.testing.assert_array_equal(split.numpy(), got)
    # Hamming.pairwise_block routes through the same function
    np.testing.assert_array_equal(
        HAMMING.pairwise_block(as_sketches(a, "cpu"),
                               as_sketches(b, "cpu")).numpy(), got)


def test_hamming_block_rejects_mismatched_shapes():
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        hamming_block(a, torch.zeros((4, 7), dtype=torch.int32))
    with pytest.raises(TypeError):
        hamming_block(a, torch.zeros((4, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        hamming_block(a[None], torch.zeros((2, 4, 8), dtype=torch.int32))


def _port(case, ef, max_steps=256):
    """The port's gather search on CPU tensors through the wrapper: (d,
    ids, visited, steps) as numpy, empty slots (DINF, IINF)."""
    adj, pts, node_map, qs, d0, seeds = case
    t = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
         for a in (adj, pts, qs, d0, seeds)]
    nm = None if node_map is None else torch.from_numpy(node_map)
    calls = dma_beam_search.plain_calls
    keys, vis, stp = dma_beam_search(t[0], t[1], nm, t[2], t[3], t[4], ef=ef,
                                     max_steps=max_steps)
    assert dma_beam_search.plain_calls == calls + 1
    d, i = split_keys(keys, 0)
    return d.numpy(), i.numpy(), vis.numpy(), stp.numpy()


def _xla(case, ef, capacity=None):
    """The XLA beam (dedup="beam", expand=1) over the same graph, each
    neighbor's point through the node map."""
    adj, pts, node_map, qs, _, seeds = case
    p = jnp.asarray(pts)
    if node_map is None:
        get = lambda ids: p[ids]  # noqa: E731
    else:
        nm = jnp.asarray(node_map)
        get = lambda ids: p[nm[ids]]  # noqa: E731
    return batched_beam_search(
        get, jnp.asarray(adj), jnp.asarray(qs), jnp.asarray(seeds), ef=ef,
        metric=jax_metric("hamming"), capacity=capacity or adj.shape[0],
        expand=1, max_steps=256, dedup="beam")


def _assert_equal(got, d, i, vis=None, stp=None):
    gd, gi, gv, gs = got
    np.testing.assert_array_equal(np.where(gd >= DINF, INT32_MAX, gd), d)
    np.testing.assert_array_equal(np.where(gi >= IINF, INT32_MAX, gi), i)
    if vis is not None:
        np.testing.assert_array_equal(gv, vis)
        np.testing.assert_array_equal(gs, stp)


def _assert_xla_equal(got, ref):
    _assert_equal(got, np.asarray(ref.dists), np.asarray(ref.ids),
                  np.asarray(ref.visited), np.asarray(ref.steps))


@pytest.mark.parametrize("w", [32, 64])
@pytest.mark.parametrize("ef", [1, 24, 48, 96, 128])
def test_gather_matches_xla(w, ef):
    case = gather_inputs(np.random.default_rng(w * 1000 + ef), 256, w, 1,
                         mapped=False, repeats=False)
    _assert_xla_equal(_port(case, ef), _xla(case, ef))


@pytest.mark.parametrize("w,ef,E,mapped,repeats",
                         [(32, 24, 4, False, False), (64, 96, 4, True, False),
                          (64, 48, 1, True, True), (32, 128, 4, True, True),
                          (64, 1, 1, True, False), (64, 96, 1, False, True),
                          (32, 48, 4, False, True)])
def test_gather_seeds_map_repeats_match_xla(w, ef, E, mapped, repeats):
    """E distinct seeds, points fetched through a non-identity node map
    (an upper HNSW level), and rows that repeat ids (the XLA merge drops
    a repeat of an earlier candidate of the row)."""
    case = gather_inputs(
        np.random.default_rng(w + ef + 10 * E + 100 * mapped + repeats), 256,
        w, E, mapped=mapped, repeats=repeats)
    _assert_xla_equal(_port(case, ef), _xla(case, ef))


def _pallas_case(seed, cap, w, words=32, B=32):
    """The inputs of tests/test_dma_search.py: a graph without repeated
    ids, every query entering at node 0."""
    rng = np.random.default_rng(seed)
    pts, adj = random_graph(rng, cap, w, words)
    qs = rng.integers(0, 2**32, size=(B, words), dtype=np.uint32)
    d0 = np.unpackbits((qs ^ pts[0]).view(np.uint8), axis=-1).sum(-1)
    return adj, pts, None, qs, d0.astype(np.int32), np.zeros(B, np.int32)


def _pallas(case, ef):
    adj, pts, _, qs, d0, seeds = case
    w, words = adj.shape[1], pts.shape[1]
    outd, outi, vis, stp = jdma.dma_beam_search(
        jdma.pack_adj(jnp.asarray(adj)), jdma.pack_points(jnp.asarray(pts)),
        jnp.asarray(qs), jnp.asarray(d0), jnp.asarray(seeds), ef=ef, W=w,
        words=words, max_steps=256, block_q=qs.shape[0], interpret=True)
    d = np.asarray(outd)[:, :ef]
    i = np.asarray(outi)[:, :ef]
    return (np.where(d >= jdma.DINF, INT32_MAX, d),
            np.where(i >= jdma.IINF, INT32_MAX, i), np.asarray(vis),
            np.asarray(stp))


@pytest.mark.parametrize("w,ef", [(32, 24), (64, 48), (64, 96), (128, 64)])
def test_gather_matches_pallas_interpret(w, ef):
    """TPU kernel #6 in interpret mode, on the cases of
    tests/test_dma_search.py::test_dma_matches_xla_two_key: the first
    ``ef`` slots, visited and steps."""
    case = _pallas_case(w * 1000 + ef, 256, w)
    _assert_equal(_port(case, ef), *_pallas(case, ef))


def test_gather_matches_pallas_beyond_packed_key_range():
    """tests/test_dma_search.py::test_dma_matches_beyond_packed_key_range:
    the XLA two-key branch at a fake capacity of 2^24, the Pallas kernel
    and the port agree on d and ids."""
    case = _pallas_case(9, 300, 16)
    got = _port(case, 32)
    _assert_equal(got, *_pallas(case, 32))
    ref = _xla(case, 32, capacity=2**24)
    _assert_equal(got, np.asarray(ref.dists), np.asarray(ref.ids))


def test_pallas_dma_keeps_repeated_row_ids():
    """Rows that list their first half twice: the Pallas kernel dedups only
    against the beam, so its beams hold duplicate ids, while the XLA merge
    and the port drop the repeat (ROADMAP §3)."""
    adj, *rest = _pallas_case(21, 256, 32)
    adj[:, 16:] = adj[:, :16]
    case = (adj, *rest)
    got = _port(case, 48)
    _assert_xla_equal(got, _xla(case, 48))
    _, ids, _, _ = _pallas(case, 48)
    dup = [len(set(r[r < INT32_MAX])) < int((r < INT32_MAX).sum())
           for r in ids]
    assert all(dup)
    assert all(len(set(r[r < IINF])) == int((r < IINF).sum()) for r in got[1])


def test_gather_wrapper_checks():
    case = gather_inputs(np.random.default_rng(3), 64, 16, 1, mapped=False,
                         repeats=False, B=4)
    adj, pts, _, qs, d0, seeds = [
        None if a is None else torch.from_numpy(
            np.ascontiguousarray(a).view(np.int32)) for a in case]
    with pytest.raises(NotImplementedError, match="general beam search"):
        dma_beam_search(adj, pts, None, qs, d0, seeds, ef=129)
    with pytest.raises(TypeError):
        dma_beam_search(adj.long(), pts, None, qs, d0, seeds, ef=8)
    with pytest.raises(ValueError):
        dma_beam_search(adj, pts, torch.zeros(3, dtype=torch.int32), qs, d0,
                        seeds, ef=8)
    with pytest.raises(ValueError):  # more seeds than beam slots
        dma_beam_search_plain(adj, pts, None, qs, d0[:, None].expand(4, 9),
                              seeds[:, None].expand(4, 9), ef=8)
