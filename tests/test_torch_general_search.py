"""The port's general beam search (``ops/search.py``
``batched_beam_search``, ``greedy_search``) and its visited bitmask
(``ops/bitset.py``) against the JAX package's XLA functions on CPU
tensors, bit-exact (tolerance 0) on dists, ids, visited and steps.

The cases cover both dedup modes, expand 1 and 3, adjacency widths 24 and
256, ef 1, 32 and 200, plain and bit-reversed tie order, multi-seed
entries, and both JAX key branches: the packed int32 key (dedup "beam"
below 2^20 ids) and the two-key merge (dedup "bitmask", and dedup "beam"
over a sparse graph on a capacity past 2^20, where the key no longer
fits 31 bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_itu_tpu.ops import bitset as jbitset
from hnsw_itu_tpu.ops.metrics import get_metric as jax_metric
from hnsw_itu_tpu.ops.search import batched_beam_search as jax_search
from hnsw_itu_tpu.ops.search import greedy_search as jax_greedy
from hnsw_itu_tpu_torch.ops import bitset
from hnsw_itu_tpu_torch.ops.metrics import HAMMING
from hnsw_itu_tpu_torch.ops.search import (batched_beam_search,
                                           greedy_search)
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

B, NODES, NPTS, WORDS = 12, 600, 1024, 32
BIG = (1 << 20) + 8  # id_bits 21: 21 + 11 bits > 31, the two-key branch


def _graph(seed, cap, W):
    """A random graph on NODES ids spread over [0, cap): (node ids, adj
    int32[cap, W], points uint32[NPTS, WORDS]); node i's point is row
    i % NPTS, rows of other ids stay empty."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(cap, size=NODES, replace=False)).astype(np.int32)
    adj = np.full((cap, W), -1, np.int32)
    for i in ids:
        deg = int(rng.integers(W // 2, W + 1))
        adj[i, :deg] = rng.choice(ids, size=deg, replace=False)
    pts = rng.integers(0, 2**32, size=(NPTS, WORDS), dtype=np.uint32)
    return ids, adj, pts


_GRAPHS = {}


def graph(cap, W):
    if (cap, W) not in _GRAPHS:
        _GRAPHS[(cap, W)] = _graph(cap % 97 + W, cap, W)
    return _GRAPHS[(cap, W)]


def _inputs(cap, W, seeds, seed):
    ids, adj, pts = graph(cap, W)
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 2**32, size=(B, WORDS), dtype=np.uint32)
    eps = np.stack([rng.choice(ids, size=seeds, replace=False)
                    for _ in range(B)]).astype(np.int32)
    return adj, pts, qs, eps[:, 0] if seeds == 1 else eps


def run_both(cap, W, *, ef, expand, dedup, tie, seeds, max_steps=2048,
             seed=0):
    """(port SearchResult as numpy, JAX SearchResult as numpy)."""
    adj, pts, qs, eps = _inputs(cap, W, seeds, seed)
    tie_bits = max(1, (cap - 1).bit_length()) if tie else 0
    kw = dict(ef=ef, capacity=cap, expand=expand, max_steps=max_steps,
              dedup=dedup, tie_bits=tie_bits)
    pj = jnp.asarray(pts)
    want = jax_search(lambda i: pj[i % NPTS], jnp.asarray(adj),
                      jnp.asarray(qs), jnp.asarray(eps),
                      metric=jax_metric("hamming"), **kw)
    pt = torch.from_numpy(pts.view(np.int32))
    got = batched_beam_search(lambda i: pt[i % NPTS], torch.from_numpy(adj),
                              torch.from_numpy(qs.view(np.int32)),
                              torch.from_numpy(eps), metric=HAMMING, **kw)
    return ([g.numpy() for g in got], [np.asarray(w) for w in want])


# (capacity, W, ef, expand, dedup, tie, seeds)
CASES = [
    (NODES, 24, 32, 1, "bitmask", False, 1),
    (NODES, 24, 32, 3, "bitmask", False, 1),
    (NODES, 24, 1, 1, "bitmask", False, 1),
    (NODES, 24, 200, 1, "bitmask", True, 4),
    (1024, 256, 32, 1, "bitmask", False, 1),
    (1024, 256, 200, 3, "bitmask", True, 4),
    (NODES, 24, 32, 1, "beam", False, 1),
    (NODES, 24, 1, 1, "beam", False, 1),
    (NODES, 24, 32, 3, "beam", True, 4),
    (1024, 256, 200, 3, "beam", False, 1),
    (1024, 256, 32, 1, "beam", True, 1),
    (BIG, 24, 32, 1, "beam", False, 1),
    (BIG, 24, 200, 3, "beam", True, 4),
    (BIG, 24, 1, 1, "beam", False, 1),
    (BIG, 24, 32, 3, "bitmask", False, 4),
]


@pytest.mark.parametrize("cap,W,ef,expand,dedup,tie,seeds", CASES)
def test_general_search_matches_xla(cap, W, ef, expand, dedup, tie, seeds):
    got, want = run_both(cap, W, ef=ef, expand=expand, dedup=dedup, tie=tie,
                         seeds=seeds)
    for name, g, w in zip(("dists", "ids", "visited", "steps"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got[3] > 1).any()  # the searches walked the graph


def test_general_search_max_steps_cut():
    """A bound of 3 expansions stops every query mid-search: visited and
    steps as the JAX loop counts them."""
    got, want = run_both(NODES, 24, ef=32, expand=3, dedup="beam", tie=False,
                         seeds=1, max_steps=3)
    assert (got[3] == 3).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dedup", ["bitmask", "beam"])
def test_greedy_search_matches_xla(dedup):
    """ef=1 greedy descent: the JAX function runs bitmask dedup, as the
    port's does; an ef=1 search with beam dedup walks the same nodes (the
    one-slot beam's key only falls)."""
    adj, pts, qs, eps = _inputs(NODES, 24, 1, 3)
    pj = jnp.asarray(pts)
    wd, wi = jax_greedy(lambda i: pj[i % NPTS], jnp.asarray(adj),
                        jnp.asarray(qs[0]), jnp.int32(eps[0]),
                        metric=jax_metric("hamming"), capacity=NODES)
    pt = torch.from_numpy(pts.view(np.int32))
    args = (lambda i: pt[i % NPTS], torch.from_numpy(adj),
            torch.from_numpy(qs.view(np.int32)), torch.from_numpy(eps))
    if dedup == "bitmask":
        gd, gi = greedy_search(*args, metric=HAMMING, capacity=NODES)
    else:
        r = batched_beam_search(*args, ef=1, metric=HAMMING, capacity=NODES,
                                max_steps=512, dedup="beam")
        gd, gi = r.dists[:, 0], r.ids[:, 0]
    assert int(gd[0]) == int(wd) and int(gi[0]) == int(wi)


def test_bitset_matches_jax():
    """make / insert / contains / count on one mask, bit 31 of a word
    included (the int32 sign bit), and the batched form on two rows."""
    cap = 200
    ids = np.array([0, 31, 63, 95, 31 + 32 * 5, 7, 199, 100], np.int32)
    valid = np.array([1, 1, 1, 0, 1, 1, 1, 1], bool)
    jm = jbitset.insert(jbitset.make(cap), jnp.asarray(ids),
                        jnp.asarray(valid))
    pm = bitset.insert(bitset.make(cap, device="cpu"), torch.from_numpy(ids),
                       torch.from_numpy(valid))
    assert pm.dtype == torch.int32 and pm.shape == (bitset.n_words(cap),)
    np.testing.assert_array_equal(pm.numpy().view(np.uint32), np.asarray(jm))
    assert int(pm[0]) < 0  # bit 31 of word 0 is set: the sign bit
    probe = np.array([-5, 0, 31, 32, 63, 95, 191, 199, 300], np.int32)
    np.testing.assert_array_equal(
        bitset.contains(pm, torch.from_numpy(probe)).numpy(),
        np.asarray(jbitset.contains(jm, jnp.asarray(probe))))
    assert int(bitset.count(pm)) == int(jbitset.count(jm)) == 7
    # batched: one mask per row, ids [2, C]
    two = bitset.insert(bitset.make(cap, (2,), device="cpu"),
                        torch.from_numpy(np.stack([ids, ids[::-1]])),
                        torch.from_numpy(np.stack([valid, ~valid[::-1]])))
    np.testing.assert_array_equal(two[0].numpy(), pm.numpy())
    assert bitset.count(two).tolist() == [7, 1]
