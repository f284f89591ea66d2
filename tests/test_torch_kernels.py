"""The fused CUDA beam-search kernel against its plain PyTorch version on
the card: keys, visited and steps bit-exact (tolerance 0) for the seven
(W, ef) pairs of the JAX kernel's contract and the clamped-key case.

This file imports no JAX, so it also runs where only PyTorch is
installed: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_kernels.py``. Without a card every test skips."""

import numpy as np
import pytest
import torch

from hnsw_itu_tpu_torch.ops.fused_search import (fused_beam_search,
                                                 key_clamp,
                                                 materialize_fused)
from hnsw_itu_tpu_torch.ops.metrics import as_sketches, popcount_sum
from hnsw_itu_tpu_torch.ops.search import beam_search_packed

# (W, ef) pairs of the JAX kernel's contract (tests/test_pallas_search.py)
PAIRS = [(16, 24), (32, 64), (64, 48), (32, 32), (32, 16), (64, 96),
         (32, 128)]


def random_graph(rng, cap, w, words):
    pts = rng.integers(0, 2**32, size=(cap, words), dtype=np.uint32)
    adj = np.full((cap, w), -1, np.int32)
    for i in range(cap):
        deg = rng.integers(w // 2, w + 1)
        adj[i, :deg] = rng.choice(cap, size=deg, replace=False)
    return pts, adj


def fused_inputs(pts, adj, qs, id_bits, max_d, device):
    """(table, queries, init keys) entering every query at node 0."""
    p, q = as_sketches(pts, device), as_sketches(qs, device)
    table = materialize_fused(p, torch.from_numpy(adj).to(device))
    d0 = popcount_sum(q ^ p[0])
    return table, q, (d0.clamp(max=key_clamp(id_bits, max_d)) << id_bits)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(table, q, init, **kw):
    launches = fused_beam_search.kernel_launches
    got = fused_beam_search(table, q, init, **kw)
    torch.cuda.synchronize()
    assert fused_beam_search.kernel_launches == launches + 1
    kw["max_d"] = key_clamp(kw["id_bits"], kw["max_d"])
    want = beam_search_packed(table.ids, table.data, q, init, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("w,ef", PAIRS)
def test_kernel_matches_plain(cuda_device, w, ef):
    cap, words, B = 256, 32, 32
    rng = np.random.default_rng(w * 1000 + ef)
    pts, adj = random_graph(rng, cap, w, words)
    qs = rng.integers(0, 2**32, size=(B, words), dtype=np.uint32)
    id_bits = max(1, (cap - 1).bit_length())
    table, q, init = fused_inputs(pts, adj, qs, id_bits, words * 32,
                                  cuda_device)
    _kernel_vs_plain(table, q, init, ef=ef, id_bits=id_bits,
                     max_d=words * 32, max_steps=256)


@pytest.mark.cuda
def test_kernel_clamped_keys_and_repeats(cuda_device):
    """id_bits=25 clamps distances to 62; rows repeat their neighbors."""
    cap, w, words, B, ef, id_bits = 256, 16, 32, 32, 24, 25
    rng = np.random.default_rng(9)
    pts, adj = random_graph(rng, cap, w, words)
    adj[:, w // 2 :] = adj[:, : w // 2]
    qs = rng.integers(0, 2**32, size=(B, words), dtype=np.uint32)
    table, q, init = fused_inputs(pts, adj, qs, id_bits, words * 32,
                                  cuda_device)
    _kernel_vs_plain(table, q, init, ef=ef, id_bits=id_bits,
                     max_d=words * 32, max_steps=256)


@pytest.mark.cuda
@pytest.mark.parametrize("words", [8, 16, 64])
def test_kernel_other_sketch_widths(cuda_device, words):
    """The kernel's other compiled sketch widths (the slice runs 32)."""
    cap, w, B, ef = 256, 24, 32, 32
    rng = np.random.default_rng(words)
    pts, adj = random_graph(rng, cap, w, words)
    qs = rng.integers(0, 2**32, size=(B, words), dtype=np.uint32)
    id_bits = max(1, (cap - 1).bit_length())
    table, q, init = fused_inputs(pts, adj, qs, id_bits, words * 32,
                                  cuda_device)
    _kernel_vs_plain(table, q, init, ef=ef, id_bits=id_bits,
                     max_d=words * 32, max_steps=64)
