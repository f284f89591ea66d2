"""The CUDA kernels against their plain PyTorch versions on the card,
bit-exact (tolerance 0): the fused kernel (keys, visited, steps) for the
seven (W, ef) pairs of the JAX kernel's contract, the clamped-key case,
the other sketch widths and its edge cases (full, narrow, one-id and
re-sketched rows, keys at the clamp of id_bits 25 and 30, ids at
2^id_bits - 1, ef 1 and 128, max_steps 0);
the mini kernel (d, ids, visited, steps) at beam capacity 64 and 128, with
several seeds, with tie_bits, and on a table past 2^21 rows; the exact
rerank kernel under both reranks (d, ids) on ties, repeats, invalid ids,
seeds past the beam and answers past the pool, at the 10M cell's shapes,
and under knns on the mini route against the same index on CPU; the gather
beam search (keys, visited, steps) across W, ef, seeds, a node map and
repeated ids; both beam kernels on the edges of their id set, slots and
merge (W = 128 and 24, rows that are all fresh or one id throughout, ids
near 2^31 - 1, ids that collide in the set, ef = 1 and 128 with ef seeds,
tie_bits 31; the cases of ``hnsw_itu_tpu_torch.testing``, which
chip_smoke.py runs too) and with seeds that repeat an id; the dense
Hamming block on odd and batched shapes; the sampled entry kernel (ids)
over query tiles, sample sizes, widths, repeated ids, the 10M runner's n,
ties, unaligned rows and under knns on both table routes; a 4-shard
sharded build on one card and its fused knns against the same on CPU
tensors. One test needs
no card: the kernel libraries' names follow their included headers.

This file imports no JAX, so it also runs where only PyTorch is
installed: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_kernels.py``. Without a card every test but that one
skips."""

import os

import numpy as np
import pytest
import torch

from hnsw_itu_tpu_torch.ops import _kernels
from hnsw_itu_tpu_torch.ops.dma_search import (dma_beam_search,
                                               dma_beam_search_plain)
from hnsw_itu_tpu_torch.ops.fused_search import (FusedTable,
                                                 fused_beam_search,
                                                 key_clamp,
                                                 materialize_fused)
from hnsw_itu_tpu_torch.ops.hamming import hamming_block, hamming_block_plain
from hnsw_itu_tpu_torch.ops.entry import sampled_entry, strided_sample_ids
from hnsw_itu_tpu_torch.ops.metrics import HAMMING, as_sketches, popcount_sum
from hnsw_itu_tpu_torch.ops.mini_search import (IINF, MAX_RERANK_K,
                                                materialize_mini,
                                                mini_beam_search,
                                                mini_beam_search_plain,
                                                rerank_exact,
                                                rerank_exact_plain,
                                                rerank_onehop,
                                                rerank_onehop_plain)
from hnsw_itu_tpu_torch.ops.search import beam_search_packed
from hnsw_itu_tpu_torch.testing import (FUSED_EDGES, GATHER_EDGES,
                                       MINI_EDGES, REPEATED_SEEDS,
                                       edge_inputs, fused_edge_inputs,
                                       random_graph, repeated_seed_inputs)

# (W, ef) pairs of the JAX kernel's contract (tests/test_pallas_search.py)
PAIRS = [(16, 24), (32, 64), (64, 48), (32, 32), (32, 16), (64, 96),
         (32, 128)]
# (W, ef, mini_words) of the JAX mini kernels' contract
# (tests/test_dma_search.py::test_mini_matches_xla_on_prefix)
MINI_CASES = [(64, 48, 3), (64, 96, 7), (32, 32, 3), (32, 48, 31),
              (32, 64, 31), (64, 128, 7), (32, 96, 7)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread while a module runs. pytest-xdist runs
    several worker processes on the same cores; a thread pool as wide as
    the machine in each of them makes every worker many times slower.
    Modules that import this fixture get it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fused_inputs(pts, adj, qs, id_bits, max_d, device):
    """(table, queries, init keys) entering every query at node 0."""
    p, q = as_sketches(pts, device), as_sketches(qs, device)
    table = materialize_fused(p, torch.from_numpy(adj).to(device))
    d0 = popcount_sum(q ^ p[0])
    return table, q, (d0.clamp(max=key_clamp(id_bits, max_d)) << id_bits)


def mini_inputs(pts, adj, qs, seeds, mw, device):
    """(table, queries, seed prefix distances, seed ids) for the mini
    search; ``seeds`` int32[B] or [B, E]."""
    p, q = as_sketches(pts, device), as_sketches(qs, device)
    table = materialize_mini(p, torch.from_numpy(adj).to(device),
                             mini_words=mw)
    s = torch.from_numpy(seeds).to(device)
    qp = q[:, None, :mw] if s.dim() == 2 else q[:, :mw]
    return table, q, popcount_sum(p[s.long(), :mw] ^ qp), s


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


def fused_edge_tensors(pts, ids, data, qs, eps, id_bits, dev):
    """Card tensors (table, queries, init keys) of one fused edge case:
    each query enters at its own id, its distance clamped into the key."""
    p, q = as_sketches(pts, dev), as_sketches(qs, dev)
    table = FusedTable(ids=torch.from_numpy(ids).to(dev),
                       data=as_sketches(data, dev))
    e = torch.from_numpy(eps).to(dev)
    d0 = popcount_sum(q ^ p[e.long()])
    max_d = key_clamp(id_bits, q.shape[1] * 32)
    return table, q, (d0.clamp(max=max_d) << id_bits) | e


@pytest.mark.cuda
@pytest.mark.parametrize("kind,cap,w,ef,id_bits,max_steps", FUSED_EDGES)
def test_fused_kernel_edges(cuda_device, kind, cap, w, ef, id_bits,
                            max_steps):
    """W 128 full rows and W 24, rows all fresh or one id throughout, a
    row repeating an id with another sketch (both keys stay), distances
    at the clamp of id_bits 25 and 30, ids at 2^id_bits - 1, ef 1 and 128,
    max_steps 0."""
    table, q, init = fused_edge_tensors(
        *fused_edge_inputs(kind, cap, w, id_bits), id_bits, cuda_device)
    assert table.width == w
    _kernel_vs_plain(table, q, init, ef=ef, id_bits=id_bits,
                     max_d=q.shape[1] * 32, max_steps=max_steps)


def _mini_vs_plain(table, q, d0, s, **kw):
    launches = mini_beam_search.kernel_launches
    got = mini_beam_search(table, q, d0, s, **kw)
    torch.cuda.synchronize()
    assert mini_beam_search.kernel_launches == launches + 1
    want = mini_beam_search_plain(table, q, d0, s, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    return got


def _mini_case(rng, cap, w, E, B=32, words=32):
    pts, adj = random_graph(rng, cap, w, words)
    qs = rng.integers(0, 2**32, size=(B, words), dtype=np.uint32)
    if E == 1:
        return pts, adj, qs, np.zeros(B, np.int32)
    seeds = np.stack([rng.choice(cap, size=E, replace=False)
                      for _ in range(B)]).astype(np.int32)
    return pts, adj, qs, seeds


@pytest.mark.cuda
@pytest.mark.parametrize("w,ef,mw", MINI_CASES)
def test_mini_kernel_matches_plain(cuda_device, w, ef, mw):
    """Capacity 64 (ef <= 64) and 128, 16-byte and 4-byte row loads."""
    rng = np.random.default_rng(w + ef + mw)
    pts, adj, qs, seeds = _mini_case(rng, 256, w, 1)
    _mini_vs_plain(*mini_inputs(pts, adj, qs, seeds, mw, cuda_device),
                   ef=ef, mini_words=mw, max_steps=256)


@pytest.mark.cuda
@pytest.mark.parametrize("ef,E,tie,mw", [(48, 4, 8, 7), (48, 8, 0, 5),
                                         (96, 8, 8, 31), (96, 4, 0, 7)])
def test_mini_kernel_seeds_and_ties(cuda_device, ef, E, tie, mw):
    """Several distinct seeds per query, the bit-reversed tie order, and
    a prefix width (mw=5) read word by word."""
    rng = np.random.default_rng(ef * 10 + E + tie)
    pts, adj, qs, seeds = _mini_case(rng, 256, 32, E)
    _mini_vs_plain(*mini_inputs(pts, adj, qs, seeds, mw, cuda_device),
                   ef=ef, mini_words=mw, max_steps=256, tie_bits=tie)


@pytest.mark.cuda
def test_mini_kernel_repeated_neighbors(cuda_device):
    """Rows that repeat their first half: later copies are duplicates."""
    rng = np.random.default_rng(21)
    pts, adj, qs, seeds = _mini_case(rng, 256, 32, 1)
    adj[:, 16:] = adj[:, :16]
    _mini_vs_plain(*mini_inputs(pts, adj, qs, seeds, 7, cuda_device),
                   ef=48, mini_words=7, max_steps=256)


@pytest.mark.cuda
@pytest.mark.parametrize("tie", [0, 22])
def test_mini_kernel_past_packed_key_range(cuda_device, tie):
    """A table of 2^21 + 2^20 rows (W=32, mw=3, 1.6 GB): the graph lives on
    the ids above 2^21, which no int32 (d, id) packing of 1024-bit
    distances holds."""
    cap, w, mw, B, ef, live = 3 << 20, 32, 3, 256, 64, 4096
    rng = np.random.default_rng(tie)
    base = (1 << 21) + 12345
    pts_live, adj_live = random_graph(rng, live, w, mw)
    qs = rng.integers(0, 2**32, size=(B, mw), dtype=np.uint32)
    pts = torch.zeros((cap, mw), dtype=torch.int32, device=cuda_device)
    pts[base : base + live] = as_sketches(pts_live, cuda_device)
    adj = torch.full((cap, w), -1, dtype=torch.int32, device=cuda_device)
    adj_live = np.where(adj_live >= 0, adj_live + base, -1).astype(np.int32)
    adj[base : base + live] = torch.from_numpy(adj_live).to(cuda_device)
    table = materialize_mini(pts, adj, mini_words=mw)
    q = as_sketches(qs, cuda_device)
    s = torch.full((B,), base, dtype=torch.int32, device=cuda_device)
    d0 = popcount_sum(pts[s.long()] ^ q)
    d, i, _, _ = _mini_vs_plain(table, q, d0, s, ef=ef, mini_words=mw,
                                max_steps=128, tie_bits=tie)
    found = i[i < 0x7FFFFFFF]
    assert found.numel() > 0 and bool((found >= base).all())


def gather_inputs(rng, cap, w, E, *, mapped, repeats, B=32, words=32):
    """(adj, points, node_map, queries, seed distances, seed ids) of a
    random graph, as numpy arrays. ``mapped``: the graph's
    ``cap`` local ids map into a point array twice as large through a
    random injective node map (an upper HNSW level); ``repeats``: every row
    lists its first half twice."""
    pts, adj = random_graph(rng, cap, w, words)
    if repeats:
        adj[:, w // 2 :] = adj[:, : w // 2]
    node_map = None
    if mapped:
        node_map = rng.permutation(2 * cap)[:cap].astype(np.int32)
        big = rng.integers(0, 2**32, size=(2 * cap, words), dtype=np.uint32)
        big[node_map] = pts
        pts = big
    qs = rng.integers(0, 2**32, size=(B, words), dtype=np.uint32)
    seeds = np.stack([rng.choice(cap, size=E, replace=False)
                      for _ in range(B)]).astype(np.int32)
    rows = seeds if node_map is None else node_map[seeds]
    d0 = np.unpackbits((pts[rows] ^ qs[:, None, :]).view(np.uint8),
                       axis=-1).sum(-1).astype(np.int32)
    if E == 1:
        seeds, d0 = seeds[:, 0], d0[:, 0]
    return adj, pts, node_map, qs, d0, seeds


def _gather_vs_plain(case, dev, *, ef, max_steps):
    adj, pts, node_map, qs, d0, seeds = case
    t = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)
         for a in (adj, pts, qs, d0, seeds)]
    nm = None if node_map is None else torch.from_numpy(node_map).to(dev)
    args = (t[0], t[1], nm, t[2], t[3], t[4])
    launches = dma_beam_search.kernel_launches
    got = dma_beam_search(*args, ef=ef, max_steps=max_steps)
    torch.cuda.synchronize()
    assert dma_beam_search.kernel_launches == launches + 1
    want = dma_beam_search_plain(*args, ef=ef, max_steps=max_steps)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("w", [32, 64])
@pytest.mark.parametrize("ef", [1, 24, 48, 96, 128])
def test_gather_kernel_matches_plain(cuda_device, w, ef):
    """Beam capacity 64 (ef <= 64) and 128, one seed, identity map."""
    rng = np.random.default_rng(w * 1000 + ef)
    case = gather_inputs(rng, 256, w, 1, mapped=False, repeats=False)
    _gather_vs_plain(case, cuda_device, ef=ef, max_steps=256)


@pytest.mark.cuda
@pytest.mark.parametrize("w,ef,E,mapped,repeats",
                         [(32, 24, 4, False, False), (64, 96, 4, True, False),
                          (64, 48, 1, True, True), (32, 128, 4, True, True),
                          (64, 1, 1, True, False), (64, 96, 1, False, True)])
def test_gather_kernel_seeds_map_repeats(cuda_device, w, ef, E, mapped,
                                         repeats):
    """Several seeds, a non-identity node map (points fetched through it)
    and rows that repeat ids (later copies are duplicates)."""
    rng = np.random.default_rng(w + ef + 10 * E + 100 * mapped + repeats)
    case = gather_inputs(rng, 256, w, E, mapped=mapped, repeats=repeats)
    _gather_vs_plain(case, cuda_device, ef=ef, max_steps=256)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,self_block", [
    ((1, 1, 32), False), ((7, 129, 32), False), ((96, 96, 32), False),
    ((130, 33, 5), False), ((64, 200, 64), False), ((3, 72, 72, 32), False),
    ((17, 96, 96, 32), False), ((5, 31, 65, 7), False),
    ((4, 95, 97, 1), False), ((4, 97, 95, 31), False),
    ((3, 96, 96, 33), False), ((1000, 4100, 32), False),
    ((16, 96, 96, 32), True), ((6, 95, 95, 32), True),
    ((6, 97, 97, 32), True), ((4, 264, 264, 32), True),
    ((2, 264, 264, 64), True), ((70_000, 12, 12, 32), True)])
def test_hamming_kernel_matches_plain(cuda_device, shape, self_block):
    """Odd sizes on both sides (edges guarded, not padded; 95 and 97 are
    not multiples of the 16-row and 8-column mma tiles), word counts that
    are not a multiple of the 8-word k slice (1, 5, 7, 31, 33) and 64,
    batched blocks (P past 65,535), a 2-D block of several tiles each
    way, and ``hamming_block(x, x)`` as the build calls it (one staging
    for both operands)."""
    rng = np.random.default_rng(sum(shape))
    words = shape[-1]
    if len(shape) == 3:
        m, n = shape[:2]
        a_shape, b_shape = (m, words), (n, words)
    else:
        p, m, n = shape[:3]
        a_shape, b_shape = (p, m, words), (p, n, words)
    a = as_sketches(rng.integers(0, 2**32, size=a_shape, dtype=np.uint32),
                    cuda_device)
    b = a if self_block else as_sketches(
        rng.integers(0, 2**32, size=b_shape, dtype=np.uint32), cuda_device)
    launches = hamming_block.kernel_launches
    got = hamming_block(a, b)
    torch.cuda.synchronize()
    assert hamming_block.kernel_launches == launches + 1
    torch.testing.assert_close(got, hamming_block_plain(a, b), rtol=0, atol=0)


def test_library_name_follows_included_headers(tmp_path):
    """An edit to a header that a kernel includes (directly or through
    another header) renames its library, so a stale build is never
    loaded; an edit to a header it does not include does not."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n'
                               '#include "beam_common.cuh"\nint f();\n')
    (csrc / "beam_common.cuh").write_text('#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("constexpr int kA = 1;\n")
    (csrc / "other.cuh").write_text("constexpr int kB = 1;\n")
    build = str(tmp_path / "build")

    def path():
        return _kernels.library_path("k", csrc=str(csrc), build_dir=build)

    first = path()
    assert os.path.dirname(first) == build
    assert os.path.basename(first).startswith("k-")
    (csrc / "other.cuh").write_text("constexpr int kB = 2;\n")
    assert path() == first
    (csrc / "inner.cuh").write_text("constexpr int kA = 2;\n")
    second = path()
    assert second != first
    (csrc / "beam_common.cuh").write_text('#include "inner.cuh"\n// x\n')
    assert path() not in (first, second)


def gather_edge_inputs(pts, adj, qs, seeds, dev):
    """Card tensors (adj, points, queries, seed distances, seeds) of one
    gather case."""
    p, q = as_sketches(pts, dev), as_sketches(qs, dev)
    s = torch.from_numpy(seeds).to(dev)
    d0 = popcount_sum(p[s.long()] ^ q[:, None, :])
    return torch.from_numpy(adj).to(dev), p, q, d0, s


def _gather_edge_vs_plain(adj, p, q, d0, s, *, ef):
    args = (adj, p, None, q, d0, s)
    launches = dma_beam_search.kernel_launches
    got = dma_beam_search(*args, ef=ef, max_steps=256)
    torch.cuda.synchronize()
    assert dma_beam_search.kernel_launches == launches + 1
    want = dma_beam_search_plain(*args, ef=ef, max_steps=256)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,cap,w,ef,E", GATHER_EDGES)
def test_gather_kernel_edges(cuda_device, kind, cap, w, ef, E):
    _gather_edge_vs_plain(*gather_edge_inputs(*edge_inputs(kind, cap, w, E),
                                         cuda_device), ef=ef)


def mini_edge_inputs(pts, adj, qs, seeds, mw, w, dev):
    """Card tensors (table, queries, seed prefix distances, seeds) of one
    mini case; W = 24 keeps the table's first 24 columns
    (materialize_mini pads rows to 32)."""
    p, q = as_sketches(pts, dev), as_sketches(qs, dev)
    table = materialize_mini(p, torch.from_numpy(adj).to(dev),
                             mini_words=mw)[:, :w].contiguous()
    s = torch.from_numpy(seeds).to(dev)
    return table, q, popcount_sum(p[s.long(), :mw] ^ q[:, None, :mw]), s


@pytest.mark.cuda
@pytest.mark.parametrize("kind,cap,w,ef,E,mw,tie", MINI_EDGES)
def test_mini_kernel_edges(cuda_device, kind, cap, w, ef, E, mw, tie):
    table, q, d0, s = mini_edge_inputs(*edge_inputs(kind, cap, w, E, salt=mw),
                                       mw, w, cuda_device)
    assert table.shape[1] == w
    _mini_vs_plain(table, q, d0, s, ef=ef, mini_words=mw, max_steps=256,
                   tie_bits=tie)


@pytest.mark.cuda
@pytest.mark.parametrize("w,ef,E,distinct,tie", REPEATED_SEEDS)
def test_beam_kernels_repeated_seeds(cuda_device, w, ef, E, distinct, tie):
    """Seeds that repeat an id: both kernels drop the later copies at the
    first step, as the plain merge does, and end (no spin on an id the
    set holds once)."""
    inputs = repeated_seed_inputs(w, E, distinct)
    _gather_edge_vs_plain(*gather_edge_inputs(*inputs, cuda_device), ef=ef)
    table, q, d0, s = mini_edge_inputs(*inputs, 7, w, cuda_device)
    _mini_vs_plain(table, q, d0, s, ef=ef, mini_words=7, max_steps=256,
                   tie_bits=tie)


def rerank_inputs(rng, words, H, W, dev, B=16, cap=300):
    """(points, queries, candidates, adjacency) on ``dev`` for the exact
    rerank: points drawn from 12 sketches (heavy distance ties, so ties
    go by id), candidates that repeat ids and hold ids < 0, >= cap and
    IINF, one query with no valid candidate and one whose row is one id
    throughout; adjacency rows with -1, ids >= cap, IINF and repeats."""
    base = rng.integers(0, 2**32, size=(12, words), dtype=np.uint32)
    pts = base[rng.integers(0, 12, size=cap)]
    qs = base[rng.integers(0, 12, size=B)]
    qs[::2, 0] ^= 1
    cand = rng.integers(-3, cap + 3, size=(B, H)).astype(np.int32)
    cand[rng.random(cand.shape) < 0.1] = IINF
    cand[1] = IINF
    cand[2] = 7
    cand[3, H // 2:] = cand[3, : H - H // 2]
    adj = rng.integers(-2, cap + 2, size=(cap, W)).astype(np.int32)
    adj[rng.random(adj.shape) < 0.1] = IINF
    adj[::3, W // 2:] = adj[::3, : W - W // 2]
    return (as_sketches(pts, dev), as_sketches(qs, dev),
            torch.from_numpy(cand).to(dev), torch.from_numpy(adj).to(dev))


def _rerank_vs_plain(fn, plain, *args, **kw):
    """One kernel launch, no plain call, and the plain version's answer."""
    launches, calls = fn.kernel_launches, fn.plain_calls
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert (fn.kernel_launches, fn.plain_calls) == (launches + 1, calls)
    want = plain(*args, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("words", [8, 16, 32, 64, 12, 5])
@pytest.mark.parametrize("H", [16, 96, 128])
def test_rerank_kernel_matches_plain(cuda_device, words, H):
    """Both reranks on the kernel against their plain versions: base
    widths 8, 64 and 128; seeds 0 (rerank_exact, and the one hop without
    a hop), 1, 8 and past H; k 1, 10 and past the pool (as wide as the
    kernel holds where the pool is wider); 16-byte row reads at 8 to 64
    words, 4-byte reads at 12 and 5."""
    rng = np.random.default_rng(words * 1000 + H)
    for W in (8, 64, 128):
        p, q, c, a = rerank_inputs(rng, words, H, W, cuda_device)
        for seeds in (0, 1, 8, H + 5):
            pool = H + min(seeds, H) * W
            for k in (1, 10, min(pool + 7, MAX_RERANK_K)):
                _rerank_vs_plain(rerank_onehop, rerank_onehop_plain, p, a,
                                 q, c, k=k, seeds=seeds)
            if pool > MAX_RERANK_K:
                with pytest.raises(ValueError):
                    rerank_onehop(p, a, q, c, k=pool, seeds=seeds)
        for k in (1, 10, H + 7):
            for dedup in (False, True):
                _rerank_vs_plain(rerank_exact, rerank_exact_plain, p, q, c,
                                 k=k, dedup=dedup)


@pytest.mark.cuda
def test_rerank_kernel_at_the_served_shape(cuda_device):
    """The 10M cell's rerank: 8192 queries, a beam of 96, 8 seeds of 64
    neighbors, 32-word sketches, k 10; both reranks."""
    rng = np.random.default_rng(96)
    cap, B = 1 << 17, 8192
    pts, adj = random_graph(rng, cap, 64, 32)
    qs = rng.integers(0, 2**32, size=(B, 32), dtype=np.uint32)
    beam = np.stack([rng.choice(cap, size=96, replace=False)
                     for _ in range(B)]).astype(np.int32)
    p, q, a = (as_sketches(pts, cuda_device), as_sketches(qs, cuda_device),
               torch.from_numpy(adj).to(cuda_device))
    c = torch.from_numpy(beam).to(cuda_device)
    _rerank_vs_plain(rerank_onehop, rerank_onehop_plain, p, a, q, c, k=10,
                     seeds=8)
    _rerank_vs_plain(rerank_exact, rerank_exact_plain, p, q, c, k=10)


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [0, 4])
def test_mini_route_reranks_on_the_kernel(cuda_device, hop, monkeypatch):
    """knns on the mini route on the card: one mini kernel launch and one
    rerank kernel launch a batch, no plain call, and the answer of the
    same index on CPU tensors (the plain versions)."""
    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.models import hnsw as port_hnsw
    from hnsw_itu_tpu_torch.models import nsw as port_nsw
    from hnsw_itu_tpu_torch.utils import make_dataset

    monkeypatch.setattr(port_nsw, "_fused_query_eligible",
                        lambda *a, **kw: False)
    pts, qs = make_dataset(6, 1500, 64)
    opts = IndexOptions(ef_construction=48, connections=12,
                        max_connections=32, size=1500, batch_size=128,
                        host_warmup=1500)
    idx = []
    for dev in (cuda_device, "cpu"):
        b = port_hnsw.HNSWBuilder(opts, device=dev)
        b.extend_batched(pts)
        i = b.build()
        i.enable_inline()
        i.query_entry_sample, i.query_hop = 64, hop
        idx.append(i)
    card, cpu = idx
    assert (card.mini_W, card.mini_words) == (cpu.mini_W, cpu.mini_words)
    rerank = rerank_onehop if hop else rerank_exact
    before = (mini_beam_search.kernel_launches, rerank.kernel_launches,
              mini_beam_search.plain_calls, rerank.plain_calls)
    got = card.knns(qs, 10, 48)
    torch.cuda.synchronize()
    assert card.last_route == "mini"
    assert (mini_beam_search.kernel_launches, rerank.kernel_launches,
            mini_beam_search.plain_calls, rerank.plain_calls) == \
        (before[0] + 1, before[1] + 1, before[2], before[3])
    want = cpu.knns(qs, 10, 48)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


_SHARDED = {}


def _sharded_pair(device):
    """The same 4-shard ShardedHNSW built on ``device`` (4 shards on one
    card) and on CPU tensors, with its queries; built once, with the
    kernels' launches during the card build."""
    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.parallel import ShardedHNSW, make_mesh
    from hnsw_itu_tpu_torch.utils import make_dataset

    if "pair" not in _SHARDED:
        pts, qs = make_dataset(23, 4003, 64)
        opts = dict(host_warmup=0, ef_construction=48, connections=12,
                    max_connections=24, size=4003, batch_size=64)
        before = (dma_beam_search.kernel_launches,
                  hamming_block.kernel_launches)
        card = ShardedHNSW.build(pts, IndexOptions(**opts),
                                 mesh=make_mesh(devices=[device] * 4))
        torch.cuda.synchronize()
        launches = (dma_beam_search.kernel_launches - before[0],
                    hamming_block.kernel_launches - before[1])
        cpu = ShardedHNSW.build(pts, IndexOptions(**opts),
                                mesh=make_mesh(devices=["cpu"] * 4))
        _SHARDED["pair"] = (card, cpu, qs, launches)
    return _SHARDED["pair"]


@pytest.mark.cuda
def test_sharded_build_on_card_matches_cpu(cuda_device):
    """A 4-shard build on one card (kernels #6 and #7) equals the same
    build on CPU tensors (their plain versions)."""
    card, cpu, _, launches = _sharded_pair(cuda_device)
    assert min(launches) > 0
    for s in range(4):
        assert card.adj_s[s].device.type == "cuda"
        torch.testing.assert_close(card.adj_s[s].cpu(), cpu.adj_s[s],
                                   rtol=0, atol=0)
        torch.testing.assert_close(card.deg_s[s].cpu(), cpu.deg_s[s],
                                   rtol=0, atol=0)
    assert card.ns.tolist() == cpu.ns.tolist()
    assert [int(d) for d in card.edge_drops_s] == \
        [int(d) for d in cpu.edge_drops_s]


@pytest.mark.cuda
def test_sharded_fused_knns_on_card_matches_cpu(cuda_device):
    """The fused sharded knns on the card (kernel #1, once per shard)
    equals the CPU one (its plain version)."""
    card, cpu, qs, _ = _sharded_pair(cuda_device)
    card.enable_inline()
    cpu.enable_inline()
    assert len(card.fused_s) == 4
    before = fused_beam_search.kernel_launches
    got = card.knns(qs, 10, 48)
    torch.cuda.synchronize()
    assert fused_beam_search.kernel_launches == before + 4
    want = cpu.knns(qs, 10, 48)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


# -- the sampled entry (csrc/sampled_entry.cu) ---------------------------------

FLAGSHIP_N = 10_120_192  # the 10M runner's points: (s * n) passes 2^31

# (B, S, words, n, kind): query tiles of 1, 15, 16, 17 and 10,000 rows
# (the 1M cell's batch); samples of 1, 7, 1024 (both cells'), 1025, 4097
# and 65,536 (the wide entry); widths 1 to 64, 16-byte row copies where
# words % 4 == 0 and 4-byte ones elsewhere; n below S (repeated ids) and
# at the 10M cell's n. "ties": points and queries drawn from 6 sketches
# with sparse flips (ties everywhere), duplicated sample rows and queries
# equidistant from two sample positions.
ENTRY_CASES = [
    (1, 1, 32, 1000, "random"),
    (15, 7, 1, 500, "random"),
    (16, 1024, 32, 5000, "ties"),
    (17, 1025, 8, 3000, "random"),
    (17, 4097, 31, 20_000, "ties"),
    (16, 1024, 64, 4000, "ties"),
    (15, 65_536, 8, 70_000, "random"),
    (17, 1024, 32, 100, "random"),
    (16, 7, 31, 3, "ties"),
    (33, 1024, 4, FLAGSHIP_N, "random"),
    (17, 65_536, 4, FLAGSHIP_N, "ties"),
    (10_000, 1024, 32, 200_000, "random"),
    (10_000, 1024, 32, 200_000, "ties"),
]


def entry_inputs(rng, B, S, words, n, kind):
    """(points uint32[n, words], queries uint32[B, words]) for the sampled
    entry. ``ties``: rows of 6 base sketches with 0-2 bits flipped; three
    sample positions (5, 9 and S // 2 where S allows) hold one sketch
    that no other sample row holds and the first query equals, and the
    second query lies at one bit from each of two sample rows (the later
    position first)."""
    if kind == "random":
        return (rng.integers(0, 2**32, size=(n, words), dtype=np.uint32),
                rng.integers(0, 2**32, size=(B, words), dtype=np.uint32))
    base = rng.integers(0, 2**32, size=(6, words), dtype=np.uint32)

    def draw(m):
        x = base[rng.integers(0, 6, size=m)]
        flips = rng.integers(0, 3, size=m)
        x[flips > 0, 0] ^= np.uint32(1) << rng.integers(
            0, 32, size=int((flips > 0).sum()), dtype=np.uint32)
        x[flips > 1, -1] ^= np.uint32(1) << np.uint32(7)
        return x

    pts, qs = draw(n), draw(B)
    ids = strided_sample_ids(n, S, device="cpu").numpy()
    if S > 9 and n >= S:
        pts[ids[[5, 9, S // 2]]] = qs[0] = rng.integers(
            0, 2**32, size=words, dtype=np.uint32)
        a, b = ids[S - 1], ids[S // 3]
        pts[a] = pts[b] = rng.integers(0, 2**32, size=words, dtype=np.uint32)
        qs[1] = pts[a]
        qs[1, 0] ^= np.uint32(3)  # one bit from each once the rows split
        pts[a, 0] ^= np.uint32(1)
        pts[b, 0] ^= np.uint32(2)
    return pts, qs


def _entry_vs_plain(points, qs, n, S):
    """One kernel launch, no plain call, and the ids of ``sampled_entry``
    on the same tensors moved to the CPU (its plain version)."""
    launches, calls = (sampled_entry.kernel_launches,
                       sampled_entry.plain_calls)
    got = sampled_entry(points, qs, n, sample_size=S, metric=HAMMING)
    torch.cuda.synchronize()
    assert (sampled_entry.kernel_launches, sampled_entry.plain_calls) == \
        (launches + 1, calls)
    assert got.dtype == torch.int32 and got.shape == (qs.shape[0],)
    want = sampled_entry(points.cpu(), qs.cpu(), n, sample_size=S,
                         metric=HAMMING)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,words,n,kind", ENTRY_CASES)
def test_sampled_entry_kernel_matches_plain(cuda_device, B, S, words, n,
                                            kind):
    """The sampled entry on the kernel against its plain version: the
    same int32 ids, ties to the lowest sample position."""
    rng = np.random.default_rng(B * 7 + S * 3 + words + n % 1000)
    pts, qs = entry_inputs(rng, B, S, words, n, kind)
    p, q = as_sketches(pts, cuda_device), as_sketches(qs, cuda_device)
    got = _entry_vs_plain(p, q, n, S)
    if kind == "ties" and S > 9 and n >= S:
        ids = strided_sample_ids(n, S, device="cpu").numpy()
        assert int(got[0]) == ids[5]
        assert int(got[1]) == ids[S // 3]


@pytest.mark.cuda
def test_sampled_entry_kernel_on_unaligned_rows(cuda_device):
    """Points that start 4 bytes past a 16-byte boundary take the 4-byte
    copies at any width; an empty batch launches nothing."""
    rng = np.random.default_rng(44)
    pts, qs = entry_inputs(rng, 40, 1024, 32, 3001, "ties")
    flat = as_sketches(pts, cuda_device).reshape(-1)
    shifted = torch.empty(flat.numel() + 1, dtype=torch.int32,
                          device=cuda_device)
    shifted[1:] = flat
    p = shifted[1:].view(3001, 32)
    assert p.data_ptr() % 16 == 4
    _entry_vs_plain(p[:3000], as_sketches(qs, cuda_device), 3000, 1024)
    launches = sampled_entry.kernel_launches
    empty = sampled_entry(p, as_sketches(qs, cuda_device)[:0], 3000,
                          sample_size=1024, metric=HAMMING)
    assert empty.shape == (0,) and sampled_entry.kernel_launches == launches


@pytest.mark.cuda
def test_sampled_entry_kernel_with_64_bit_keys(cuda_device):
    """A sample of 2^21 + 1 points at 33 words: the position takes 22 bits
    and the distance 11 of the 64-bit key (and the rows copy 4 bytes at a
    time). Held to the plain Hamming distance (``popcount_sum`` of the
    XOR) over the sample in row chunks on the card, then argmin (the
    plain version's float32 tables would take 9 GB a block); a tie at
    positions S - 3 and S - 1 goes to S - 3."""
    S, words, n, B = (1 << 21) + 1, 33, (1 << 21) + 5000, 20
    g = torch.Generator(device=cuda_device).manual_seed(21)
    p = torch.randint(-2**31, 2**31 - 1, (n, words), dtype=torch.int32,
                      device=cuda_device, generator=g)
    q = torch.randint(-2**31, 2**31 - 1, (B, words), dtype=torch.int32,
                      device=cuda_device, generator=g)
    ids = strided_sample_ids(n, S, device=cuda_device)
    p[ids[[S - 3, S - 1]].long()] = q[0]
    launches = sampled_entry.kernel_launches
    got = sampled_entry(p, q, n, sample_size=S, metric=HAMMING)
    sample = p[ids.long()]
    d = torch.cat([popcount_sum(q[:, None] ^ sample[None, s : s + 65_536])
                   for s in range(0, S, 65_536)], dim=1)
    want = ids[torch.argmin(d, dim=1)]
    torch.cuda.synchronize()
    assert sampled_entry.kernel_launches == launches + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(got[0]) == int(ids[S - 3])


@pytest.mark.cuda
def test_sampled_entry_kernel_raises_past_64_words(cuda_device):
    """Sketches wider than the kernel's raise on the card before any
    launch: no plain version runs on card tensors."""
    p = torch.zeros((100, 65), dtype=torch.int32, device=cuda_device)
    before = (sampled_entry.kernel_launches, sampled_entry.plain_calls)
    with pytest.raises(ValueError, match="words=65"):
        sampled_entry(p, p[:4], 100, sample_size=16, metric=HAMMING)
    assert (sampled_entry.kernel_launches, sampled_entry.plain_calls) == \
        before


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "mini"])
def test_knns_entry_on_the_kernel(cuda_device, route, monkeypatch):
    """knns on the card with an entry sample: one sampled entry launch a
    query batch, no plain call, and the answer of the same index on CPU
    tensors."""
    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.models import hnsw as port_hnsw
    from hnsw_itu_tpu_torch.models import nsw as port_nsw
    from hnsw_itu_tpu_torch.utils import make_dataset

    if route == "mini":
        monkeypatch.setattr(port_nsw, "_fused_query_eligible",
                            lambda *a, **kw: False)
    pts, qs = make_dataset(8, 1500, 100)
    opts = IndexOptions(ef_construction=48, connections=12,
                        max_connections=32, size=1500, batch_size=128,
                        host_warmup=1500)
    idx = []
    for dev in (cuda_device, "cpu"):
        b = port_hnsw.HNSWBuilder(opts, device=dev)
        b.extend_batched(pts)
        i = b.build()
        i.enable_inline()
        i.query_entry_sample, i.query_batch = 256, 32
        idx.append(i)
    card, cpu = idx
    before = (sampled_entry.kernel_launches, sampled_entry.plain_calls)
    got = card.knns(qs, 10, 48)
    torch.cuda.synchronize()
    assert card.last_route == route
    assert (sampled_entry.kernel_launches, sampled_entry.plain_calls) == \
        (before[0] + 4, before[1])  # 100 queries in batches of 32
    want = cpu.knns(qs, 10, 48)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
