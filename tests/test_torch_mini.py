"""The port's mini-table query path against the JAX package on CPU tensors,
bit-exact (tolerance 0): the plain two-plane beam search against the XLA
two-key beam on truncated sketches and against the Pallas mini kernels in
interpret mode (d, ids, visited, steps); the reranks, the multi-seed
entry, the tie order and the table policy against their JAX functions; and
``HNSW.knns`` on the mini table against the JAX ``HNSW.knns`` mini path.
The CUDA kernel is held against the plain version on the card in
tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_itu_tpu.models import IndexOptions as JaxOptions
from hnsw_itu_tpu.models import nsw as jax_nsw
from hnsw_itu_tpu.models.hnsw import HNSWBuilder as JaxBuilder
from hnsw_itu_tpu.ops import pallas_dma_search as jdma
from hnsw_itu_tpu.ops.entry import sampled_entry_topk as jax_topk
from hnsw_itu_tpu.ops.metrics import get_metric as jax_metric
from hnsw_itu_tpu.ops.search import batched_beam_search
from hnsw_itu_tpu_torch.models import IndexOptions
from hnsw_itu_tpu_torch.models import hnsw as port_hnsw
from hnsw_itu_tpu_torch.models import nsw as port_nsw
from hnsw_itu_tpu_torch.models.nsw import _mini_config_for
from hnsw_itu_tpu_torch.ops.entry import sampled_entry, sampled_entry_topk
from hnsw_itu_tpu_torch.ops.metrics import HAMMING, as_sketches, popcount_sum
from hnsw_itu_tpu_torch.ops.mini_search import (DINF, IINF, bitrev_ids,
                                                materialize_mini,
                                                mini_beam_search,
                                                rerank_exact, rerank_onehop)
from hnsw_itu_tpu_torch.utils import make_dataset
from test_torch_kernels import MINI_CASES, mini_inputs, random_graph
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

INT32_MAX = np.iinfo(np.int32).max
CAP, WORDS, B = 256, 32, 32


def _port(pts, adj, qs, seeds, ef, mw, tie_bits=0):
    """The port's mini_beam_search on CPU tensors: (d, ids, vis, steps)
    as numpy, empty slots (DINF, IINF)."""
    calls = mini_beam_search.plain_calls
    table, q, d0, s = mini_inputs(pts, adj, qs, seeds, mw, "cpu")
    out = mini_beam_search(table, q, d0, s, ef=ef, mini_words=mw,
                           max_steps=256, tie_bits=tie_bits)
    assert mini_beam_search.plain_calls == calls + 1
    return [t.numpy() for t in out]


def _xla(pts, adj, qs, seeds, ef, mw, tie_bits=0):
    """The XLA beam (dedup="beam", expand=1) on the truncated sketches."""
    tp = jnp.asarray(pts[:, :mw])
    return batched_beam_search(
        lambda ids: tp[ids], jnp.asarray(adj), jnp.asarray(qs[:, :mw]),
        jnp.asarray(seeds), ef=ef, metric=jax_metric("hamming"),
        capacity=pts.shape[0], expand=1, max_steps=256, dedup="beam",
        tie_bits=tie_bits,
    )


def _assert_xla_equal(got, ref):
    d, i, vis, stp = got
    np.testing.assert_array_equal(np.where(d >= DINF, INT32_MAX, d),
                                  np.asarray(ref.dists))
    np.testing.assert_array_equal(np.where(i >= IINF, INT32_MAX, i),
                                  np.asarray(ref.ids))
    np.testing.assert_array_equal(vis, np.asarray(ref.visited))
    np.testing.assert_array_equal(stp, np.asarray(ref.steps))


def _graph(seed, w, E=1, cap=CAP):
    rng = np.random.default_rng(seed)
    pts, adj = random_graph(rng, cap, w, WORDS)
    qs = rng.integers(0, 2**32, size=(B, WORDS), dtype=np.uint32)
    if E == 1:
        seeds = np.zeros(B, np.int32)
    else:
        seeds = np.stack([rng.choice(cap, size=E, replace=False)
                          for _ in range(B)]).astype(np.int32)
    return pts, adj, qs, seeds


@pytest.mark.parametrize("w,ef,mw", MINI_CASES)
def test_plain_matches_xla_on_prefix(w, ef, mw):
    pts, adj, qs, seeds = _graph(w + ef + mw, w)
    _assert_xla_equal(_port(pts, adj, qs, seeds, ef, mw),
                      _xla(pts, adj, qs, seeds, ef, mw))


@pytest.mark.parametrize("ef,E", [(48, 4), (48, 8), (96, 8), (96, 4)])
def test_plain_multiseed_matches_xla(ef, E):
    pts, adj, qs, seeds = _graph(ef * 10 + E, 32, E)
    _assert_xla_equal(_port(pts, adj, qs, seeds, ef, 7),
                      _xla(pts, adj, qs, seeds, ef, 7))


@pytest.mark.parametrize("ef,E", [(48, 4), (96, 1)])
def test_plain_tie_bits_matches_xla(ef, E):
    """Ties ordered by the bit-reversed id: the same tie_bits in both."""
    pts, adj, qs, seeds = _graph(ef + E + 7, 32, E)
    _assert_xla_equal(_port(pts, adj, qs, seeds, ef, 3, tie_bits=8),
                      _xla(pts, adj, qs, seeds, ef, 3, tie_bits=8))


def test_plain_dedups_repeated_neighbors():
    """Rows that list a neighbor twice: the second copy is a duplicate, as
    in the XLA merge (the Pallas mini kernels keep both; ROADMAP §3)."""
    pts, adj, qs, seeds = _graph(21, 32)
    adj[:, 16:] = adj[:, :16]
    _assert_xla_equal(_port(pts, adj, qs, seeds, 48, 7),
                      _xla(pts, adj, qs, seeds, 48, 7))


@pytest.mark.parametrize("packed,w,ef,mw,E,tie", [
    ("never", 64, 48, 3, 1, 0),
    ("always", 32, 48, 7, 4, 8),
    ("span128", 32, 96, 7, 8, 8),
])
def test_plain_matches_pallas_interpret(packed, w, ef, mw, E, tie):
    """Each TPU mini kernel variant (#5 unpacked, #3 two queries per row,
    #4 span 128) in interpret mode gives the port's d, ids, visited and
    steps on its first ef lanes."""
    pts, adj, qs, seeds = _graph(w + ef + E, w, E)
    tq = qs[:, :mw]
    ps = pts[seeds][..., :mw]
    d0 = np.unpackbits((ps ^ (tq[:, None] if E > 1 else tq))
                       .view(np.uint8), axis=-1).sum(-1).astype(np.int32)
    mini = jdma.materialize_mini(jnp.asarray(pts), jnp.asarray(adj),
                                 mini_words=mw)
    want = jdma.mini_beam_search(
        mini, jnp.asarray(qs), jnp.asarray(d0), jnp.asarray(seeds), ef=ef,
        W=w, mini_words=mw, max_steps=256, block_q=B, interpret=True,
        packed=packed, tie_bits=tie,
    )
    got = _port(pts, adj, qs, seeds, ef, mw, tie_bits=tie)
    for g, x in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, np.asarray(x)[:, :ef])
    for g, x in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, np.asarray(x))


def test_mini_table_layout_matches_jax():
    """The port's [cap, W, 1 + mw] table holds the values of the JAX lane
    layout (neighbor n, word-index t at subrow t // REP, lane
    (t % REP) * W + n) wherever an edge exists; absent edges and padding
    hold id -1 and zero words."""
    rng = np.random.default_rng(4)
    cap, w, mw = 100, 24, 7  # width padded to 32
    pts, adj = random_graph(rng, cap, w, WORDS)
    adj[3, 5] = -1
    got = materialize_mini(as_sketches(pts, "cpu"), torch.from_numpy(adj),
                           mini_words=mw, tile=16).numpy()
    jm = np.asarray(jdma.materialize_mini(jnp.asarray(pts), jnp.asarray(adj),
                                          mini_words=mw))
    W = 32
    rep = 128 // W
    assert got.shape == (cap, W, 1 + mw)
    t = np.arange(1 + mw)
    want = jm[:, t[None, :] // rep,
              (t[None, :] % rep) * W + np.arange(W)[:, None]].view(np.int32)
    valid = np.zeros((cap, W), bool)
    valid[:, :w] = adj >= 0
    np.testing.assert_array_equal(got[valid], want[valid])
    assert (got[~valid][:, 0] == -1).all() and (got[~valid][:, 1:] == 0).all()


def test_bitrev_ids_matches_jax():
    rng = np.random.default_rng(3)
    for bits in (8, 19, 22):
        x = rng.integers(0, 1 << bits, size=4096).astype(np.int32)
        got = bitrev_ids(torch.from_numpy(x), bits)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jdma.bitrev_ids(jnp.asarray(x), bits)))
        np.testing.assert_array_equal(bitrev_ids(got, bits).numpy(), x)


@pytest.mark.parametrize("dedup", [False, True])
def test_rerank_exact_matches_jax(dedup):
    rng = np.random.default_rng(11)
    cap, H, k = 100, 24, 8
    pts = rng.integers(0, 2**32, size=(cap, WORDS), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(6, WORDS), dtype=np.uint32)
    cands = rng.integers(0, 40, size=(6, H)).astype(np.int32)  # many dups
    cands[1, 5] = -1
    cands[2, 7] = IINF
    cands[3, :] = IINF  # no valid candidate at all
    calls = rerank_exact.plain_calls
    got = rerank_exact(as_sketches(pts, "cpu"), as_sketches(qs, "cpu"),
                       torch.from_numpy(cands), k=k, dedup=dedup)
    assert rerank_exact.plain_calls == calls + 1
    want = jdma.rerank_exact(jnp.asarray(pts), jnp.asarray(qs),
                             jnp.asarray(cands), k=k, dedup=dedup)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k,seeds", [(6, 3), (6, 20), (200, 3),
                                     (200, 20)])
def test_rerank_onehop_matches_jax(k, seeds):
    """Also seeds > H (every candidate seeds) and k past the pool of
    H + seeds * W (the answer as wide as the pool)."""
    rng = np.random.default_rng(13)
    cap, w, H = 150, 8, 16
    pts, adj = random_graph(rng, cap, w, WORDS)
    qs = rng.integers(0, 2**32, size=(5, WORDS), dtype=np.uint32)
    cands = rng.integers(0, cap, size=(5, H)).astype(np.int32)
    cands[0, :14] = IINF  # fewer valid candidates than seeds
    calls = rerank_onehop.plain_calls
    got = rerank_onehop(as_sketches(pts, "cpu"), torch.from_numpy(adj),
                        as_sketches(qs, "cpu"), torch.from_numpy(cands),
                        k=k, seeds=seeds)
    assert rerank_onehop.plain_calls == calls + 1
    assert got[0].shape == (5, min(k, H + min(seeds, H) * w))
    want = jdma.rerank_onehop(jnp.asarray(pts), jnp.asarray(adj),
                              jnp.asarray(qs), jnp.asarray(cands), k=k,
                              seeds=seeds)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


@pytest.mark.parametrize("bad", ["points", "queries", "cand_ids", "adj"])
def test_rerank_wrappers_check_inputs(bad):
    """Either rerank raises, before it routes, on an input that is not
    int32 or that lies on another device than the queries; on inputs all
    on a device no route serves (meta); and on a negative k or seeds."""
    rng = np.random.default_rng(17)
    pts, adj = random_graph(rng, 64, 8, 8)
    args = {"points": as_sketches(pts, "cpu"),
            "queries": as_sketches(pts[:4], "cpu"),
            "cand_ids": torch.from_numpy(adj[:4]),
            "adj": torch.from_numpy(adj)}

    def refused(err, k=4, seeds=2, **over):
        a = dict(args, **over)
        calls = (rerank_exact.plain_calls, rerank_onehop.plain_calls)
        if bad != "adj" and seeds >= 0:  # rerank_exact: no adj, no seeds
            with pytest.raises(err):
                rerank_exact(a["points"], a["queries"], a["cand_ids"], k=k)
        with pytest.raises(err):
            rerank_onehop(a["points"], a["adj"], a["queries"],
                          a["cand_ids"], k=k, seeds=seeds)
        assert (rerank_exact.plain_calls,
                rerank_onehop.plain_calls) == calls

    refused(TypeError, **{bad: args[bad].to(torch.int64)})
    refused(ValueError, **{bad: args[bad].to("meta")})
    refused(ValueError, **{n: t.to("meta") for n, t in args.items()})
    refused(ValueError, k=-1)
    refused(ValueError, seeds=-1)


def test_sampled_entry_topk_matches_jax():
    """Ties in the sample go to the lowest position; column 0 is the
    single sampled entry."""
    pts, qs = make_dataset(2, 3000, 40)
    S, beams = 64, 6
    ids = (np.arange(S) * 3000) // S
    pts[ids[[3, 9, 30]]] = pts[ids[30]]  # a three-way tie in the sample
    qs[:2] = pts[ids[[30, 9]]]
    p, q = as_sketches(pts, "cpu"), as_sketches(qs, "cpu")
    got = sampled_entry_topk(p, q, 3000, sample_size=S, beams=beams,
                             metric=HAMMING)
    want = jax_topk(jnp.asarray(pts), jnp.asarray(qs), 3000, sample_size=S,
                    beams=beams, metric=jax_metric("hamming"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        got[0][:, 0].numpy(),
        sampled_entry(p, q, 3000, sample_size=S, metric=HAMMING).numpy())
    with pytest.raises(ValueError):
        sampled_entry_topk(p, q, 3000, sample_size=4, beams=5,
                           metric=HAMMING)


@pytest.mark.parametrize("budget", [4096 * 4096, 4096 * 64 * 32 * 4,
                                    4096 * 64 * 4 * 4, 1000])
def test_mini_config_matches_jax(budget, monkeypatch):
    """The same byte budget gives the same (W, mini_words) in both
    packages; 4096 rows x 4 KB gives (32, 31)."""
    pts = torch.zeros((4096, WORDS), dtype=torch.int32)
    adj = torch.zeros((4096, 64), dtype=torch.int32)
    got = _mini_config_for(pts, adj, HAMMING, budget)
    monkeypatch.setenv("HNSW_TPU_MINI_INTERPRET", "1")
    monkeypatch.setenv("HNSW_TPU_INLINE_QUERY_BYTES", str(budget))
    want = jax_nsw._mini_config_for(jnp.zeros((4096, WORDS), jnp.uint32),
                                    jnp.zeros((4096, 64), jnp.int32),
                                    jax_metric("hamming"))
    assert got == want
    if budget == 4096 * 4096:
        assert got == (32, 31)


def test_mini_config_without_budget_on_cpu():
    """CPU tensors and no budget: shape alone decides."""
    pts = torch.zeros((300, WORDS), dtype=torch.int32)
    for width, want in ((64, (64, 31)), (24, (32, 31)), (130, (0, 0))):
        adj = torch.zeros((300, width), dtype=torch.int32)
        assert _mini_config_for(pts, adj, HAMMING) == want


# -- the slice end to end ---------------------------------------------------

N, NQ, K, SAMPLE = 1500, 64, 10, 64
OPTS = dict(ef_construction=48, connections=12, max_connections=32, size=N,
            batch_size=128, host_warmup=N)


@pytest.fixture(scope="module")
def mini_indexes():
    """The JAX and the port's host-built index of the same data, each
    serving from its mini table (fused tables refused in both, as past
    2^21 points)."""
    pts, qs = make_dataset(6, N, NQ)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HNSW_TPU_MINI_INTERPRET", "1")
        mp.setattr(jax_nsw, "_fused_query_eligible", lambda *a, **kw: False)
        b = JaxBuilder(JaxOptions(**OPTS), metric="hamming")
        b.extend_batched(pts)
        jidx = b.build()
        jidx.enable_inline()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_nsw, "_fused_query_eligible", lambda *a, **kw: False)
        b = port_hnsw.HNSWBuilder(IndexOptions(**OPTS), device="cpu")
        b.extend_batched(pts)
        pidx = b.build()
        pidx.enable_inline()
    assert jidx.fused is None and pidx.fused is None
    assert jidx.mini is not None and pidx.mini is not None
    assert (pidx.mini_W, pidx.mini_words) == (jidx.mini_W, jidx.mini_words) \
        == (32, 31)
    for idx in (jidx, pidx):
        idx.query_entry_sample = SAMPLE
    return jidx, pidx, qs


@pytest.mark.parametrize("ef,hop,beams,tie", [
    (32, 0, 1, "auto"),
    (96, 0, 1, "auto"),
    (32, 4, 4, "bitrev"),
])
def test_knns_mini_path_matches_jax(mini_indexes, ef, hop, beams, tie,
                                    monkeypatch):
    jidx, pidx, qs = mini_indexes
    monkeypatch.setenv("HNSW_TPU_MINI_INTERPRET", "1")
    for idx in (jidx, pidx):
        idx.query_hop, idx.query_entry_beams, idx.query_tie = hop, beams, tie
    want = jidx.knns(qs, K, ef)
    calls = mini_beam_search.plain_calls
    rerank = rerank_onehop if hop else rerank_exact
    reranks = rerank.plain_calls
    got = pidx.knns(qs, K, ef)
    assert mini_beam_search.plain_calls == calls + 1
    assert rerank.plain_calls == reranks + 1
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    for key in ("visited_q", "steps_q"):
        np.testing.assert_array_equal(pidx.last_stats[key],
                                      jidx.last_stats[key])


def test_knns_mini_path_descent_matches_jax(mini_indexes, monkeypatch):
    """The mini path entered through the greedy descent
    (query_entry_sample=0): the port's descent on kernel #6's plain route,
    the JAX descent on its level inline rows (beam dedup)."""
    from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search

    jidx, pidx, qs = mini_indexes
    monkeypatch.setenv("HNSW_TPU_MINI_INTERPRET", "1")
    assert jidx.level_adj_pts is not None
    for idx in (jidx, pidx):
        idx.query_hop, idx.query_entry_beams, idx.query_tie = 0, 1, "auto"
        monkeypatch.setattr(idx, "query_entry_sample", 0)
    want = jidx.knns(qs, K, 32)
    calls = dma_beam_search.plain_calls
    got = pidx.knns(qs, K, 32)
    assert pidx.last_route == "mini"
    assert dma_beam_search.plain_calls == calls + len(pidx.levels) > calls
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    for key in ("visited_q", "steps_q"):
        np.testing.assert_array_equal(pidx.last_stats[key],
                                      jidx.last_stats[key])
