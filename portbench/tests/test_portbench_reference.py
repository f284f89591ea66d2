"""The reference, the data generator and the metric arithmetic, on the
CPU at small sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness, trace
from portbench.reference import exact, generator, graph as rg, judge as jd

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def np_hamming(a, b):
    """[len(a), len(b)] Hamming distances by numpy's bit unpacking."""
    ab = np.unpackbits(a.view(np.uint8), axis=1)
    bb = np.unpackbits(b.view(np.uint8), axis=1)
    return (ab[:, None, :] != bb[None, :, :]).sum(-1)


def test_generator_is_deterministic_in_the_seed():
    seed = 2**31 + 5
    p1, q1 = generator.make_data(seed, 3000, 50, CPU)
    p2, q2 = generator.make_data(seed, 3000, 50, CPU)
    p3, _ = generator.make_data(seed + 1, 3000, 50, CPU)
    assert torch.equal(p1, p2) and torch.equal(q1, q2)
    assert not torch.equal(p1, p3)
    # the points do not depend on how many queries are drawn
    p4, _ = generator.make_data(seed, 3000, 20, CPU)
    assert torch.equal(p1, p4)
    assert p1.dtype == torch.int32 and p1.shape == (3000, 32)


def test_generator_hierarchy():
    """Flip rates, and points about 0.08 * 1024 bits from their nearest
    leaf, leaves several times farther apart than that."""
    g = generator.generator(7, "t", CPU)
    f = generator.flips(g, 2000, 0.08, CPU)
    rate = float(exact.popcount(f).sum()) / (2000 * 1024)
    assert abs(rate - 0.08) < 0.003
    lv = generator.leaves(7, 64, CPU)
    assert lv.shape == (64, 32)
    pts, _ = generator.make_data(7, 64 * 128, 10, CPU, n_leaf=64)
    d = np_hamming(pts[:500].numpy(), lv.numpy())  # [500, 64]
    near = d.min(1)
    assert abs(near.mean() - 0.08 * 1024) < 6
    dl = np_hamming(lv.numpy(), lv.numpy())
    assert np.median(dl[~np.eye(64, dtype=bool)]) > 3 * near.mean()
    assert generator.ROOTS == 64 and generator.MIDS == 4096
    assert (generator.P_MID, generator.P_LEAF, generator.P_POINT) == \
        (0.12, 0.06, 0.08)


@pytest.mark.parametrize("words", [None, 31, 7])
def test_exact_topk_equals_numpy_scan(words):
    pts, qs = generator.make_data(11, 5000, 64, CPU)
    w = words or 32
    want = np_hamming(qs[:, :w].contiguous().numpy(),
                      pts[:, :w].contiguous().numpy())
    order = np.lexsort((np.broadcast_to(np.arange(5000), want.shape),
                        want), axis=1)[:, :10]
    d, i = exact.exact_topk(pts, qs, 10, words=words, query_block=16)
    assert np.array_equal(i.numpy(), order)
    assert np.array_equal(d.numpy(), np.take_along_axis(want, order, 1))
    assert exact.check_topk(pts, qs, d, i, words) == 0
    assert exact.check_topk(pts, qs, d + 1, i, words) == 64


def test_exact_topk_blocks_and_rows(monkeypatch):
    """Several point blocks (merge across blocks), a row limit, and a
    population below k."""
    monkeypatch.setattr(exact, "_BLOCK_BITS", 9)
    pts, qs = generator.make_data(12, 3000, 16, CPU)
    want = np_hamming(qs.numpy(), pts[:1500].numpy())
    d, i = exact.exact_topk(pts, qs, 10, rows=1500)
    order = np.lexsort((np.broadcast_to(np.arange(1500), want.shape),
                        want), axis=1)[:, :10]
    assert np.array_equal(i.numpy(), order)
    d, i = exact.exact_topk(pts[:4], qs, 10)
    assert (i[:, 4:] == exact.INF).all() and (i[:, :4] < 4).all()


def test_exact_topk_per_query_limits(monkeypatch):
    """Each query's population ends at its own limit, across blocks."""
    monkeypatch.setattr(exact, "_BLOCK_BITS", 9)
    pts, qs = generator.make_data(13, 2000, 16, CPU)
    lim = torch.tensor([3, 600, 1999, 1024] * 4, dtype=torch.int32)
    d, i = exact.exact_topk(pts, qs, 5, limits=lim)
    for b in range(16):
        gd, gi = exact.exact_topk(pts, qs[b : b + 1], 5, rows=int(lim[b]))
        assert torch.equal(d[b : b + 1], gd) and torch.equal(i[b : b + 1],
                                                            gi)
    assert (i[0, 3:] == exact.INF).all() and (d[0, 3:] == exact.INF).all()


def test_nearest_gaps():
    """0 where a row lists its nearest earlier row, the distance past it
    where it lists a farther one, INF where it lists none before its
    limit."""
    pts, _ = generator.make_data(15, 400, 1, CPU)
    rows = torch.tensor([300, 301, 302])
    lim = torch.tensor([256, 256, 256])
    best, bi = exact.exact_topk(pts, pts[rows], 2, limits=lim.int())
    adj = torch.full((400, 4), -1, dtype=torch.int32)
    adj[300, :2] = torch.tensor([350, bi[0, 0]])  # a later row, the nearest
    adj[301, 0] = bi[1, 1]  # the second nearest
    adj[302, 0] = 399  # only a row past its limit
    g = rg.nearest_gaps(pts, adj, rows, lim)
    assert g.tolist() == [0, int(best[1, 1] - best[1, 0]), exact.INF]


def test_answer_judge():
    pts, qs = generator.make_data(13, 2000, 8, CPU)
    d, i = exact.exact_topk(pts, qs, 10)
    assert jd.bad_answer_rows(pts, qs, i, d, 2000) == 0
    assert float(jd.recall(i, i).mean()) == 1.0
    alt = i.clone()
    alt[0, 0] = (alt[0, 0] + 1) % 2000  # another id, distance kept
    assert jd.bad_answer_rows(pts, qs, alt, d, 2000) == 1
    dup = i.clone()
    dup[1, 1] = dup[1, 0]
    dd = d.clone()
    dd[1, 1] = dd[1, 0]
    assert jd.bad_answer_rows(pts, qs, dup, dd, 2000) == 1
    out = i.clone()
    out[2, 9] = 2000
    assert jd.bad_answer_rows(pts, qs, out, d, 2000) == 1
    rev = torch.flip(d, [1])
    assert jd.bad_answer_rows(pts, qs, torch.flip(i, [1]), rev, 2000) >= 7
    half = i.clone()
    half[:, 5:] = -1
    assert torch.allclose(jd.recall(half, i),
                          torch.full((8,), 0.5, dtype=torch.float64))


def test_graph_invariants():
    adj = torch.tensor([[1, 2, -1], [0, -1, -1], [0, 1, -1], [-1, -1, -1]],
                       dtype=torch.int32)
    deg = torch.tensor([2, 1, 2, 0], dtype=torch.int32)
    assert rg.bad_rows(adj, deg, 3) == 0
    assert rg.bad_rows(adj, deg, 4) == 1  # row 3 live but empty
    for r, c, v in [(0, 1, 0), (1, 1, 2), (2, 1, 0), (1, 0, 3)]:
        a = adj.clone()
        a[r, c] = v  # self, past deg, duplicate, out of range
        assert rg.bad_rows(a, deg, 3) == 1, (r, c, v)
    g = deg.clone()
    g[3] = 1
    assert rg.bad_rows(adj, g, 3) == 1  # a row past n holds a degree


def test_beam_search_on_a_full_graph_is_exact():
    pts, qs = generator.make_data(14, 300, 16, CPU)
    n = 300
    adj = torch.stack([torch.cat([torch.arange(0, r), torch.arange(r + 1, n)])
                       for r in range(n)]).to(torch.int32)
    entry = rg.strided_entry(pts, qs, n, 16)
    d, i = rg.beam_search(pts, adj, qs, entry, n=n, ef=32, k=10,
                          max_steps=64)
    gd, gi = exact.exact_topk(pts, qs, 10)
    assert torch.equal(d, gd) and torch.equal(i, gi)


def test_byte_counts():
    fused = harness.reader("fused_roofline")
    mini = harness.reader("mini_roofline")
    # steps 363,563, visited 5,282,000 over 10,000 queries, W=64, words 32,
    # ef 32: ids + sketches of visited nodes + queries, keys in, keys and
    # counts out
    assert fused.call_bytes(363_563, 5_282_000, 10_000, 64, 32, 32) == \
        363_563 * 256 + 5_282_000 * 128 + 10_000 * 132 + 10_000 * 128 \
        + 80_000
    assert mini.ids_first_bytes(1000, 5000, 10, 32, 31, 96) == \
        1000 * 128 + 5000 * 124 + 10 * 124 + 80 + 10 * 768 + 80
    rec = {"trace": {"window": (0.0, 10.0),
                     "device": [("fused_beam_search_kernel<64>", 0.0, 2.0),
                                ("sgemm", 1.0, 4.0), ("memcpy", 6.0, 7.0)],
                     "host": []},
           "search_stats": {0: {"steps": 10, "visited": 100,
                                "queries": 2}},
           "calls_per_batch": [3], "calls": 3, "kind": "query",
           "table": {"route": "fused", "W": 64, "words": 32, "ef": 32},
           "untraced": {"window_s": 12e-6, "calls": 4}}
    want = 100 * 3 * fused.call_bytes(10, 100, 2, 64, 32, 32) \
        / fused.HBM_BYTES_PER_S / 2e-6
    assert fused.read(rec) == pytest.approx(want)
    assert mini.read(rec) is None
    # 5 us busy over 3 traced calls; 3 us a call untraced
    assert harness.reader("device_idle_pct.query").read(rec) == \
        pytest.approx(100 * (1 - 5e-6 / 3 / 3e-6))
    assert harness.reader("torch_ops_ms.query").read(rec) == \
        pytest.approx(4e-3 / 3)
    assert harness.reader("device_idle_pct.build").read(rec) is None
    assert trace.breakdown(rec["trace"])["device_ops"][0] == \
        ["sgemm", 3e-6]


def test_build_readers():
    rec = {"kind": "build", "chunks": 4, "spans_ms": {"select": 40.0},
           "trace": {"window": (0.0, 10e3), "host": [],
                     "device": [("dma_beam_search_kernel<1>", 0.0, 8e3),
                                ("hamming_block_kernel", 8e3, 9e3)]}}
    assert harness.reader("kernel_ms.dma").read(rec) == pytest.approx(2.0)
    assert harness.reader("kernel_ms.hamming").read(rec) == \
        pytest.approx(0.25)
    assert harness.reader("build_span_ms.select").read(rec) == 10.0
    assert harness.reader("build_span_ms.apply").read(rec) is None
    assert harness.reader("device_idle_pct.build").read(rec) is None
    # 9 ms of device work per 4 chunks against 20 ms of host time a chunk
    # untraced
    rec["untraced"] = {"window_s": 0.1, "chunks": 5}
    assert harness.reader("device_idle_pct.build").read(rec) == \
        pytest.approx(100 * (1 - 9e-3 / 4 / 0.02))
    assert harness.reader("device_idle_pct.query").read(rec) is None
