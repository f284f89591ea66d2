"""The query step's CUDA graphs (``hnsw_itu_tpu_torch/models/
step_graphs.py``): on CPU tensors, the policy with the capture stubbed
behind the same cache class (the key, capture on second sight, the LRU
bound, the eager cases, the counters, answers that alias nothing); on a
card (``cuda``-marked), replays held bit for bit to the eager step on
both table routes and on a shard of a ``ShardedHNSW``."""

import pickle
from types import SimpleNamespace

import pytest
import torch

from hnsw_itu_tpu_torch.graph import GraphArrays
from hnsw_itu_tpu_torch.models import IndexOptions
from hnsw_itu_tpu_torch.models import nsw as port_nsw
from hnsw_itu_tpu_torch.models import step_graphs
from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
from hnsw_itu_tpu_torch.models.step_graphs import (KEPT, StepGraph,
                                                   StepGraphs, pack,
                                                   taken_back, unpack)
from hnsw_itu_tpu_torch.ops.fused_search import FusedTable
from hnsw_itu_tpu_torch.ops.metrics import as_points
from hnsw_itu_tpu_torch.utils import make_dataset
from test_torch_kernels import cuda_device  # noqa: F401 (fixture)
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

N, NQ, K, EF = 800, 24, 10, 32
OPTS = dict(ef_construction=32, connections=8, max_connections=32, size=N,
            batch_size=64, host_warmup=N)
# (route, entry beams, hop) of the indexes the tests serve
ROUTES = {"fused": ("fused", 1, 0), "mini": ("mini", 1, 4),
          "mini-beams": ("mini", 3, 4)}


def _route_index(route, pts, device, beams=1, hop=0):
    """A host-built index of ``pts`` that serves ``route`` from a 64-point
    sampled entry."""
    with pytest.MonkeyPatch.context() as mp:
        if route == "mini":
            mp.setattr(port_nsw, "_fused_query_eligible",
                       lambda *a, **kw: False)
        b = HNSWBuilder(IndexOptions(**OPTS), device=device)
        b.extend_batched(pts)
        idx = b.build()
        idx.enable_inline()
    idx.query_entry_sample = 64
    idx.query_entry_beams, idx.query_hop = beams, hop
    assert idx.route(K, EF) == route
    return idx


@pytest.fixture(scope="module")
def data():
    return make_dataset(9, N, 4 * NQ)


@pytest.fixture(scope="module")
def indexes(data):
    pts, _ = data
    return {name: _route_index(route, pts, "cpu", beams, hop)
            for name, (route, beams, hop) in ROUTES.items()}


def _fake_q(rows=NQ, words=32):
    """What ``_graph_key`` reads of a batch on a card."""
    return SimpleNamespace(device=torch.device("cuda", 0),
                           dtype=torch.int32, shape=(rows, words))


# -- the key ---------------------------------------------------------------


def _change(idx, what, mp):
    """Change one thing a step's launches read."""
    if what == "n":
        mp.setattr(idx, "n", idx.n - 1)
    elif what == "points":
        mp.setattr(idx, "points", idx.points.clone())
    elif what == "fused table":
        mp.setattr(idx, "fused", FusedTable(idx.fused.ids,
                                            idx.fused.data.clone()))
    elif what == "mini table":
        mp.setattr(idx, "mini", idx.mini.clone())
    elif what == "base graph":
        mp.setattr(idx, "base", GraphArrays(idx.base.adj.clone(),
                                            idx.base.deg))
    else:  # a query setting
        mp.setattr(idx, what, getattr(idx, what) + 1)


@pytest.mark.parametrize("route,what", [
    ("fused", "n"), ("fused", "points"), ("fused", "fused table"),
    ("fused", "query_entry_sample"), ("mini", "n"), ("mini", "points"),
    ("mini", "mini table"), ("mini", "base graph"),
    ("mini", "query_entry_beams"), ("mini", "query_hop")])
def test_key_misses_after_a_change(indexes, route, what, monkeypatch):
    idx, q = indexes[route], _fake_q()
    key = idx._graph_key(q, K, EF, route)
    assert key is not None and key == idx._graph_key(q, K, EF, route)
    _change(idx, what, monkeypatch)
    assert idx._graph_key(q, K, EF, route) != key


@pytest.mark.parametrize("route", ["fused", "mini"])
def test_key_holds_the_call_and_the_batch(indexes, route):
    idx = indexes[route]
    key = idx._graph_key(_fake_q(), K, EF, route)
    assert idx._graph_key(_fake_q(rows=NQ + 1), K, EF, route) != key
    assert idx._graph_key(_fake_q(), K + 1, EF, route) != key
    assert idx._graph_key(_fake_q(), K, EF + 1, route) != key
    idx.max_steps = 99
    try:
        assert idx._graph_key(_fake_q(), K, EF, route) != key
    finally:
        idx.max_steps = None


@pytest.mark.parametrize("case", ["general route", "cpu tensors",
                                  "timings", "walk entry", "empty batch"])
def test_no_key_where_the_step_runs_eager(indexes, case, monkeypatch):
    idx, q, route = indexes["fused"], _fake_q(), "fused"
    if case == "general route":
        route = "general"
    elif case == "cpu tensors":
        q = SimpleNamespace(device=torch.device("cpu"), dtype=torch.int32,
                            shape=(NQ, 32))
    elif case == "timings":
        monkeypatch.setattr(idx, "timings", {})
    elif case == "walk entry":
        monkeypatch.setattr(idx, "query_entry_sample", 0)
    else:
        q = _fake_q(rows=0)
    assert idx._graph_key(q, K, EF, route) is None


# -- the cache, with the capture stubbed ------------------------------------


class _Replayer:
    """A stand-in CUDA graph: ``replay`` runs the step on the static
    query buffer into the static output, launching nothing it counts."""

    def __init__(self, step, static_q, static_out):
        self.step, self.static_q, self.static_out = step, static_q, \
            static_out

    def replay(self):
        with taken_back():
            self.static_out.copy_(pack(self.step(self.static_q)))


def fake_capture(step, q):
    """The CUDA capture's bookkeeping on any device: the eager step
    answers ``q``; the 'captured' step's counts are taken back."""
    static_q = q.clone()
    out = step(q)
    counts = []
    with taken_back(into=counts):
        static_out = pack(step(static_q))
    return out, StepGraph(_Replayer(step, static_q, static_out), static_q,
                          static_out, [t.shape for t in out], counts)


def _counters():
    return (StepGraphs.captures, StepGraphs.replays, StepGraphs.eager_steps)


def _since(before):
    return tuple(a - b for a, b in zip(_counters(), before))


def _toy_step(calls):
    def step(q):
        calls.append(q.shape[0])
        return (q[:, :2] + 1, q[:, :2] * 2, q[:, 0], q[:, 1])
    return step


def test_capture_on_second_sight_then_replay():
    graphs, calls = StepGraphs(capture=fake_capture), []
    step = _toy_step(calls)
    q = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    before = _counters()
    outs = [graphs.run("a", q + i, step) for i in range(4)]
    assert _since(before) == (1, 2, 1)
    # eager, then the capture's eager answer and its capture, then the
    # replays (the stub runs the step once more in each)
    assert calls == [4] * 5
    for i, out in enumerate(outs):
        for got, want in zip(out, step(q + i)):
            assert torch.equal(got, want)
    # no key: eager every time, nothing remembered
    for _ in range(3):
        graphs.run(None, q, step)
    assert _since(before) == (1, 2, 4)
    assert list(graphs.graphs) == ["a"] and not graphs.seen


def test_lru_keeps_the_last_kept_graphs():
    graphs, step = StepGraphs(capture=fake_capture), _toy_step([])
    q = torch.zeros((2, 3), dtype=torch.int32)
    keys = list(range(KEPT + 2))
    for key in keys:
        graphs.run(key, q, step)
        graphs.run(key, q, step)
    assert list(graphs.graphs) == keys[-KEPT:]
    # using the oldest kept graph makes it the newest
    before = _counters()
    graphs.run(keys[2], q, step)
    assert _since(before) == (0, 1, 0)
    assert list(graphs.graphs)[-1] == keys[2]
    # an evicted key starts over: eager once, then captured
    graphs.run(keys[0], q, step)
    graphs.run(keys[0], q, step)
    assert _since(before) == (1, 1, 1)
    assert keys[3] not in graphs.graphs  # the least recently used went
    # keys seen once are bounded too
    for key in range(100, 100 + 2 * KEPT):
        graphs.run(key, q, step)
    assert list(graphs.seen) == list(range(100 + KEPT, 100 + 2 * KEPT))


def test_a_copied_cache_starts_empty():
    graphs = StepGraphs(capture=fake_capture)
    q = torch.zeros((2, 3), dtype=torch.int32)
    for _ in range(2):
        graphs.run("a", q, _toy_step([]))
    copy = pickle.loads(pickle.dumps(graphs))
    assert not copy.graphs and not copy.seen
    assert copy._capture == copy._capture_cuda


def test_unpack_gives_contiguous_views_of_pack():
    d = torch.arange(12, dtype=torch.int32).reshape(3, 4)[:, :2]
    out = (d, d + 100, torch.arange(3, dtype=torch.int32),
           torch.arange(3, dtype=torch.int32) * 7)
    flat = pack(out)
    got = unpack(flat, [t.shape for t in out])
    for g, w in zip(got, out):
        assert torch.equal(g, w) and g.is_contiguous()
        assert g.untyped_storage().data_ptr() == \
            flat.untyped_storage().data_ptr()
    with pytest.raises(TypeError):
        pack((d.float(),))


def _graphed(idx, monkeypatch):
    """``idx`` with the stubbed capture, its CPU batches keyed as if they
    lay on a card."""
    key = type(idx)._graph_key
    monkeypatch.setattr(idx, "_graphs", StepGraphs(capture=fake_capture))
    monkeypatch.setattr(idx, "_graph_key", lambda q, k, ef, route: key(
        idx, _fake_q(*q.shape), k, ef, route))


def _launches():
    return [getattr(fn, c) for fn, c in step_graphs.STEP_COUNTERS]


def _knns_all(idx, batches):
    """(answers, stats, the kernel wrappers' counts) of one knns a
    batch."""
    before, out, stats = _launches(), [], []
    for b in batches:
        out.append(idx.knns(b, K, EF))
        stats.append(idx.last_stats)
    return out, stats, [a - b for a, b in zip(_launches(), before)]


@pytest.mark.parametrize("name", list(ROUTES))
def test_index_steps_replay_the_eager_answers(indexes, data, name,
                                              monkeypatch):
    """knns through the cache on CPU tensors: the answers, the stats and
    the kernel wrappers' counts of every batch are the eager step's; a
    first answer is unchanged by the replays after it."""
    idx, (_, qs) = indexes[name], data
    batches = [qs[i * NQ : (i + 1) * NQ] for i in range(4)]
    want, want_stats, want_counts = _knns_all(idx, batches)
    _graphed(idx, monkeypatch)
    before = _counters()
    got, stats, counts = _knns_all(idx, batches)
    assert _since(before) == (1, 2, 1)
    # one plain call of the beam search and of the rerank or entry a batch
    assert counts == want_counts and sum(counts) >= 2 * len(batches)
    # read after every call: an answer aliasing the graph's buffers would
    # hold the last batch's
    for g, w, s, ws in zip(got, want, stats, want_stats):
        assert torch.equal(g.ids, w.ids) and torch.equal(g.dists, w.dists)
        assert (s["visited_q"] == ws["visited_q"]).all()
        assert (s["steps_q"] == ws["steps_q"]).all()
    assert not torch.equal(got[2].ids, got[3].ids)


def test_a_batch_seen_once_never_captures(indexes, data, monkeypatch):
    """``search_one`` and a tail batch: one-off shapes stay eager."""
    idx, (_, qs) = indexes["fused"], data
    _graphed(idx, monkeypatch)
    before = _counters()
    idx.query_batch = NQ
    try:
        idx.knns(qs[: NQ + 5], K, EF)  # a full batch and a tail of 5
        idx.search(qs[0], K, EF)
    finally:
        idx.query_batch = 1024
    assert _since(before) == (0, 0, 3)


# -- on a card ---------------------------------------------------------------


@pytest.fixture(scope="module")
def card_indexes(data):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    pts, _ = data
    return {name: _route_index(route, pts, "cuda", beams, hop)
            for name, (route, beams, hop) in ROUTES.items()}


def _eager(idx, q, route):
    return idx._step_eager(q, K, EF, route)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ROUTES))
def test_card_replay_equals_the_eager_step(card_indexes, data, name):
    """Successive replays on different queries, each bit for bit the
    eager step of its batch (dists, ids, visited, steps), also once later
    replays have run; the kernel wrappers' counts of the eager steps."""
    idx, (_, qs) = card_indexes[name], data
    route = ROUTES[name][0]
    q = as_points(qs, "cuda")
    batches = [q[i * NQ : (i + 1) * NQ] for i in range(4)]
    sent = batches + batches[:1]
    before, launches = _counters(), _launches()
    got = [idx._step(b, K, EF, route) for b in sent]
    torch.cuda.synchronize()
    assert _since(before) == (1, 3, 1)
    counts, launches = [a - b for a, b in zip(_launches(), launches)], \
        _launches()
    want = [_eager(idx, b, route) for b in sent]
    assert counts == [a - b for a, b in zip(_launches(), launches)]
    assert sum(counts) >= 2 * len(sent)  # the kernels, launched
    # read after every replay: an answer aliasing the graph's buffers
    # would hold the last batch's
    for out, w in zip(got, want):
        for a, b in zip(out, w):
            assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(got[4], got[0]))
    # the replay's answers share no memory with the graph's buffers
    g = next(iter(idx._graphs.graphs.values()))
    held = {g.static_out.untyped_storage().data_ptr(),
            g.static_q.untyped_storage().data_ptr()}
    assert not {t.untyped_storage().data_ptr() for t in got[3]} & held


@pytest.mark.cuda
def test_card_shard_replays_equal_the_eager_shards(data, cuda_device):
    """A two-shard ``ShardedHNSW`` on one card: each shard's step
    captures on the second call and replays after, and the merged
    answers equal the shards' eager steps."""
    from hnsw_itu_tpu_torch.parallel import ShardedHNSW, make_mesh

    pts, qs = data
    idx = ShardedHNSW.build(pts, IndexOptions(**OPTS),
                            mesh=make_mesh(devices=[cuda_device] * 2))
    idx.enable_inline()
    idx.query_entry_sample = 64
    q = as_points(qs[:NQ], cuda_device)
    before = _counters()
    got = [idx.knns(q, K, EF) for _ in range(3)]
    assert _since(before) == (2, 2, 2)
    for sh in idx.shards:
        sh.timings = {}
    try:
        want = idx.knns(q, K, EF)
    finally:
        for sh in idx.shards:
            sh.timings = None
    for g in got:
        assert torch.equal(g.ids, want.ids)
        assert torch.equal(g.dists, want.dists)
    idx.close()
