"""The port's spans (``hnsw_itu_tpu_torch/utils/instrument.py``) on CPU
tensors: off, a span is one shared ``nullcontext`` that records nothing
and opens no profiler range; under ``torch.profiler`` every span is a
host range ``hnsw.<name>``, nested as the program nests them (``knns``
around its entry and rerank; ``extend`` around the build's phases and
its host waits); results are the same with tracing on and off. The
CUDA-event side is held in tests/test_torch_multicard.py; on a card,
every host wait falls inside a ``sync`` range and ``timings`` holds only
the spans the benchmark reads (``cuda``-marked, last)."""

import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hnsw_itu_tpu_torch.models import IndexOptions, _build
from hnsw_itu_tpu_torch.models import nsw as port_nsw
from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
from hnsw_itu_tpu_torch.models.nsw import NSWBuilder
from hnsw_itu_tpu_torch.utils import instrument, make_dataset
from test_torch_kernels import cuda_device  # noqa: F401 (fixture)
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def _ranges(prof) -> list:
    """(name, start_ns, end_ns) of the program's ranges, by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(instrument.PREFIX)]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _inside(child, parents) -> bool:
    return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)


def _named(rs, name) -> list:
    return [r for r in rs if r[0] == instrument.PREFIX + name]


def _refuse_ranges(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_span_off_is_one_shared_nullcontext(monkeypatch):
    _refuse_ranges(monkeypatch)
    timings = {}
    a = instrument.span(None, "search", CPU)
    b = instrument.span(timings, "apply", CPU)  # no card: no events
    assert a is b is instrument.sync() is instrument.host_range("knns") \
        is instrument.span(None, "knns.entry", CPU)
    with a, b, instrument.sync():
        pass
    assert timings == {}
    x = torch.arange(6)
    assert torch.equal(instrument.masked(x, x % 2 == 0),
                       torch.tensor([0, 2, 4]))
    assert instrument.to_device(x, "meta").device.type == "meta"


def test_build_keeps_its_span_names():
    """The benchmark, the smoke script and the tests read them here."""
    assert _build._span is instrument.span
    assert _build.span_ms is instrument.span_ms


def test_spans_open_named_ranges_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with instrument.span(None, "outer", CPU):
            with instrument.sync():
                pass
            instrument.masked(torch.arange(4), torch.tensor(
                [True, False, True, False]))
            instrument.to_device(torch.arange(4), CPU)  # no wait: no range
            instrument.to_device(torch.arange(4), "meta")  # off the host
            with instrument.host_range("inner"):
                pass
    rs = _ranges(prof)
    assert [r[0] for r in rs] == ["hnsw.outer", "hnsw.sync", "hnsw.sync",
                                  "hnsw.sync", "hnsw.inner"]
    assert all(_inside(r, rs[:1]) for r in rs[1:])


def test_card_span_records_events_and_a_range(monkeypatch):
    """On a card with ``timings``, a span records its event pair and,
    under a profiler, also opens its range (events faked: no card here)."""

    class Event:
        def __init__(self, enable_timing=False):
            self.stream = None

        def record(self, stream=None):
            self.stream = stream

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream", device))
    card, timings = torch.device("cuda", 1), {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with instrument.span(timings, "select", card):
            pass
    assert [(s.stream, e.stream) for s, e in timings["select"]] == \
        [(("stream", card), ("stream", card))]
    assert [r[0] for r in _ranges(prof)] == ["hnsw.select"]


# -- the query path ----------------------------------------------------------

N, NQ, K = 800, 24, 10
OPTS = dict(ef_construction=32, connections=8, max_connections=32, size=N,
            batch_size=64, host_warmup=N)


@pytest.fixture(scope="module")
def indexes():
    """Two host-built indexes of the same data: one serving from its
    fused table, one from its mini table (the fused table refused, as
    tests/test_torch_mini.py does)."""
    pts, qs = make_dataset(9, N, NQ)
    return {r: _route_index(r, pts, CPU) for r in ("fused", "mini")}, qs


def _route_index(route, pts, device):
    """A host-built index of ``pts`` that serves ``route``."""
    with pytest.MonkeyPatch.context() as mp:
        if route == "mini":
            mp.setattr(port_nsw, "_fused_query_eligible",
                       lambda *a, **kw: False)
        b = HNSWBuilder(IndexOptions(**OPTS), device=device)
        b.extend_batched(pts)
        idx = b.build()
        idx.enable_inline()
    idx.query_entry_sample = 64
    idx.query_hop = 4
    assert idx.route(K, 32) == route
    return idx


@pytest.mark.parametrize("route", ["fused", "mini"])
def test_knns_spans_nest_and_leave_results_alone(indexes, route):
    idxs, qs = indexes
    idx = idxs[route]
    want = idx.knns(qs, K, 32)
    idx.timings = {}  # on: no card, so no events; the ranges still open
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = idx.knns(qs, K, 32)
    finally:
        idx.timings = None
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.dists, want.dists)
    rs = _ranges(prof)
    top = _named(rs, "knns")
    assert len(top) == 1
    parts = ["knns.entry"] + (["knns.rerank"] if route == "mini" else [])
    for name in parts:
        assert len(_named(rs, name)) == 1, name
        assert _inside(_named(rs, name)[0], top), name
    assert {r[0] for r in rs} == {instrument.PREFIX + n
                                  for n in ["knns"] + parts}
    # the rerank runs after the entry, inside the same call
    if route == "mini":
        assert _named(rs, "knns.entry")[0][2] <= \
            _named(rs, "knns.rerank")[0][1]


# -- the build path ----------------------------------------------------------

BN = 600
BUILD = dict(ef_construction=24, connections=6, max_connections=12,
             size=BN, batch_size=8, host_warmup=48, entry_sample=32,
             scan_group=2)


@pytest.mark.parametrize("kind", [HNSWBuilder, NSWBuilder],
                         ids=["hnsw", "nsw"])
def test_extend_spans_nest_and_leave_the_graph_alone(kind):
    pts, _ = make_dataset(4, BN, 1)
    graphs = []
    for traced in (False, True):
        b = kind(IndexOptions(**BUILD), device="cpu")
        b.extend_batched(pts[:400])
        if traced:
            b.timings = {}
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                b.extend_batched(pts[400:])
        else:
            b.extend_batched(pts[400:])
        g = b.base if kind is HNSWBuilder else b.graph
        graphs.append((g.adj.clone(), g.deg.clone(), b.ep))
    (a0, d0, e0), (a1, d1, e1) = graphs
    assert torch.equal(a0, a1) and torch.equal(d0, d1) and e0 == e1
    rs = _ranges(prof)
    ext = _named(rs, "extend")
    assert len(ext) == 1
    for name in ("entry", "search", "select", "apply"):
        assert _named(rs, name), name
        assert all(_inside(r, ext) for r in _named(rs, name)), name
    # at least the prune's nonzero in every apply, each inside its apply
    syncs = _named(rs, "sync")
    applies = _named(rs, "apply")
    assert len(syncs) >= len(applies)
    assert all(any(_inside(s, [a]) for s in syncs) for a in applies)
    assert all(_inside(s, ext) for s in syncs)
    # phases do not overlap one another
    phases = sorted((r for n in ("entry", "search", "select", "apply")
                     for r in _named(rs, n)), key=lambda r: r[1])
    assert all(p[2] <= q[1] for p, q in zip(phases, phases[1:]))


def test_drain_spill_waits_in_a_sync_range():
    """``drain_spill`` reads on the host whether spill entries are left."""
    pts, _ = make_dataset(4, 200, 1)
    b = NSWBuilder(IndexOptions(ef_construction=16, connections=4,
                                max_connections=4, size=200, batch_size=8,
                                host_warmup=0), device="cpu")
    b.extend_batched(pts)
    spill = b.spill.clone()
    spill[0, 0] = 1  # one entry left: a pass runs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _build.drain_spill(b.points, b.graph, spill, b.opts, max_passes=1)
    names = [r[0] for r in _ranges(prof)]
    assert names[0] == "hnsw.sync" and "hnsw.apply" in names


# -- on a card -----------------------------------------------------------------


class _Tracked:
    """A stand-in for ``torch.profiler.record_function`` that keeps the
    names of the open ranges in ``stack``."""

    stack: list = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.stack.append(self.name)

    def __exit__(self, *exc):
        self.stack.pop()
        return False


def _host_waits(fn) -> tuple:
    """(waits inside an ``hnsw.sync`` range, the open ranges at each wait
    outside one) that ``torch.cuda.set_sync_debug_mode("warn")`` reports
    while ``fn`` runs."""
    inside, outside, live = [0], [], [False]

    def show(message, category, filename, lineno, file=None, line=None):
        if not live[0] or "synchroniz" not in str(message):
            return
        if _Tracked.stack and _Tracked.stack[-1] == "hnsw.sync":
            inside[0] += 1
        else:
            outside.append((list(_Tracked.stack), str(message)))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            live[0] = True
            fn()
            live[0] = False
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return inside[0], outside


@pytest.mark.cuda
def test_every_host_wait_on_a_card_is_in_a_sync_range(cuda_device,
                                                      monkeypatch):
    """Each operation that makes the host wait for the card, as
    ``set_sync_debug_mode("warn")`` reports it, over a build group and a
    ``knns`` call on both table routes, lies inside an ``hnsw.sync``
    range (so ``host_syncs.build`` misses none); ``timings`` holds the
    spans the benchmark reads and no others."""
    monkeypatch.setattr(instrument, "profiling", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", _Tracked)
    pts, _ = make_dataset(4, BN, 1)
    b = HNSWBuilder(IndexOptions(**BUILD), device=cuda_device)
    b.extend_batched(pts[:400])
    b.timings = {}
    inside, outside = _host_waits(lambda: b.extend_batched(pts[400:]))
    assert outside == []
    assert inside > 0  # the prune's nonzero at least
    assert set(b.timings) == {"entry", "search", "select", "apply"}
    pts, qs = make_dataset(9, N, NQ)
    for route in ("fused", "mini"):
        idx = _route_index(route, pts, cuda_device)
        idx.knns(qs, K, 32)  # warm: the kernels build
        idx.timings = {}
        inside, outside = _host_waits(lambda: idx.knns(qs, K, 32))
        assert outside == [], route
        assert inside >= 1, route  # the queries' pageable copy
        assert set(idx.timings) == {"knns.entry"} | (
            {"knns.rerank"} if route == "mini" else set()), route
    assert _Tracked.stack == []
