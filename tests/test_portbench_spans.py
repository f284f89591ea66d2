"""The benchmark's readers of the program's own ranges
(``portbench/spans.py`` and the metrics that call it) on hand-built
traced records: the interval arithmetic, the window's edges, a range's
device-side mirror, and a reader's silence on a record it cannot read
(another traffic kind, no trace, a program without the ranges)."""

import pytest

from portbench import harness, spans, trace

W = (100.0, 200.0)  # the window, in microseconds


def _rec(kind, host, device, **kw):
    unit = {"query": "calls", "build": "chunks"}[kind]
    rec = {"kind": kind, unit: 2,
           "trace": {"window": W, "host": host, "device": device}}
    rec.update(kw)
    return rec


def test_interval_arithmetic():
    a = spans.union([(5, 8), (0, 2), (1, 3), (9, 9)])
    assert a == [(0, 3), (5, 8)]
    b = [(2, 6), (7, 10)]
    assert spans.intersect(a, b) == [(2, 3), (5, 6), (7, 8)]
    assert spans.subtract(a, b) == [(0, 2), (6, 7)]
    assert spans.subtract([(0, 10)], [(0, 1), (3, 4), (9, 12)]) == \
        [(1, 3), (4, 9)]
    assert spans.length(spans.subtract(a, [])) == 6


@pytest.mark.parametrize("inside,outside,want", [
    # hnsw.knns from 90 (before the window) to 150: clipped to [100, 150];
    # busy [120, 130] inside it
    (("knns",), (), 40.0),
    # the entry [140, 160] taken out: [100, 140] less the busy 10 us
    (("knns",), ("knns.entry",), 30.0),
    # the entry alone: [140, 150] idle, [150, 160] idle (the range is
    # the entry's own, whether or not the call's range still runs)
    (("knns.entry",), (), 20.0),
    # a range running past the window's end: [190, 200] of it counts
    (("tail",), (), 10.0),
])
def test_idle_inside_and_outside(inside, outside, want):
    tr = {"window": W, "device": [("k", 120.0, 130.0)],
          "host": [("hnsw.knns", 90.0, 150.0),
                   ("hnsw.knns.entry", 140.0, 160.0),
                   ("hnsw.tail", 190.0, 260.0),
                   ("aten::mm", 100.0, 200.0)]}
    assert spans.idle_us(tr, inside, outside) == pytest.approx(want)


class _Event:
    def __init__(self, name, device, s_us, e_us):
        self._n, self._d, self._s, self._e = name, device, s_us, e_us

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return int(self._s * 1e3)

    def duration_ns(self):
        return int((self._e - self._s) * 1e3)


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_a_ranges_device_mirror_is_not_busy():
    """``trace.summarize`` drops the device-side copy of a host range, so
    the call's idle is what no device operation covered."""
    prof = _Prof([_Event(trace.WINDOW, False, 100, 200),
                  _Event("hnsw.knns", False, 110, 190),
                  _Event("hnsw.knns", True, 112, 195),  # its mirror
                  _Event("fused_beam_search_kernel", True, 150, 170)])
    tr = trace.summarize(prof)
    assert [n for n, _, _ in tr["device"]] == ["fused_beam_search_kernel"]
    assert spans.idle_us(tr, ("knns",)) == pytest.approx(60.0)
    rec = {"kind": "query", "calls": 3, "trace": tr}
    assert harness.reader("device_idle_ms.knns").read(rec) == \
        pytest.approx(60.0 / 1e3 / 3)


def _calls():
    """Two calls on the stream's clock. Call 1: the entry launches two
    kernels, the second queued behind the first and ending after the
    entry's host range; the rerank launches one, which waits for them.
    Call 2: one entry kernel that starts after its range has ended."""
    host = [("portbench.call", 100.0, 150.0),
            ("hnsw.knns", 100.0, 140.0),
            ("hnsw.knns.entry", 102.0, 110.0),
            ("cudaLaunchKernel", 103.0, 104.0),
            ("cudaLaunchKernel", 105.0, 106.0),
            ("hnsw.knns.rerank", 112.0, 118.0),
            ("cudaLaunchKernel", 113.0, 114.0),
            ("cudaMemcpyAsync", 141.0, 144.0),
            ("portbench.call", 150.0, 200.0),
            ("hnsw.knns", 150.0, 165.0),
            ("hnsw.knns.entry", 152.0, 154.0),
            ("cudaLaunchKernel", 153.0, 153.5),
            ("cudaMemcpyAsync", 170.0, 173.0)]
    device = [("k1", 104.0, 108.0), ("k2", 108.0, 125.0),
              ("k3", 125.0, 135.0), ("Memcpy DtoH", 141.0, 143.0),
              ("k4", 160.0, 161.0), ("Memcpy DtoH", 171.0, 172.0)]
    return host, device


def test_stream_spans_read_as_event_pairs():
    host, device = _calls()
    tr = {"window": W, "host": host, "device": device}
    # entry: call 1 from 102 to 125 (k2's end), call 2 from 152 to 161;
    # rerank: from 125 (the stream reaches it) to 135
    assert spans.stream_span_us(tr, "knns.entry", "portbench.call") == \
        (23.0 + 9.0, 2, 2)
    assert spans.stream_span_us(tr, "knns.rerank", "portbench.call") == \
        (10.0, 2, 2)
    # a call whose launches and device operations do not pair up (a
    # launch the profiler did not see) is left out
    lost = [h for h in host if h[1] != 153.0]
    assert spans.stream_span_us(dict(tr, host=lost), "knns.entry",
                                "portbench.call") == (23.0, 1, 2)


def test_query_readers():
    host, device = _calls()
    rec = _rec("query", host, device)
    read = {m: harness.reader(m).read for m in (
        "query_span_ms.entry", "query_span_ms.rerank",
        "device_idle_ms.knns")}
    assert read["query_span_ms.entry"](rec) == pytest.approx(16e-3)
    assert read["query_span_ms.rerank"](rec) == pytest.approx(5e-3)
    # idle inside hnsw.knns: [100, 104], [135, 140], [150, 160], [161, 165]
    assert read["device_idle_ms.knns"](rec) == pytest.approx(23e-3 / 2)
    # the fused route opens no rerank range
    fused = [h for h in host if h[0] != "hnsw.knns.rerank"]
    assert read["query_span_ms.rerank"](dict(rec, trace=dict(
        rec["trace"], host=fused))) is None
    # fewer than half the calls matched: nothing
    lost = [h for h in host if h[0] != "cudaLaunchKernel"]
    assert read["query_span_ms.entry"](dict(rec, trace=dict(
        rec["trace"], host=lost))) is None
    # another kind, no trace, a program without the ranges: nothing
    for r in read.values():
        assert r(dict(rec, kind="build", chunks=2)) is None
        assert r({"kind": "query", "calls": 2}) is None
        assert r(_rec("query", [h for h in host
                                if not h[0].startswith("hnsw.")],
                      device)) is None


def test_build_readers():
    host = [("hnsw.extend", 100.0, 200.0),
            ("hnsw.entry", 100.0, 110.0),
            ("hnsw.search", 110.0, 130.0),
            ("hnsw.select", 130.0, 150.0),
            ("hnsw.apply", 150.0, 190.0),
            ("hnsw.sync", 160.0, 165.0),
            ("hnsw.sync", 170.0, 175.0),
            ("hnsw.sync", 90.0, 95.0),  # before the window
            ("hnsw.sync", 195.0, 230.0)]  # overlaps its end
    device = [("dma_beam_search_kernel", 112.0, 128.0),
              ("hamming_block_kernel", 135.0, 140.0),
              ("sort", 155.0, 160.0)]
    rec = _rec("build", host, device)
    idle = {m: harness.reader(f"device_idle_ms.{m}").read(rec)
            for m in ("select", "apply", "extend")}
    # per chunk (2 chunks): select 20 - 5 us, apply 40 - 5 us, extend
    # [190, 200] outside every phase
    assert idle == pytest.approx({"select": 15e-3 / 2, "apply": 35e-3 / 2,
                                  "extend": 10e-3 / 2})
    entry_search = spans.idle_us(rec["trace"], ("entry", "search"))
    outside = spans.length(spans.intersect(
        spans.subtract([W], spans.ranges(rec["trace"], ("extend",))),
        spans.idle(rec["trace"])))
    window_idle = spans.length(spans.idle(rec["trace"]))
    assert 1e3 * 2 * sum(idle.values()) + entry_search + outside == \
        pytest.approx(window_idle)
    assert harness.reader("host_syncs.build").read(rec) == 3 / 2
    for m in ("device_idle_ms.select", "device_idle_ms.apply",
              "device_idle_ms.extend", "host_syncs.build"):
        r = harness.reader(m).read
        assert r(dict(rec, kind="query", calls=2)) is None
        assert r({"kind": "build", "chunks": 2}) is None
        assert r(_rec("build", [("portbench.group", 100.0, 200.0)],
                      device)) is None


def test_host_launches_count_a_graph_launch_as_one():
    """``host_launches.knns``: the launch calls inside each
    ``portbench.call``, a graph launch one of them, averaged over the
    calls; a launch outside every call is not counted."""
    read = harness.reader("host_launches.knns").read
    host, device = _calls()
    # call 1: three kernels and a copy; call 2: a kernel and a copy
    assert read(_rec("query", host, device)) == pytest.approx(3.0)
    graphed = [("portbench.call", 100.0, 150.0),
               ("hnsw.knns", 100.0, 140.0),
               ("cudaMemcpyAsync", 101.0, 102.0),
               ("hnsw.knns.graph", 103.0, 106.0),
               ("cudaGraphLaunch", 104.0, 105.0),
               ("cudaMemcpyAsync", 141.0, 144.0),
               ("portbench.call", 150.0, 200.0),
               ("hnsw.knns", 150.0, 165.0),
               ("hnsw.knns.graph", 151.0, 154.0),
               ("cudaGraphLaunch_v10000", 152.0, 153.0),
               ("cudaLaunchKernel", 201.0, 202.0)]  # after the calls
    # call 1: the upload, the graph, a copy out; call 2: the graph
    assert read(_rec("query", graphed, device)) == pytest.approx(2.0)
    # another kind, no trace, no calls, a program without the ranges
    assert read(_rec("build", graphed, device)) is None
    assert read({"kind": "query", "calls": 2}) is None
    assert read(_rec("query", [h for h in graphed
                               if h[0] != "portbench.call"], device)) is None
    assert read(_rec("query", [h for h in graphed
                               if not h[0].startswith("hnsw.")],
                     device)) is None
