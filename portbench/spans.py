"""The program's own ranges in a traced record, against the device's
busy time.

While ``torch.profiler`` records, the port opens a host range
``hnsw.<name>`` around each of its spans (``hnsw_itu_tpu_torch/utils/
instrument.py``): ``hnsw.knns`` and its parts in a query, ``hnsw.extend``
and the build's phases, ``hnsw.sync`` around each operation that makes
the host wait for the card. The profiler puts them on the device trace's
clock, so the device's idle time can be put down to the part of the
program the host was in. ``trace.summarize`` keeps them in
``rec["trace"]["host"]`` and drops their device-side mirrors, which are
no device operations.

Times in microseconds; an interval list is sorted (start, end) pairs
that do not overlap.
"""

from __future__ import annotations

import bisect

from portbench import trace

PREFIX = "hnsw."


def union(intervals) -> list:
    """The union of (start, end) pairs, as a sorted interval list."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def intersect(a, b) -> list:
    """The intersection of two interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b) -> list:
    """The part of interval list ``a`` outside interval list ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def ranges(tr, names) -> list:
    """The union of the host ranges ``hnsw.<name>`` for each of ``names``,
    clipped to the window."""
    w0, w1 = tr["window"]
    want = {PREFIX + n for n in names}
    return union((max(s, w0), min(e, w1)) for n, s, e in tr["host"]
                 if n in want)


def idle(tr) -> list:
    """The window's intervals in which no device operation ran."""
    return subtract([tuple(tr["window"])],
                    [tuple(iv) for iv in trace.busy_intervals(tr["device"])])


def idle_us(tr, inside, outside=()) -> float:
    """Microseconds of the window in which no device operation ran while
    the host was inside a range of ``inside`` (names without the prefix)
    and inside none of ``outside``."""
    where = subtract(ranges(tr, inside), ranges(tr, outside))
    return length(intersect(where, idle(tr)))


def count(tr, name: str) -> int:
    """Host ranges ``hnsw.<name>`` that overlap the window."""
    w0, w1 = tr["window"]
    return sum(1 for n, s, e in tr["host"]
               if n == PREFIX + name and e > w0 and s < w1)


def instrumented(tr) -> bool:
    """Did the program open any ``hnsw.`` range in the window? (A program
    without the spans opens none: its readers read nothing.)"""
    return any(n.startswith(PREFIX) for n, _, _ in tr["host"])


def traced(rec, kind: str, unit: str):
    """The trace of a traced record of traffic ``kind`` whose program
    opened its ranges, with something in ``rec[unit]``; else None."""
    tr = rec.get("trace")
    if rec.get("kind") != kind or not tr or not rec.get(unit) \
            or not instrumented(tr):
        return None
    return tr


def idle_ms_per(rec, kind: str, unit: str, inside, outside=()):
    """``idle_us`` in milliseconds per unit of ``rec[unit]`` (calls or
    chunks of the traced window), in a record of traffic ``kind``; None
    where there is nothing to read or no range of ``inside`` ran."""
    tr = traced(rec, kind, unit)
    if tr is None or not ranges(tr, inside):
        return None
    return idle_us(tr, inside, outside) / 1e3 / rec[unit]


# host calls that put one operation (a kernel, a copy, a set) on a stream
LAUNCHES = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy",
    "cudaMemcpy2DAsync", "cudaMemsetAsync", "cudaMemset", "cudaMemsetD8Async",
    "cudaMemsetD32Async", "cuMemsetD8Async", "cuMemsetD32Async",
    "cuMemcpyAsync", "cuMemcpyHtoDAsync_v2", "cuMemcpyDtoHAsync_v2",
})


def stream_span_us(tr, name: str, segment: str):
    """Microseconds of the ranges ``hnsw.<name>`` on the stream's clock,
    as a CUDA event pair around each would read them: from the moment the
    stream has done all work launched before the range (or the range's
    start, if later) to the moment it has done all work launched inside
    it (or the range's end, if later).

    Read per host range ``segment`` (the benchmark's own range around one
    call): each starts and ends with the stream drained, so the device
    operations that start inside it are the ones launched inside it, in
    launch order on the one stream. A segment whose count of launches
    (``LAUNCHES``) differs from its count of device operations cannot be
    matched and is left out. Returns (us, segments matched, segments)."""
    host, dev = tr["host"], tr["device"]  # each sorted by start
    hs, ds = [h[1] for h in host], [d[1] for d in dev]
    segs = [(s, e) for n, s, e in host if n == segment]
    want = PREFIX + name
    total, matched = 0.0, 0
    for c0, c1 in segs:
        inside = host[bisect.bisect_left(hs, c0):bisect.bisect_left(hs, c1)]
        launch = [s for n, s, _ in inside if n in LAUNCHES]
        ops = dev[bisect.bisect_left(ds, c0):bisect.bisect_left(ds, c1)]
        if len(launch) != len(ops):
            continue
        matched += 1
        done = [c0]  # done[k]: the stream has done the first k launches
        for _, _, e in ops:
            done.append(max(done[-1], e))

        def reached(t):
            return max(t, done[bisect.bisect_left(launch, t)])

        total += sum(reached(e) - reached(s) for n, s, e in inside
                     if n == want)
    return total, matched, len(segs)


def stream_span_ms_per_call(rec, name: str):
    """``stream_span_us`` of ``hnsw.<name>`` in milliseconds per
    ``portbench.call`` of a traced query record, over the calls it could
    match; None where there is nothing to read, no such range ran, or
    fewer than half the calls matched."""
    tr = traced(rec, "query", "calls")
    if tr is None or not ranges(tr, (name,)):
        return None
    us, matched, calls = stream_span_us(tr, name, "portbench.call")
    if not matched or 2 * matched < calls:
        return None
    return us / 1e3 / matched
