"""The traced run's record, from ``torch.profiler`` over the window.

The benchmark marks its own spans with ``torch.profiler.record_function``
(``portbench.window`` around the traced window, ``portbench.call`` or
``portbench.group`` around each call into the program). After the
window, the profiler's events are reduced to plain lists that the
metric readers take: device operations (kernels, copies, sets) and host
operations, each as (name, start_us, end_us), clipped to the window.

The profiler slows the host: each launch costs more while it records
(by half at 1M and in the build, whichever activities it records). A
traced run therefore first runs the same traffic untraced for as long
(``untraced`` in the record), and the idle share is taken against that
window's host seconds per call (``untraced_idle_pct``): the device's
work per call is the same either way, the host's is not.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import time

WINDOW = "portbench.window"
# the program's own CUDA kernels (hnsw_itu_tpu_torch/csrc/*.cu), by the
# name of their __global__ function
PORT_KERNELS = {
    "fused": "fused_beam_search_kernel",
    "mini": "mini_beam_search_kernel",
    "dma": "dma_beam_search_kernel",
    "hamming": "hamming_block_kernel",
}


class Phases:
    """Host-clock seconds of named set-up phases, each ended by a
    synchronize of the card (``laps``: name -> seconds)."""

    def __init__(self, t0: float):
        self.last, self.laps = t0, {}

    def lap(self, name: str, device) -> None:
        import torch

        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        self.laps[name] = now - self.last
        self.last = now


@contextlib.contextmanager
def no_gc():
    """The window without the cycle collector's pauses: collect first,
    then hold it off until the window ends."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


@contextlib.contextmanager
def profiled(on: bool, cuda: bool):
    """A ``torch.profiler.profile`` of host and device activity over the
    block, marked as ``WINDOW``, when ``on``, else nothing; yields the
    profiler or None."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield prof


def _events(prof):
    """(name, is_device, start_us, end_us) of every profiled event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        out.append((e.name(), "cuda" in str(e.device_type()).lower(), s,
                    s + e.duration_ns() / 1e3))
    return out


def summarize(prof) -> dict:
    """{"window": (start_us, end_us), "device": [(name, s, e)], "host":
    [(name, s, e)]}, clipped to the ``portbench.window`` span; device
    events named as a host event (``record_function`` ranges mirrored on
    the device's timeline) are left out."""
    evs = _events(prof)
    win = [(s, e) for n, d, s, e in evs if n == WINDOW and not d]
    if not win:
        raise RuntimeError("the profiler recorded no window span")
    w0, w1 = win[0]
    # a record_function range also appears on the device's timeline under
    # its own name; it is no operation of the device
    ranges = {n for n, d, _, _ in evs if not d}
    device, host = [], []
    for n, d, s, e in evs:
        if e <= w0 or s >= w1 or (d and n in ranges):
            continue
        (device if d else host).append((n, max(s, w0), min(e, w1)))
    device.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return {"window": (w0, w1), "device": device, "host": host}


def busy_intervals(device) -> list:
    """The union of device operation intervals, as sorted (s, e) pairs."""
    out = []
    for _, s, e in device:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(tr) -> float:
    return sum(e - s for s, e in busy_intervals(tr["device"]))


def window_us(tr) -> float:
    return tr["window"][1] - tr["window"][0]


def device_us(tr, match) -> float:
    """Device microseconds of operations whose name ``match`` accepts."""
    return sum(e - s for n, s, e in tr["device"] if match(n))


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS.values())


def breakdown(tr, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by the innermost host operation running at each gap's middle:
    [[name, seconds], ...] each, the largest first."""
    ops = {}
    for n, s, e in tr["device"]:
        ops[n] = ops.get(n, 0.0) + (e - s)
    w0, w1 = tr["window"]
    busy = busy_intervals(tr["device"])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = tr["host"]
    starts = [h[1] for h in host]
    idle = {}
    for s, e in gaps:
        mid = (s + e) / 2
        j = bisect.bisect_right(starts, mid) - 1
        name = "no host operation"
        for j in range(j, max(-1, j - 5000), -1):
            if host[j][2] >= mid:
                name = host[j][0]
                break
        idle[name] = idle.get(name, 0.0) + (e - s)

    def ranked(d):
        return [[k[:200], v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}


# shared by the metric readers


def per_call_ms(rec, kind: str, match, count: str):
    """Device milliseconds of the operations ``match`` accepts, per unit
    of ``rec[count]`` (calls or chunks of the window), in a traced record
    of traffic ``kind``; None where there is nothing to read."""
    tr = rec.get("trace")
    if rec.get("kind") != kind or not tr or not rec.get(count):
        return None
    us = device_us(tr, match)
    return us / 1e3 / rec[count] if us > 0 else None


def kernel_ms_per_chunk(rec, kernel: str):
    """Device ms per chunk of the port's kernel ``kernel`` (a key of
    ``PORT_KERNELS``) in a traced build record."""
    return per_call_ms(rec, "build", lambda n: PORT_KERNELS[kernel] in n,
                       "chunks")


def span_ms_per_chunk(rec, span: str):
    """Milliseconds per chunk of the window in the program's ``span``
    spans of a traced build record."""
    spans = rec.get("spans_ms")
    if rec.get("kind") != "build" or not spans or span not in spans \
            or not rec["chunks"]:
        return None
    return spans[span] / rec["chunks"]


def untraced_idle_pct(rec, kind: str, count: str):
    """The share of the untraced program's time in which the device was
    idle, in a traced record of traffic ``kind``: 100 (1 - device busy
    seconds per unit of ``rec[count]`` in the traced window / host
    seconds per unit in the untraced window before it)."""
    tr, un = rec.get("trace"), rec.get("untraced")
    if rec.get("kind") != kind or not tr or not tr["device"] or not un \
            or not un[count] or not rec.get(count):
        return None
    busy = busy_us(tr) / 1e6 / rec[count]
    return 100.0 * (1.0 - busy / (un["window_s"] / un[count]))
