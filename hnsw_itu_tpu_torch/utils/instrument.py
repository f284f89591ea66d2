"""The port's instrumentation: search statistics, and the spans that time
the program's phases.

``SearchStats`` is a copy of hnsw_itu_tpu/utils/instrument.py: the
reference's ``instrument`` analytics, per-graph-size visited-node
statistics and the distance-call count, from the per-query visited and
step counts every search returns (``knns`` keeps them in ``last_stats``).

Spans (``span``, ``host_range``, ``sync``, ``span_ms``) mark the query
and build paths' phases. A span named ``name`` does two things, each only
when asked:

* With a ``timings`` dict and a CUDA device, it records a CUDA event pair
  on the current stream of that device into ``timings[name]``;
  ``span_ms`` sums the pairs once they have completed. The builders and
  the indexes hold such a dict in ``timings`` (None: off).
* While ``torch.profiler`` records, it also opens the range
  ``"hnsw." + name`` (``torch.profiler.record_function``) on the host, on
  any device, so the profiler's timeline shows the program's phases
  beside the device's operations.

Otherwise it is one shared ``nullcontext``: no allocation and no
``record_function``, whose cost without a profiler is many times a
profiler-state check. ``host_range`` is a span that only ever opens its
profiler range (no events): for a phase that is read only as a range.
``sync`` is the range ``hnsw.sync`` around one operation that makes the
host wait for the card (a boolean index (``masked``), a ``nonzero``, a
pageable copy between the host and a card (``to_device``), a device
value read on the host), so the count of its ranges is the count of
those waits.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

PREFIX = "hnsw."
_OFF = contextlib.nullcontext()


@dataclass
class SearchStats:
    graph_size: int = 0
    visited: list = field(default_factory=list)
    steps: list = field(default_factory=list)

    def record(self, visited, steps) -> None:
        self.visited.extend(np.asarray(visited).ravel().tolist())
        self.steps.extend(np.asarray(steps).ravel().tolist())

    def summary(self) -> dict:
        if not self.visited:
            return {}
        v = np.asarray(self.visited, np.float64)
        out = {
            "graph_size": self.graph_size,
            "queries": int(v.size),
            "visited_total": int(v.sum()),
            "visited_mean": float(v.mean()),
            "visited_max": int(v.max()),
        }
        for p in (25, 50, 75, 90, 99):
            out[f"visited_p{p}"] = float(np.percentile(v, p))
        if self.steps:
            s = np.asarray(self.steps, np.float64)
            out["steps_mean"] = float(s.mean())
        # one distance call per visited node (nsw.rs:156-166)
        out["distance_calls"] = int(v.sum())
        return out

    def report(self, log) -> None:
        s = self.summary()
        if s:
            log.info("visited stats: %s", s)


def profiling() -> bool:
    """Is a ``torch.profiler`` recording in this process?"""
    return torch._C._autograd._profiler_enabled()


class _CudaSpan:
    """A CUDA event pair around the block, on the current stream of
    ``device``, appended to ``timings[name]``; ``rng``: the profiler range
    opened around it, or None."""

    __slots__ = ("timings", "name", "stream", "rng", "start")

    def __init__(self, timings: dict, name: str, device: torch.device, rng):
        self.timings, self.name, self.rng = timings, name, rng
        self.stream = torch.cuda.current_stream(device)

    def __enter__(self):
        if self.rng is not None:
            self.rng.__enter__()
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record(self.stream)
        self.timings.setdefault(self.name, []).append((self.start, end))
        if self.rng is not None:
            self.rng.__exit__(*exc)
        return False


def span(timings, name: str, device: torch.device):
    """The span ``name`` around a block: CUDA events into ``timings`` (a
    dict, on a CUDA ``device``), the profiler range ``hnsw.<name>`` while a
    profiler records, else the shared ``nullcontext``."""
    rng = torch.profiler.record_function(PREFIX + name) if profiling() \
        else None
    if timings is not None and device.type == "cuda":
        return _CudaSpan(timings, name, device, rng)
    return _OFF if rng is None else rng


def host_range(name: str):
    """The profiler range ``hnsw.<name>`` around a block while a profiler
    records; else the shared ``nullcontext``."""
    return torch.profiler.record_function(PREFIX + name) if profiling() \
        else _OFF


def sync():
    """The range ``hnsw.sync`` around one operation that makes the host
    wait for the card (``host_range``)."""
    return host_range("sync")


def masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``x[mask]`` inside a ``sync`` range: a boolean index waits for the
    card to learn how many rows it keeps."""
    with sync():
        return x[mask]


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t.to(device)``; a copy between the host and a card makes the host
    wait for it, inside a ``sync`` range."""
    if (t.device.type == "cpu") == (torch.device(device).type == "cpu"):
        return t.to(device)
    with sync():
        return t.to(device)


def span_ms(timings) -> dict:
    """Milliseconds per phase of a ``timings`` dict: waits for each pair's
    end event, on whichever card recorded it."""
    for pairs in timings.values():
        for _, end in pairs:
            end.synchronize()
    return {k: sum(s.elapsed_time(e) for s, e in v)
            for k, v in timings.items()}
