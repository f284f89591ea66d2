"""Search statistics (a copy of hnsw_itu_tpu/utils/instrument.py).

The reference's ``instrument`` analytics: per-graph-size visited-node
statistics and the distance-call count, from the per-query visited and
step counts every search returns (``knns`` keeps them in ``last_stats``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


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
