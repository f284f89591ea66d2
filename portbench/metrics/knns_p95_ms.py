"""knns_p95_ms: the 95th percentile of every ``knns`` call of the window,
host clock, each call ending with its ids and distances on the host
(numpy's linear interpolation between order statistics)."""

import numpy as np

UNIT = "ms"


def read(rec):
    if rec.get("kind") != "query" or not rec["latencies_s"]:
        return None
    return float(np.percentile(rec["latencies_s"], 95)) * 1e3
