"""host_launches.knns: host calls that launch work on the card per
``knns`` call of the window: inside each ``portbench.call`` range of a
traced query record, every launch of one operation (``spans.LAUNCHES``:
a kernel, a copy, a set) and every launch of a CUDA graph (a name that
starts with ``cudaGraphLaunch``) counts one, averaged over the calls. A
count, from torch.profiler: the host's share of a call that only fewer
launches shrink."""

import bisect

from portbench import spans

UNIT = "launches/call"
CALL = "portbench.call"


def launches(name: str) -> bool:
    return name in spans.LAUNCHES or name.startswith("cudaGraphLaunch")


def read(rec):
    tr = spans.traced(rec, "query", "calls")
    if tr is None:
        return None
    host = tr["host"]  # sorted by start
    starts = [h[1] for h in host]
    calls = [(s, e) for n, s, e in host if n == CALL]
    if not calls:
        return None
    n = sum(launches(name)
            for c0, c1 in calls
            for name, _, _ in host[bisect.bisect_left(starts, c0):
                                   bisect.bisect_left(starts, c1)])
    return n / len(calls)
