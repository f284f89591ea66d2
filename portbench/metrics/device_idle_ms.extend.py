"""device_idle_ms.extend: milliseconds per chunk of the traced window in
which no operation ran on the card while the host was inside the
builder's ``hnsw.extend`` range and inside none of its phases
(``hnsw.entry``, ``.search``, ``.select``, ``.apply``): the builder's own
Python between phases (level draws, registration, the copies in). From
torch.profiler, so read from a host that the profiler slows: compare it
PR to PR, not with ``device_idle_pct.build``."""

from portbench import spans

UNIT = "ms"


def read(rec):
    return spans.idle_ms_per(rec, "build", "chunks", ("extend",),
                             ("entry", "search", "select", "apply"))
