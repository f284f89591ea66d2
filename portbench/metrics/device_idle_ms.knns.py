"""device_idle_ms.knns: milliseconds per ``knns`` call in which no
operation ran on the card while the host was inside the program's
``hnsw.knns`` range (its parts included): the program's share of a
call's idle time. The rest of the window's idle is the caller's (the
client loop, the copies of the answers out). From torch.profiler over
the traced window, so read from a host that the profiler slows: compare
it PR to PR, not with ``device_idle_pct.query`` (which sets the device's
work against the untraced host's time)."""

from portbench import spans

UNIT = "ms"


def read(rec):
    return spans.idle_ms_per(rec, "query", "calls", ("knns",))
