"""device_idle_ms.apply: milliseconds per chunk of the traced window in
which no operation ran on the card while the host was inside the build's
``hnsw.apply`` ranges (its ``hnsw.sync`` ranges included). From torch.profiler, so read
from a host that the profiler slows: compare it PR to PR, not with
``device_idle_pct.build`` (which sets the device's work against the
untraced host's time)."""

from portbench import spans

UNIT = "ms"


def read(rec):
    return spans.idle_ms_per(rec, "build", "chunks", ("apply",))
