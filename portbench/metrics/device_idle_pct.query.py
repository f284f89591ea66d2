"""device_idle_pct.query: the share of the untraced program's time in
which no operation ran on the card: 100 (1 - union of device operation
intervals per call in the traced window, from torch.profiler / host
seconds per call in the untraced window that a traced run runs first).
The profiler slows the host, not the device, so the traced window's own
idle share would overstate the untraced one (see ``trace.py``)."""

from portbench import trace

UNIT = "%"


def read(rec):
    return trace.untraced_idle_pct(rec, "query", "calls")
