"""fused_roofline: the fused query kernel's (csrc/fused_beam_search.cu)
share of its bound: the bytes a call needs at HBM's rate over the
kernel's device time in the traced window (torch.profiler).

Bytes a call needs (from ``knns``'s ``last_stats`` of each batch): each
row expansion's W ids, each visited node's sketch read once, the queries
and their entry keys in, the beam keys and per-query counts out. A node
is counted once however often the kernel reads it, so the share is of
what the search needs, not of what it moved."""

from portbench import trace

UNIT = "%"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


def call_bytes(steps, visited, B, W, words, ef):
    return (steps * W * 4 + visited * words * 4 + B * (words + 1) * 4
            + B * ef * 4 + B * 8)


def read(rec):
    tr, st, tab = rec.get("trace"), rec.get("search_stats"), \
        rec.get("table")
    if not tr or not st or not tab or tab["route"] != "fused":
        return None
    us = trace.device_us(tr, lambda n: trace.PORT_KERNELS["fused"] in n)
    if us <= 0:
        return None
    nbytes = sum(rec["calls_per_batch"][b] * call_bytes(
        s["steps"], s["visited"], s["queries"], tab["W"], tab["words"],
        tab["ef"]) for b, s in st.items())
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / (us / 1e6)
