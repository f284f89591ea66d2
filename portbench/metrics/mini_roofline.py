"""mini_roofline: the mini-table query kernel's (csrc/mini_beam_search.cu,
TPU kernels #3-#5) share of its bound: the bytes a call needs at HBM's
rate over the kernel's device time in the traced window
(torch.profiler).

Bytes a call needs (``chip_smoke.py``'s ``mini_ids_first_bytes``, from
``knns``'s ``last_stats`` of each batch): each row expansion's W ids,
each fresh neighbor's ``mini_words`` prefix, the queries' prefixes and
seeds in, the beam keys and per-query counts out."""

from portbench import trace

UNIT = "%"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


def ids_first_bytes(rows, fresh, B, W, mw, ef):
    return rows * W * 4 + fresh * mw * 4 + B * mw * 4 + B * 8 + B * ef * 8 \
        + B * 8


def read(rec):
    tr, st, tab = rec.get("trace"), rec.get("search_stats"), \
        rec.get("table")
    if not tr or not st or not tab or tab["route"] != "mini":
        return None
    us = trace.device_us(tr, lambda n: trace.PORT_KERNELS["mini"] in n)
    if us <= 0:
        return None
    nbytes = sum(rec["calls_per_batch"][b] * ids_first_bytes(
        s["steps"], s["visited"] - s["queries"], s["queries"], tab["W"],
        tab["mini_words"], tab["ef"]) for b, s in st.items())
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / (us / 1e6)
