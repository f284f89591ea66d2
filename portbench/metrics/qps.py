"""qps: queries answered in the window over the window's seconds (host
clock; each call ends with its ids and distances on the host)."""

UNIT = "queries/s"


def read(rec):
    if rec.get("kind") != "query":
        return None
    return rec["queries"] / rec["window_s"]
