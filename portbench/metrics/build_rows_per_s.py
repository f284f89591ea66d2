"""build_rows_per_s: rows inserted in the window over the window's
seconds, up to the synchronize after its last chunk (host clock)."""

UNIT = "rows/s"


def read(rec):
    if rec.get("kind") != "build" or not rec["rows"]:
        return None
    return rec["rows"] / rec["window_s"]
