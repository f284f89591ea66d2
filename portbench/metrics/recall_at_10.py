"""recall_at_10: id-set recall@10 of the window's answers against the
reference's exact top-10, over every query of the pool (the first call
of each batch; ``judge`` of the traffic kind computes it)."""

UNIT = "ratio"


def read(rec):
    return rec.get("recall_at_10")
