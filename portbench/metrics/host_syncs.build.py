"""host_syncs.build: the program's ``hnsw.sync`` ranges per chunk of the
traced window: each wraps one operation of the build that makes the
host wait for the card (a boolean index, a ``nonzero``, a pageable copy
in, a device value read on the host). A count, from torch.profiler: it
repeats exactly on the same rows."""

from portbench import spans

UNIT = "syncs/chunk"


def read(rec):
    tr = spans.traced(rec, "build", "chunks")
    return None if tr is None else spans.count(tr, "sync") / rec["chunks"]
