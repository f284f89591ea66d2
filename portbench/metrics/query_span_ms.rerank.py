"""query_span_ms.rerank: milliseconds per ``knns`` call of the traced
window in the program's ``hnsw.knns.rerank`` ranges (the mini route's
exact rerank, ``rerank_onehop`` or ``rerank_exact``), on the stream's
clock: from the moment the card has done the work launched before each
range to the moment it has done the work launched inside it, launch gaps
included, as a CUDA event pair around the range reads it
(``spans.stream_span_us``, from torch.profiler's launches and device
operations). The fused route has no rerank and opens no such range."""

from portbench import spans

UNIT = "ms"


def read(rec):
    return spans.stream_span_ms_per_call(rec, "knns.rerank")
