"""build_span_ms.apply: milliseconds per chunk of the window in the
build's "apply" spans, the program's own CUDA-event pairs
(``HNSWBuilder.timings``, summed by ``models/_build.py`` ``span_ms``;
on the device's timeline, launch gaps included), over the chunks
inserted in the traced window."""

from portbench import trace

UNIT = "ms"


def read(rec):
    return trace.span_ms_per_chunk(rec, "apply")
