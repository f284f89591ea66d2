"""CUDA graphs of the query step: one launch for a query batch.

On the fused and mini routes a batch runs about forty small launches
around its kernels (the entry, the entry distances and their sort, the
init keys, the beam kernel, the rerank, the un-permute, the decode), each
behind a Python check, a ctypes call or an aten dispatch; the card waits
for the host between them. ``StepGraphs`` captures that chain
(``QueryIndex._step_eager``) once as a CUDA graph and replays it with one
``cudaGraphLaunch`` for every later batch of the same key.

The policy (``StepGraphs.run``):

* A step with no key (``QueryIndex._graph_key`` gives None: the general
  route, CPU tensors, ``timings`` on, the walk entry, an empty batch)
  runs eager.
* The first batch of a key runs eager and only records the key; the
  second captures: the eager step on a side stream answers the batch
  (it is also the capture's warm-up), then the same step is captured on
  that stream. So a shape sent once (``search_one``, a tail batch) never
  pays a capture. Every later batch replays.
* An index keeps at most ``KEPT`` graphs (least recently used out) and
  remembers at most ``KEPT`` keys seen once. Its graphs share one memory
  pool: their replays run one after another on one stream, and each
  replay's answers are copied out before the next.

A replay copies the batch into the graph's query buffer (one ``copy_``),
launches the graph inside the host range ``hnsw.knns.graph``
(``utils/instrument.py``), and clones the graph's one packed output
(dists, ids, visited, steps) into fresh memory, whose views it returns:
no answer aliases a buffer the next replay overwrites.

Counters, in the ``ops/_kernels.py`` ``count`` style:
``StepGraphs.captures``, ``.replays`` and ``.eager_steps`` count the steps
of each kind (they add up to the steps run). A capture runs the kernel
wrappers once more without launching anything: their counters'
increase during the capture is taken back and added again at every
replay, so ``sampled_entry.kernel_launches`` and the beam and rerank
kernels' counters still count one launch a batch.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict

import torch

from ..ops import _kernels
from ..ops.entry import sampled_entry
from ..ops.fused_search import fused_beam_search
from ..ops.mini_search import mini_beam_search, rerank_exact, rerank_onehop
from ..utils.instrument import host_range, sync

KEPT = 4  # graphs (and keys seen once) an index keeps

# the kernel wrappers' counters a query step moves
STEP_COUNTERS = tuple((fn, c) for fn in (sampled_entry, fused_beam_search,
                                         mini_beam_search, rerank_exact,
                                         rerank_onehop)
                      for c in ("kernel_launches", "plain_calls"))


@contextlib.contextmanager
def taken_back(counters=STEP_COUNTERS, into: list | None = None):
    """Take the block's increase of each ``(function, counter)`` back out
    of it when the block ends; each nonzero increase is appended to
    ``into`` as ``(function, counter, n)``."""
    before = [getattr(fn, c) for fn, c in counters]
    try:
        yield
    finally:
        for (fn, c), b in zip(counters, before):
            n = getattr(fn, c) - b
            if n:
                _kernels.count(fn, c, -n)
                if into is not None:
                    into.append((fn, c, n))


def pack(out) -> torch.Tensor:
    """A step's (dists [B, k], ids [B, k], visited [B], steps [B]), all
    int32, as one flat tensor."""
    if any(t.dtype != torch.int32 for t in out):
        raise TypeError("a graphed step packs int32 answers only")
    return torch.cat([t.reshape(-1) for t in out])


def unpack(flat: torch.Tensor, shapes):
    """Contiguous views of ``flat`` in ``shapes`` (``pack``'s inverse)."""
    out, at = [], 0
    for shape in shapes:
        n = shape.numel()
        out.append(flat[at : at + n].view(shape))
        at += n
    return tuple(out)


class StepGraph:
    """One captured step: ``graph`` (anything with ``replay()``) reads
    ``static_q`` and writes ``static_out`` (``pack``ed answers of
    ``shapes``); ``counts``, the kernel counters' increase of one step."""

    __slots__ = ("graph", "static_q", "static_out", "shapes", "counts")

    def __init__(self, graph, static_q, static_out, shapes, counts):
        self.graph, self.static_q, self.static_out = graph, static_q, \
            static_out
        self.shapes, self.counts = shapes, counts

    def replay(self, q: torch.Tensor):
        self.static_q.copy_(q)
        with host_range("knns.graph"):
            self.graph.replay()
        for fn, c, n in self.counts:
            _kernels.count(fn, c, n)
        return unpack(self.static_out.clone(), self.shapes)


class StepGraphs:
    """The query step's graphs of one index, by key (module docstring).
    ``capture(step, q)`` -> (the eager answers to ``q``, a ``StepGraph``)
    replaces the CUDA capture (tests stub it)."""

    captures = 0
    replays = 0
    eager_steps = 0

    def __init__(self, capture=None):
        self.graphs: OrderedDict = OrderedDict()
        self.seen: OrderedDict = OrderedDict()
        self._capture = capture or self._capture_cuda
        self._stream = None
        self._pool = None

    def __reduce__(self):
        # graphs belong to this process and its card: a copy starts empty
        return StepGraphs, ()

    def run(self, key, q: torch.Tensor, step):
        """``step(q)`` (the eager step), or its graph's replay on ``q``, by
        ``key`` (None: eager)."""
        g = None if key is None else self.graphs.get(key)
        if g is not None:
            self.graphs.move_to_end(key)
            _kernels.count(StepGraphs, "replays")
            return g.replay(q)
        if key is None or self.seen.pop(key, None) is None:
            if key is not None:
                _remember(self.seen, key, True)
            _kernels.count(StepGraphs, "eager_steps")
            return step(q)
        out, g = self._capture(step, q)
        _remember(self.graphs, key, g)
        _kernels.count(StepGraphs, "captures")
        return out

    def _capture_cuda(self, step, q: torch.Tensor):
        """The eager step on this index's side stream (it answers ``q``
        and warms up the capture), then the step captured on that stream
        into this index's memory pool. ``torch.cuda.graph`` waits for the
        card before it captures: a ``sync`` range."""
        dev = q.device
        with torch.cuda.device(dev):
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
                self._pool = torch.cuda.graph_pool_handle()
            side, cur = self._stream, torch.cuda.current_stream(dev)
            static_q = q.clone()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = step(q)
            cur.wait_stream(side)
            for t in out:
                t.record_stream(cur)
            graph, counts = torch.cuda.CUDAGraph(), []
            with sync(), taken_back(into=counts), \
                    torch.cuda.graph(graph, pool=self._pool, stream=side):
                static_out = pack(step(static_q))
        return out, StepGraph(graph, static_q, static_out,
                              [t.shape for t in out], counts)


def _remember(lru: OrderedDict, key, value) -> None:
    lru[key] = value
    while len(lru) > KEPT:
        lru.popitem(last=False)
