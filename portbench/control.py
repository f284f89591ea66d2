"""The controls: the plain reference put in the program's place at the
precision below the configuration's, which ``correct`` has to refuse.

The configurations state exact Hamming distances over 1024 bits (32
words). The precision below is the same distance over a prefix of the
words: 31, the widest prefix the port's mini table keeps, the step that
would tempt a later change (rank by the table's estimate and skip the
exact rerank).

* Query cells: ``PrefixIndex`` answers ``knns`` with the exact top-k by
  prefix distance and reports those distances.
* The build cell: ``PrefixBuild`` is the port's own builder on the
  same rows with the last word cleared, so that every distance its
  search and its neighbor selection compute is the prefix distance. The
  graph is judged on the full rows. There is no plain reference builder
  to put in the program's place: the program at the lower precision is
  the step that would tempt a later change (building on the mini
  table's prefix).

Run at a cell's own size, on the card, a few seeds:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 1

prints, for each seed, the numbers ``correct`` compares, beside their
limits. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.reference import exact  # noqa: E402

PREFIX_WORDS = 31


class _Result:
    def __init__(self, dists, ids):
        self.dists, self.ids = dists, ids


class PrefixIndex:
    """``knns`` by the exact reference over the first ``words`` words."""

    def __init__(self, ctx, pts_host, words: int = PREFIX_WORDS):
        self.points = torch.from_numpy(pts_host.view(np.int32)).to(
            ctx.device)
        self.words = words

    def knns(self, queries, k: int, ef: int):
        q = torch.from_numpy(np.ascontiguousarray(queries).view(
            np.int32)).to(self.points.device)
        d, i = exact.exact_topk(self.points, q, k, words=self.words)
        return _Result(d, i)


class PrefixBuild:
    """The port's builder at the configuration's options, fed every row
    with the words from ``words`` on cleared."""

    def __init__(self, ctx, words: int = PREFIX_WORDS):
        kind = harness.load_module(os.path.join(
            harness.HERE, "traffic", "build_stream.py"))
        self.inner, self.words, self.timings = kind.make_builder(ctx), \
            words, None

    @property
    def base(self):
        return self.inner.base

    def extend_batched(self, rows) -> None:
        rows = np.array(rows, copy=True)
        rows[:, self.words:] = 0
        self.inner.extend_batched(rows)


def system_for(kind: str):
    """The control that stands in the program's place for a traffic kind."""
    if kind == "knns_closed_loop":
        return PrefixIndex
    if kind == "build_stream":
        return PrefixBuild
    raise KeyError(kind)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    kind = harness.cell_parts(args.workload)[2]["kind"]
    for seed in (int(s) for s in args.seeds.split(",")):
        res, _ = harness.run(args.workload, seed=seed, seconds=args.seconds,
                             trace=False, device="cuda:0",
                             t0=time.perf_counter(), system=system_for(kind))
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
