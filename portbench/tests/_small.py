"""A copy of the benchmark's data files at sizes a CPU test run holds:
the same cells, kinds and readers, the configurations cut to a few
thousand points."""

from __future__ import annotations

import json
import os
import shutil

from portbench import harness

SEED = 2**31 + 977  # past 32 signed bits, as the benchmark's seeds may be


def _edit(path, fn):
    with open(path) as f:
        o = json.load(f)
    fn(o)
    with open(path, "w") as f:
        json.dump(o, f)


def small_base(dst: str) -> str:
    """``dst`` filled with portbench's cells, configs, traffic and
    metrics, cut to CPU sizes (the 10M configuration's mini table as the
    port's policy picks it on a CPU: W=64)."""
    for sub in ("cells", "configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(harness.HERE, sub),
                        os.path.join(dst, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))

    def cut(o, n):
        o["points"] = n
        o["index"].update(host_warmup=1000, batch_size=32)

    _edit(f"{dst}/configs/laion-sketch-1m.json", lambda o: cut(o, 3000))

    def ten(o):
        cut(o, 4000)
        # 256-row chunks from the 2048 set-up rows on, as the builder's
        # schedule gives them there (a 10M run: 16,384 from 1,048,576)
        o["index"]["batch_size"] = 16
        o["table"] = {"route": "mini", "W": 64, "mini_words": 31}

    _edit(f"{dst}/configs/laion-sketch-10m.json", ten)
    _edit(f"{dst}/traffic/closed_b10k_pool5.json",
          lambda o: o.update(batch=200, pool=3, keep_stride=3))
    _edit(f"{dst}/traffic/closed_b8k_pool2.json",
          lambda o: o.update(batch=128, pool=2, keep_stride=3))
    _edit(f"{dst}/traffic/stream_from_1m.json",
          lambda o: o.update(warm_rows=2048, eval_queries=128,
                             eval_rows=1024))
    return dst


def bench() -> dict:
    return harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
