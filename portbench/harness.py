"""One run of one cell: load it by name, hand it to its traffic kind,
judge what the window produced, read the metrics, print the result.

Everything that belongs to one cell, configuration, traffic mix or
metric is a file of its own, found by name:

* ``cells/<cell>.json``: the configuration, the traffic mix, chips, why;
* ``configs/<config>.json``: the deployment (index options, query
  settings, table route, the guarantee it states);
* ``traffic/<mix>.json``: the mix's parameters and its ``kind``;
* ``traffic/<kind>.py``: the generator and window of that kind, with
  ``run(ctx, system=None) -> record`` and ``judge(ctx, record) -> [(name,
  value, limit)]``;
* ``metrics/<metric>.py``: ``read(record) -> number or None`` and ``UNIT``.

Which metrics a cell reports comes from ``BENCHMARK.json`` at the root
of the checkout: the end-to-end metrics with ``--trace 0``, the per-layer
metrics with ``--trace 1``, each where its ``workloads`` list names the
cell (or, without the list, in every cell; a per-layer metric without it
goes with the cells that report the metric it moves).
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "hnsw_itu_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """Import the Python file ``path`` under a name of its own."""
    name = "portbench._by_path." + os.path.relpath(path, HERE).replace(
        os.sep, "__").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_parts(cell: str, base: str = HERE):
    """(cell, config, mix, traffic module) of the cell named ``cell``."""
    path = os.path.join(base, "cells", f"{cell}.json")
    if not os.path.exists(path):
        raise KeyError(f"no cell {cell!r}: {path} does not exist")
    c = load_json(path)
    cfg = load_json(os.path.join(base, "configs", f"{c['config']}.json"))
    mix = load_json(os.path.join(base, "traffic", f"{c['traffic']}.json"))
    mod = load_module(os.path.join(base, "traffic", f"{mix['kind']}.py"))
    return {**c, "name": cell}, cfg, mix, mod


def reader(metric: str, base: str = HERE):
    return load_module(os.path.join(base, "metrics", f"{metric}.py"))


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """Names of the metrics ``cell`` reports in a run with or without
    ``--trace``."""
    def listed(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = [m["name"] for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if listed(m) and m["moves"] in e2e]


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that the port may not load."""
    tops = {m.split(".")[0] for m in (sys.modules if modules is None
                                      else modules)}
    return sorted(tops & set(FORBIDDEN))


def run(cell: str, *, seed: int, seconds: float, trace: bool, device,
        t0: float, base: str = HERE, bench: dict | None = None,
        system=None):
    """Set up and run one cell once. Returns (result dict, checks), the
    result as the last line of a run prints it."""
    import torch

    meta, cfg, mix, mod = cell_parts(cell, base)
    ctx = SimpleNamespace(cell=meta, config=cfg, mix=mix, seed=int(seed),
                          seconds=float(seconds), trace=bool(trace),
                          device=torch.device(device), t0=t0)
    rec = mod.run(ctx, system)
    t = time.perf_counter()
    checks = mod.judge(ctx, rec)
    rec["phases"]["judge"] = time.perf_counter() - t
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    metrics = {}
    for name in cell_metrics(bench, cell, trace):
        r = reader(name, base)
        v = r.read(rec)
        if v is not None:
            metrics[name] = {"value": v, "unit": r.UNIT}
    dev = ctx.device
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": int(meta["chips"]),
            "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]), "metrics": metrics,
              "device": info}
    tr = rec.get("trace")
    if trace and tr is not None:
        from . import trace as trace_mod

        info["busy_s"] = trace_mod.busy_us(tr) / 1e6
        info["window_s"] = trace_mod.window_us(tr) / 1e6
        result["breakdown"] = trace_mod.breakdown(tr)
    # everything that runs before the result is printed has run: the
    # traffic kind, its judge, the readers, the trace's reduction
    found = forbidden_modules()
    if found:
        raise ImportError("loaded by the run: " + ", ".join(found))
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    lat = rec.get("latencies_s")
    rec["phases"]["window"] = rec["window_s"]
    print("portbench: seconds " + json.dumps(rec["phases"])
          + (" " + json.dumps(rec["notes"]) if "notes" in rec else "")
          + ("" if not lat else
             f"; calls {len(lat)}, latency ms min {1e3 * min(lat):.3f} "
             f"median {1e3 * sorted(lat)[len(lat) // 2]:.3f} "
             f"max {1e3 * max(lat):.3f}"), file=sys.stderr)
    return result, checks
