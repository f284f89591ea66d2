"""The benchmark's files resolve by name, BENCHMARK.json keeps to its
required shape, a new cell needs only new files, and the import check
sees what it has to."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench import harness
from portbench.tests._small import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = bench()
CELLS = [w["name"] for w in B["workloads"]]
METRICS = [m["name"] for m in B["end_to_end"] + B["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    meta, cfg, mix, mod = harness.cell_parts(cell)
    w = next(w for w in B["workloads"] if w["name"] == cell)
    assert (meta["config"], meta["traffic"], meta["chips"], meta["why"]) \
        == (w["config"], w["traffic"], w["chips"], w["why"])
    assert callable(mod.run) and callable(mod.judge)
    assert set(cfg["index"]) == {
        "ef_construction", "connections", "max_connections", "expand",
        "batch_size", "reorder", "prune_budget", "seed", "entry_sample",
        "host_warmup", "scan_group"}
    assert 0 < cfg["guarantee"]["recall_at_10"] < 1


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_resolves(metric):
    r = harness.reader(metric)
    m = next(m for m in B["end_to_end"] + B["per_layer"]
             if m["name"] == metric)
    assert r.UNIT == m["unit"]
    assert r.read({"kind": "none", "setup_s": 1.0}) in (None, 1.0)


@pytest.mark.parametrize("config", B["configs"], ids=lambda c: c["name"])
def test_config_entry(config):
    path = os.path.join(harness.ROOT, config["file"])
    cfg = harness.load_json(path)
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    assert config["source"] == cfg["source"]
    assert config["reduced"] == cfg["reduced"]
    assert all(NAME.match(k) for k in config["reduced"])


def test_benchmark_shape():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert 1 <= B["run_seconds"] <= 51
    names = CELLS + METRICS + [c["name"] for c in B["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) and len(w["why"]) <= 200
               for w in B["workloads"])
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"device", "query step", "query kernels",
                           "build chunks", "build kernels"}
    for cell in CELLS:
        e = harness.cell_metrics(B, cell, trace=False)
        assert "setup_s" in e and len(e) >= 2
        assert harness.cell_metrics(B, cell, trace=True)
    assert len(json.dumps(B)) < 64 * 1024


def test_new_cell_is_found_without_code(tmp_path):
    """A cell dropped into a copy of the layout resolves and reports its
    metrics once BENCHMARK.json lists it: no code changes."""
    base = str(tmp_path / "pb")
    for sub in ("cells", "configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(harness.HERE, sub),
                        os.path.join(base, sub))
    new = {"config": "laion-sketch-1m", "traffic": "closed_b8k_pool2",
           "chips": 1, "why": "a later cell: 8192-query batches at 1M"}
    with open(os.path.join(base, "cells", "laion1m-fused-b8k.json"),
              "w") as f:
        json.dump(new, f)
    meta, cfg, mix, mod = harness.cell_parts("laion1m-fused-b8k", base)
    assert cfg["points"] == 1_000_000 and mix["batch"] == 8192
    assert mod.__name__.endswith("knns_closed_loop_py")
    b = json.loads(json.dumps(B))
    b["workloads"].append({"name": "laion1m-fused-b8k", **new})
    for m in b["end_to_end"] + b["per_layer"]:
        if "laion1m-fused-b10k" in m.get("workloads", []):
            m["workloads"].append("laion1m-fused-b8k")
    assert harness.cell_metrics(b, "laion1m-fused-b8k", False) == \
        harness.cell_metrics(b, "laion1m-fused-b10k", False)
    with pytest.raises(KeyError):
        harness.cell_parts("no-such-cell", base)


@pytest.mark.parametrize("mods,found", [
    ({"jax": 1, "jax.numpy": 1}, ["jax"]),
    ({"hnsw_itu_tpu": 1, "hnsw_itu_tpu.ops": 1}, ["hnsw_itu_tpu"]),
    ({"jaxlib.xla_client": 1, "flax": 1}, ["flax", "jaxlib"]),
    ({"hnsw_itu_tpu_torch": 1, "hnsw_itu_tpu_torch.models": 1,
      "jax_like": 1, "numpy": 1}, []),
])
def test_forbidden_modules(mods, found):
    assert harness.forbidden_modules(mods) == found


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            with open(os.path.join(ref, name)) as f:
                text = f.read()
            assert not re.search(r"^\s*(from|import)\s+(hnsw_itu_tpu|jax)",
                                 text, re.M), name
