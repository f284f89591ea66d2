"""``correct`` on whole runs at CPU sizes: sound runs pass; the control
(the reference in the program's place at 31 of 32 words) and each fault
planted under the timed path fail.

These runs skip the harness's look for a card (``harness.run`` on the
CPU, where the port runs its kernels' plain versions) and drive the rest
of a run: set-up, window, judge, metrics.
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import control, harness
from portbench.tests._small import SEED, bench, small_base

C1, C2, C3 = "laion1m-fused-b10k", "laion10m-mini-b8k", "laion10m-build"


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield small_base(str(tmp_path_factory.mktemp("pb")))
    torch.set_num_threads(prev)


def run(base, cell, system=None, trace=False):
    res, checks = harness.run(cell, seed=SEED, seconds=0.5, trace=trace,
                              device="cpu", t0=time.perf_counter(),
                              base=base, bench=bench(), system=system)
    return res, {n: (v, lim) for n, v, lim in checks}


@pytest.mark.parametrize("cell", [C1, C2, C3])
def test_sound_run_is_correct(base, cell, monkeypatch):
    if cell == C2:
        # the 10M cell's route at CPU sizes: the fused table refused, as
        # the card's memory refuses it at 10M
        import hnsw_itu_tpu_torch.models.nsw as nsw

        monkeypatch.setattr(nsw, "_fused_query_eligible",
                            lambda *a, **k: False)
    res, checks = run(base, cell)
    assert res["correct"], checks
    assert list(res)[-1] == "checks"
    assert checks["bad_rows"] == (0, 0)
    want = {"qps", "knns_p95_ms", "recall_at_10", "setup_s"} if cell != C3 \
        else {"build_rows_per_s", "setup_s"}
    assert set(res["metrics"]) == want
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("cell", [C1, C3])
def test_control_is_refused(base, cell):
    res, checks = run(base, cell, system=control.system_for(
        harness.cell_parts(cell, base)[2]["kind"]))
    assert not res["correct"]
    if cell == C1:  # the prefix distances are not the distances
        assert checks["bad_rows"][0] > checks["bad_rows"][1]
    else:  # selected by the prefix, rows miss their nearest
        assert checks["nearest_miss"][0] > checks["nearest_miss"][1]


def _stale(knns):
    first = []

    def f(self, q, k, ef):
        r = knns(self, q, k, ef)
        first.append(r)
        return first[0]  # the state as the first call left it
    return f


def _half(knns):
    def f(self, q, k, ef):
        r = knns(self, q, k, ef)
        h = r.ids.shape[0] // 2
        r.ids[h:] = 2**31 - 1
        r.dists[h:] = 2**31 - 1
        return r
    return f


def _altered(knns):
    def f(self, q, k, ef):
        r = knns(self, q, k, ef)
        r.ids[0, 0] = (r.ids[0, 0] + 1) % self.n
        return r
    return f


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_query_fault_is_refused(base, monkeypatch, fault):
    from hnsw_itu_tpu_torch.models import nsw

    def faulty(ctx, pts_host):
        idx = harness.cell_parts(C1, base)[3].build_index(ctx, pts_host)
        monkeypatch.setattr(nsw.QueryIndex, "knns",
                            fault(nsw.QueryIndex.knns))
        return idx

    res, checks = run(base, C1, system=faulty)
    assert not res["correct"] and checks["bad_rows"][0] > 0


def test_build_fault_unchanged(base, monkeypatch):
    """extend_batched returns with the state as it was, after set-up."""
    from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder

    real = HNSWBuilder.extend_batched
    calls = []

    def once(self, pts, progress=None):
        calls.append(1)
        if len(calls) == 1:
            real(self, pts, progress)

    monkeypatch.setattr(HNSWBuilder, "extend_batched", once)
    res, checks = run(base, C3)
    assert not res["correct"] and checks["bad_rows"][0] > 0


def test_forbidden_module_loaded_by_a_reader(base, tmp_path, monkeypatch):
    """A metric reader that loads a module named jax, after the window:
    the run refuses to give a result."""
    import shutil
    import sys

    b = str(tmp_path / "pb")
    shutil.copytree(base, b)
    with open(f"{b}/metrics/jax_reader.py", "w") as f:
        f.write("import jax\nUNIT = 's'\n\n\ndef read(rec):\n"
                "    return 1.0\n")
    (tmp_path / "fake").mkdir()
    (tmp_path / "fake" / "jax.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "fake"))
    if "jax" not in sys.modules:
        monkeypatch.setitem(sys.modules, "jax", None)
        monkeypatch.delitem(sys.modules, "jax")
    bn = bench()
    bn["per_layer"] = []
    bn["end_to_end"].append({"name": "jax_reader", "unit": "s",
                             "better": "lower", "bound": 0.25,
                             "source": "host_clock", "workloads": [C3]})
    with pytest.raises(ImportError, match="jax"):
        harness.run(C3, seed=SEED, seconds=0.5, trace=False, device="cpu",
                    t0=time.perf_counter(), base=b, bench=bn)


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_build_fault_in_apply(base, monkeypatch, fault):
    """The mutation of a chunk leaves half its rows out, or writes an id
    altered to the row's own."""
    from hnsw_itu_tpu_torch.models import _build

    real = _build.apply_inserts

    def apply(points, node_map, graph, new_ids, sel_rows, *a, **kw):
        if node_map is None and new_ids.numel() > 1:
            new_ids, sel_rows = new_ids.clone(), sel_rows.clone()
            if fault == "half":
                new_ids[new_ids.numel() // 2:] = -1
            else:
                sel_rows[0, 0] = new_ids[0]
        return real(points, node_map, graph, new_ids, sel_rows, *a, **kw)

    monkeypatch.setattr(_build, "apply_inserts", apply)
    res, checks = run(base, C3)
    assert not res["correct"] and checks["bad_rows"][0] > 0
