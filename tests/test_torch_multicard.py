"""Sharded work across cards (``parallel/mesh.py``) on the CPU: the
per-device executor ``map_devices`` (one spawned worker process a group
of shards), the launch counters under threads and from workers, the
build spans on a given card, and ``ShardedHNSW.build`` with one worker
process a shard, bit-exact (tolerance 0) with the build in this process
and with the JAX ``parallel/`` on the 8-device virtual CPU mesh of
``conftest.py``; then ``chip_smoke.py``'s phase 19d recipe (the JAX
sharded runner's: one HNSWBuilder index a shard, merged) on small shards,
equal to the same recipe through the JAX ``HNSWBuilder``.

A CPU mesh names one device, so ``map_devices`` runs it in this process;
the ``per_shard_workers`` fixture groups every shard apart, as a mesh of
distinct cards does, so the worker processes run here too (one PyTorch
thread each)."""

import contextlib
import multiprocessing
import os
import pickle
import sys
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from hnsw_itu_tpu.models import IndexOptions as JaxOptions
from hnsw_itu_tpu.models.hnsw import HNSWBuilder as JaxHNSWBuilder
from hnsw_itu_tpu.parallel import ShardedHNSW as JaxShardedHNSW
from hnsw_itu_tpu.parallel import make_mesh as jax_make_mesh
from hnsw_itu_tpu_torch.models import IndexOptions
from hnsw_itu_tpu_torch.models import _build
from hnsw_itu_tpu_torch.ops import _kernels
from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
from hnsw_itu_tpu_torch.ops.hamming import hamming_block
from hnsw_itu_tpu_torch.ops.mini_search import mini_beam_search
from hnsw_itu_tpu_torch.parallel import ShardedHNSW, make_mesh
from hnsw_itu_tpu_torch.parallel import mesh as mesh_mod
from hnsw_itu_tpu_torch.parallel.mesh import device_groups, map_devices
from hnsw_itu_tpu_torch.testing import (edge_inputs, fused_edge_inputs,
                                        probe_group)
from hnsw_itu_tpu_torch.utils import make_dataset
from test_torch_kernels import (fused_edge_tensors, gather_edge_inputs,
                                mini_edge_inputs)
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

S, N, NQ, K = 4, 1203, 24, 10  # a ragged last shard, as test_torch_sharded
OPTS = dict(host_warmup=0, ef_construction=48, connections=12,
            max_connections=24, size=N, batch_size=32, entry_sample=0,
            scan_group=1)


def cpu_mesh(s):
    return make_mesh(devices=["cpu"] * s)


@pytest.fixture(scope="module", autouse=True)
def one_thread_workers():
    """One PyTorch thread in every worker: the fork server they come from
    takes this process's environment when the module's first worker
    starts it."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if old is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = old


@pytest.fixture
def per_shard_workers(monkeypatch):
    """One worker process a shard, as on a mesh of distinct cards."""
    monkeypatch.setattr(mesh_mod, "device_groups",
                        lambda mesh: [[s] for s in range(mesh.size)])


@contextlib.contextmanager
def switch_often():
    """Thread switches every microsecond: a lost update shows."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def hammer(call, threads: int, calls: int) -> None:
    """``call()`` ``calls`` times in each of ``threads`` threads at once."""
    start = threading.Barrier(threads, timeout=30)

    def run():
        start.wait()
        for _ in range(calls):
            call()

    workers = [threading.Thread(target=run) for _ in range(threads)]
    with switch_often():
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    assert not any(w.is_alive() for w in workers)


# --- the per-device executor -----------------------------------------------


def test_device_groups_by_first_appearance():
    mesh = make_mesh(devices=["cpu", "meta", "cpu", "meta", "meta"])
    assert device_groups(mesh) == [[0, 2], [1, 3, 4]]
    assert device_groups(cpu_mesh(3)) == [[0, 1, 2]]


def test_one_device_runs_in_this_process_in_order():
    out = map_devices(cpu_mesh(3), probe_group, ["a", "b", "c"])
    assert out == [([0, 1, 2], [(os.getpid(), s, a, "cpu") for s, a in
                                 enumerate("abc")])]


def test_one_worker_process_per_device_in_shard_order():
    """Two devices: two worker processes, each running its device's shards
    in shard order; their launch counts reach this process."""
    mesh = make_mesh(devices=["cpu", "meta"] * 2)
    before = hamming_block.plain_calls
    out = map_devices(mesh, probe_group, list("wxyz"))
    assert [g for g, _ in out] == [[0, 2], [1, 3]]
    (g0, r0), (g1, r1) = out
    assert [(s, a, d) for _, s, a, d in r0] == [(0, "w", "cpu"),
                                               (2, "y", "cpu")]
    assert [(s, a, d) for _, s, a, d in r1] == [(1, "x", "meta"),
                                               (3, "z", "meta")]
    pids = {r[0] for r in r0 + r1}
    assert len(pids) == 2 and os.getpid() not in pids
    assert hamming_block.plain_calls == before + 4


@pytest.mark.parametrize("devices,args,bad,shards", [
    (["cpu", "meta"] * 2, ["ok", "ok", "ok", "fail"], 3, [1, 3]),
    # both groups fail: the first group's error is raised
    (["cpu", "meta"] * 2, ["ok", "fail", "fail", "ok"], 2, [0, 2]),
    (["cpu"] * 3, ["ok", "fail", "ok"], 1, [0, 1, 2]),  # in this process
])
def test_a_workers_error_reaches_the_caller_with_its_shards(devices, args,
                                                           bad, shards):
    """The error of the first failing group is raised, noted with its
    shards and device (and, from a worker, its traceback there), after
    every worker has joined."""
    mesh = make_mesh(devices=devices)
    with pytest.raises(ValueError, match=f"shard {bad} failed") as e:
        map_devices(mesh, probe_group, args)
    notes = e.value.__notes__
    assert notes[-1] == (f"in shards {shards} of {len(devices)}, on "
                         f"{mesh.devices[bad]}")
    assert len(notes) == (1 if len(set(devices)) == 1 else 2)
    assert all("probe_group" in n for n in notes[:-1])


def test_a_job_that_does_not_pickle_stops_every_worker():
    mesh = make_mesh(devices=["cpu", "meta"])
    # a lambda does not pickle (PicklingError, or AttributeError for a
    # local object, by the Python version)
    with pytest.raises((pickle.PicklingError, AttributeError)):
        map_devices(mesh, lambda device, shards, args: args, [1, 2])
    assert not multiprocessing.active_children()


def test_a_dead_worker_is_reported_with_its_shards():
    mesh = make_mesh(devices=["cpu", "meta"])
    with pytest.raises(RuntimeError, match="worker exited with code 3") as e:
        map_devices(mesh, probe_group, ["ok", "exit"])
    assert e.value.__notes__ == ["in shards [1] of 2, on meta"]


# --- launch counters and spans ---------------------------------------------


def test_count_is_exact_from_many_threads():
    def fn():
        pass

    fn.plain_calls = 0
    hammer(lambda: _kernels.count(fn, "plain_calls"), 8, 5000)
    assert fn.plain_calls == 40_000


def _wrapper_call(name):
    """(wrapper, a call of it on small CPU tensors)."""
    rng = np.random.default_rng(5)
    if name == "hamming_block":
        a = torch.from_numpy(rng.integers(-2**31, 2**31, size=(3, 1),
                                          dtype=np.int32))
        return hamming_block, lambda: hamming_block(a, a)
    if name == "dma_beam_search":
        adj, p, q, d0, s = gather_edge_inputs(
            *edge_inputs("random", 64, 8, 1, B=2, words=2), "cpu")
        return dma_beam_search, lambda: dma_beam_search(
            adj, p, None, q, d0, s, ef=4, max_steps=4)
    if name == "mini_beam_search":
        pts, adj, qs, seeds = edge_inputs("random", 64, 8, 1, B=2, words=8)
        table, q, d0, s = mini_edge_inputs(pts, adj, qs, seeds, 3, 8, "cpu")
        return mini_beam_search, lambda: mini_beam_search(
            table, q, d0, s, ef=4, mini_words=3, max_steps=4)
    table, q, init = fused_edge_tensors(
        *fused_edge_inputs("random", 64, 8, 8, B=2, words=8), 8, "cpu")
    return fused_beam_search, lambda: fused_beam_search(
        table, q, init, ef=4, id_bits=8, max_d=256, max_steps=4)


@pytest.mark.parametrize("name,calls", [
    ("hamming_block", 1000), ("dma_beam_search", 20),
    ("mini_beam_search", 20), ("fused_beam_search", 20)])
def test_wrapper_counts_stay_exact_from_threads(name, calls):
    """Each wrapper's plain_calls counts every call made from 8 threads
    at once (its kernel_launches goes through the same ``count``)."""
    fn, call = _wrapper_call(name)
    before = fn.plain_calls
    hammer(call, 8, calls)
    assert fn.plain_calls == before + 8 * calls


def test_spans_are_recorded_on_the_given_cards_stream(monkeypatch):
    """``_span`` records both events on the current stream of the card it
    is given (not the caller's current device), and ``span_ms`` waits for
    each pair's end event before it reads it."""

    class Event:
        def __init__(self, enable_timing=False):
            self.stream, self.done = None, False

        def record(self, stream=None):
            self.stream = stream

        def synchronize(self):
            self.done = True

        def elapsed_time(self, end):
            assert end.done
            return 2.5

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream", device))
    timings = {}
    card = torch.device("cuda", 2)
    for _ in range(2):
        with _build._span(timings, "search", card):
            pass
    assert [(s.stream, e.stream) for s, e in timings["search"]] == \
        [(("stream", card), ("stream", card))] * 2
    assert _build.span_ms(timings) == {"search": 5.0}
    with _build._span(timings, "apply", torch.device("cpu")):
        pass
    assert "apply" not in timings


# --- the sharded paths, one worker a shard ---------------------------------


@pytest.fixture(scope="module")
def data():
    return make_dataset(17, N, NQ)


_BUILT = {}


def assert_same_index(pidx, jidx):
    """A port sharded index equal to a JAX one (or to another port one)."""
    def state(idx):
        if isinstance(idx, ShardedHNSW):
            return ([a.numpy() for a in idx.adj_s],
                    [d.numpy() for d in idx.deg_s], list(idx.ns),
                    [int(d) for d in idx.edge_drops_s])
        return (list(np.asarray(idx.adj_s)), list(np.asarray(idx.deg_s)),
                list(np.asarray(idx.ns)),
                np.asarray(idx.edge_drops_s).tolist())

    for g, w in zip(state(pidx), state(jidx)):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_worker_built_index_matches(data, per_shard_workers, monkeypatch):
    """ShardedHNSW.build with one worker process a shard: equal to the
    build in this process and to the JAX ``parallel/``, its launch counts
    brought back, ``timings`` filled for the mesh's device; knns on both
    routes over it equal to the JAX index's."""
    monkeypatch.setenv("HNSW_TPU_MINI_INTERPRET", "1")
    pts, qs = data
    before = dma_beam_search.plain_calls
    timings = {}
    got = ShardedHNSW.build(pts, IndexOptions(**OPTS), mesh=cpu_mesh(S),
                            timings=timings)
    assert dma_beam_search.plain_calls > before  # counted in the workers
    assert list(timings) == [torch.device("cpu")]
    assert set(timings[torch.device("cpu")]) == {"wall"}  # no card: no spans
    jidx = JaxShardedHNSW.build(pts, JaxOptions(**OPTS),
                                mesh=jax_make_mesh(S))
    assert_same_index(got, jidx)
    with monkeypatch.context() as m:  # the build in this process
        m.setattr(mesh_mod, "device_groups",
                  lambda mesh: [list(range(mesh.size))])
        assert_same_index(got, ShardedHNSW.build(pts, IndexOptions(**OPTS),
                                                 mesh=cpu_mesh(S)))
    assert_same(got.knns(qs, K, 32), jidx.knns(qs, K, 32))
    got.enable_inline()
    jidx.enable_inline()
    assert_same(got.knns(qs, K, 32), jidx.knns(qs, K, 32))
    assert got.last_route == "fused"


# --- phase 19d's recipe ----------------------------------------------------

RUNNER_SHARDS, RUNNER_PER = 3, 400
RUNNER_OPTS = dict(ef_construction=48, connections=12, max_connections=24,
                   batch_size=16, host_warmup=100)


def jax_runner(pts, qs, ef):
    """The JAX sharded runner's loop (run_sharded_10m.py:136-203) at test
    size: each shard a JAX HNSWBuilder index on its gather route, served
    at the recipe's settings, ids shifted by the shard offset, the exact
    numpy merge. Returns (indexes, dists, ids)."""
    key = "HNSW_TPU_INLINE_BUILD_BYTES"
    old = os.environ.get(key)
    os.environ[key] = "0"
    try:
        if "runner" not in _BUILT:
            out = []
            for s in range(RUNNER_SHARDS):
                b = JaxHNSWBuilder(JaxOptions(size=RUNNER_PER, **RUNNER_OPTS))
                b.extend_batched(pts[s * RUNNER_PER : (s + 1) * RUNNER_PER])
                idx = b.build()
                idx.query_batch = 16
                idx.query_entry_sample = 64
                idx.enable_inline()
                out.append(idx)
            _BUILT["runner"] = out
    finally:
        if old is None:
            del os.environ[key]
        else:
            os.environ[key] = old
    jidx = _BUILT["runner"]
    imax = np.iinfo(np.int32).max
    all_d = np.full((len(qs), RUNNER_SHARDS * K), imax, np.int64)
    all_i = np.full((len(qs), RUNNER_SHARDS * K), -1, np.int64)
    for s, idx in enumerate(jidx):
        idx.max_steps = ef
        res = idx.knns(qs, K, ef)
        d, i = np.asarray(res.dists).astype(np.int64), np.asarray(
            res.ids).astype(np.int64)
        ok = (i >= 0) & (i < imax)
        all_d[:, s * K : (s + 1) * K] = np.where(ok, d, imax)
        all_i[:, s * K : (s + 1) * K] = np.where(ok, i + s * RUNNER_PER, -1)
    order = np.lexsort((all_i, all_d), axis=1)[:, :K]
    return (jidx, np.take_along_axis(all_d, order, axis=1),
            np.take_along_axis(all_i, order, axis=1))


def test_runner_recipe_matches_jax(per_shard_workers, monkeypatch):
    """chip_smoke's 19d recipe (``runner``: ``runner_group`` in one worker
    process a shard, then the exact merge): every shard's level sizes
    equal to the JAX builder's, and the merged top-k at ef 48 and 32 equal
    to the JAX runner's merge."""
    monkeypatch.setenv("HNSW_TPU_MINI_INTERPRET", "1")
    pts, qs = make_dataset(23, RUNNER_SHARDS * RUNNER_PER, 20)
    merged, recs = chip_smoke.runner(
        pts, RUNNER_SHARDS, cpu_mesh(RUNNER_SHARDS), qs, opts=RUNNER_OPTS,
        query_batch=16, sample=64)
    assert [r["route"] for r in recs] == ["fused"] * RUNNER_SHARDS
    assert min(r["build_s"] for r in recs) > 0
    for ef in chip_smoke.RUNNER_EFS:
        jidx, jd, ji = jax_runner(pts, qs, ef)
        np.testing.assert_array_equal(merged[ef][0], jd)
        np.testing.assert_array_equal(merged[ef][1], ji)
    assert [r["level_ns"] for r in recs] == [j.level_ns for j in jidx]
