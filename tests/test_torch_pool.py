"""Sharded queries on ``CardPool`` workers (``parallel/mesh.py``), one
long-lived worker process a group of shards, on the CPU: the
``per_shard_workers`` fixture groups every shard apart, as a mesh of
distinct cards does. ``ShardedHNSW.knns`` (fused and general routes) and
``knns_query_sharded`` (NSW, HNSW with the sampled entry and with the
descent) equal, with tolerance 0, the same calls in this process (a CPU
mesh names one device) and the JAX ``parallel/`` on the 8-device virtual
CPU mesh of ``conftest.py``; the workers live across calls, their launch
counts reach this process, their errors and deaths are raised here with
their shards, and ``close`` makes them release what they hold."""

import multiprocessing
import os
import signal

import numpy as np
import pytest
import torch

from hnsw_itu_tpu.models import IndexOptions as JaxOptions
from hnsw_itu_tpu.parallel import ShardedHNSW as JaxShardedHNSW
from hnsw_itu_tpu.parallel import knns_query_sharded as jax_query_sharded
from hnsw_itu_tpu.parallel import make_mesh as jax_make_mesh
from hnsw_itu_tpu_torch.models import IndexOptions
from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
from hnsw_itu_tpu_torch.ops.hamming import hamming_block
from hnsw_itu_tpu_torch.parallel import (ShardedHNSW, ShardedNSW,
                                         knns_query_sharded, make_mesh)
from hnsw_itu_tpu_torch.parallel import mesh as mesh_mod
from hnsw_itu_tpu_torch.parallel.mesh import CardPool
from hnsw_itu_tpu_torch.testing import DropProbe, held_group, probe_group
from hnsw_itu_tpu_torch.utils import make_dataset
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)
from test_torch_multicard import (one_thread_workers,  # noqa: F401
                                  per_shard_workers)
from test_torch_sharded import _BUILT as SHARDED_BUILT
from test_torch_sharded import _nsw_pair, _qs_opts

S, N, NQ, K = 4, 1203, 24, 10  # a ragged last shard, as test_torch_sharded
OPTS = dict(host_warmup=0, ef_construction=48, connections=12,
            max_connections=24, size=N, batch_size=32, entry_sample=0,
            scan_group=1)


def cpu_mesh(s):
    return make_mesh(devices=["cpu"] * s)


def assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture(scope="module")
def data():
    return make_dataset(17, N, NQ)


@pytest.fixture(scope="module")
def jax_index(data):
    return JaxShardedHNSW.build(data[0], JaxOptions(**OPTS),
                                mesh=jax_make_mesh(S))


def carried(jidx, cls=ShardedHNSW):
    """The port's sharded index over the JAX index's arrays."""
    a = np.asarray
    return cls.from_numpy(a(jidx.points_s), a(jidx.adj_s), a(jidx.deg_s),
                          a(jidx.eps), a(jidx.offsets), a(jidx.ns),
                          jidx.metric.name, IndexOptions(**OPTS),
                          mesh=cpu_mesh(S))


def caller_pool(mesh):
    """A pool that runs in this process, as for a mesh of one device."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(mesh_mod, "device_groups",
                  lambda mesh: [list(range(mesh.size))])
        return CardPool(mesh)


@pytest.fixture
def pair(jax_index):
    """(index served by one worker a shard, the same index served here);
    the workers stopped after the test."""
    idx, ref = carried(jax_index), carried(jax_index)
    ref._pool = caller_pool(ref.mesh)
    yield idx, ref
    idx.close()
    assert not multiprocessing.active_children()


# --- ShardedHNSW.knns ------------------------------------------------------


@pytest.mark.parametrize("route", ["general", "fused"])
def test_knns_on_workers_matches_caller_and_jax(jax_index, data, route,
                                                per_shard_workers, pair,
                                                monkeypatch):
    """Both routes through one worker a shard: equal to this process's
    loop and to the JAX sharded query, at two ef; a second call runs on
    the same worker processes; each shard's fused launch is counted
    here."""
    monkeypatch.setenv("HNSW_TPU_MINI_INTERPRET", "1")
    _, qs = data
    idx, ref = pair
    assert ref._pool.in_caller
    if route == "fused":
        for x in (idx, ref, jax_index):
            x.enable_inline()
    pids = None
    for ef in (16, 48):
        before = fused_beam_search.plain_calls
        got = idx.knns(qs, K, ef)
        assert idx.last_route == route
        assert fused_beam_search.plain_calls - before == (
            S if route == "fused" else 0)
        assert not idx._pool.in_caller and len(idx._pool.pids) == S
        assert os.getpid() not in idx._pool.pids
        assert pids is None or idx._pool.pids == pids
        pids = idx._pool.pids
        assert_same(got, ref.knns(qs, K, ef))
        assert_same(got, jax_index.knns(qs, K, ef))
    jax_index.fused_s = None


def test_knns_rebinds_when_the_tables_change(data, per_shard_workers, pair):
    """enable_inline replaces the tensors the workers hold: the next call
    binds again, under a new key, on the same workers; a new batch shape
    binds new query and result buffers and leaves the index bound."""
    _, qs = data
    idx, ref = pair
    want = ref.knns(qs, K, 32)
    assert_same(idx.knns(qs, K, 32), want)
    key, pids = idx._bound[0], idx._pool.pids
    assert_same(idx.knns(qs, K, 32), want)
    assert idx._bound[0] == key
    idx.enable_inline()
    ref.enable_inline()
    assert_same(idx.knns(qs, K, 32), ref.knns(qs, K, 32))
    assert idx.last_route == "fused"
    assert idx._bound[0] != key and idx._pool.pids == pids
    idx.query_entry_sample = ref.query_entry_sample = 0  # a setting: no bind
    key, io_key = idx._bound[0], idx._io[1]
    assert_same(idx.knns(qs, K, 32), ref.knns(qs, K, 32))
    assert (idx._bound[0], idx._io[1]) == (key, io_key)
    # another batch shape binds new query and result buffers only
    assert_same(idx.knns(qs[:7], 5, 32), ref.knns(qs[:7], 5, 32))
    assert idx._bound[0] == key and idx._io[1] != io_key


def test_a_workers_error_names_its_shards(data, per_shard_workers, pair):
    """A shard whose points are malformed fails in its worker: the error
    is raised here, noted with the worker's traceback and its shard; the
    other workers stay in step and the pool keeps serving."""
    _, qs = data
    idx, ref = pair
    want = idx.knns(qs, K, 32)
    good = idx.shards[2].points
    idx.shards[2].points = good[:, :3].contiguous()
    with pytest.raises(RuntimeError) as e:
        idx.knns(qs, K, 32)
    assert e.value.__notes__[-1] == "in shards [2] of 4, on cpu"
    assert "_shard_topk" in e.value.__notes__[0]
    idx.shards[2].points = good
    assert_same(idx.knns(qs, K, 32), want)


def test_a_killed_worker_is_reported_and_nothing_falls_back(
        data, per_shard_workers, pair):
    _, qs = data
    idx, ref = pair
    want = ref.knns(qs, K, 32)
    idx.knns(qs, K, 32)
    pids = idx._pool.pids
    os.kill(pids[1], signal.SIGKILL)
    for _ in range(2):  # reported, then refused: never served here
        with pytest.raises(RuntimeError, match="exited with code -9|"
                           "refuses calls") as e:
            idx.knns(qs, K, 32)
    assert "shards [1], cpu" in str(e.value)
    idx.close()  # a new pool serves again
    assert_same(idx.knns(qs, K, 32), want)
    assert not set(idx._pool.pids) & set(pids)


def test_close_releases_what_the_workers_hold(tmp_path, per_shard_workers):
    """``close`` makes every worker drop what it holds before it exits;
    ``drop`` releases one binding at once; a closed pool refuses calls."""
    path = str(tmp_path / "dropped")
    pool = CardPool(cpu_mesh(3))
    probes = [DropProbe(path) for _ in range(3)]  # this process's, kept
    key = pool.bind(probes)
    out = pool.map(held_group, [None] * 3, bound=(key,))
    assert [g for g, _ in out] == [[0], [1], [2]]
    assert [r[0][0] for _, r in out] == pool.pids
    pool.drop(key)
    with open(path) as f:
        assert sorted(map(int, f.read().split())) == sorted(pool.pids)
    os.remove(path)
    pool.bind(probes)
    pids = pool.pids
    pool.close()
    assert not multiprocessing.active_children()
    with open(path) as f:
        assert sorted(map(int, f.read().split())) == sorted(pids)
    with pytest.raises(RuntimeError, match="refuses calls: closed"):
        pool.map(probe_group, ["a"] * 3)
    del probes


def test_pool_map_counts_and_survives_an_error(per_shard_workers):
    """``map`` on long-lived workers: every launch count of every worker
    reaches this process, the call's times are recorded, a job's error
    names its shard, and the same workers serve the next job."""
    with CardPool(cpu_mesh(4)) as pool:
        pids = pool.pids
        for _ in range(3):
            before = hamming_block.plain_calls
            out = pool.map(probe_group, list("abcd"))
            assert [r[0][0] for _, r in out] == pids
            assert hamming_block.plain_calls == before + 4
            ms = pool.last_ms
            assert set(ms) == {"call", "dump", "sync", "workers"}
            assert [set(w) for w in ms["workers"]] == \
                [{"load", "job", "clean"}] * 4
            assert ms["call"] >= max(w["job"] for w in ms["workers"]) > 0
        with pytest.raises(ValueError, match="shard 2 failed") as e:
            pool.map(probe_group, ["a", "b", "fail", "d"])
        assert e.value.__notes__[-1] == "in shards [2] of 4, on cpu"
        assert [r[0][0] for _, r in pool.map(probe_group, list("wxyz"))] \
            == pids


# --- knns_query_sharded ----------------------------------------------------


def _hnsw_pair():
    """(JAX HNSW, the port's HNSW over its arrays), test_torch_sharded's."""
    from hnsw_itu_tpu.models.hnsw import HNSWBuilder as JaxHNSWBuilder
    from hnsw_itu_tpu_torch.utils import from_numpy

    rng = np.random.default_rng(11)
    pts = rng.integers(0, 2**32, size=(600, 32), dtype=np.uint32)
    if "qs_hnsw" not in SHARDED_BUILT:
        jb = JaxHNSWBuilder(JaxOptions(**_qs_opts(600)))
        jb.extend_batched(pts)
        SHARDED_BUILT["qs_hnsw"] = jb.build()
    j = SHARDED_BUILT["qs_hnsw"]
    a = np.asarray
    p = from_numpy(a(j.points), a(j.base.adj), a(j.base.deg),
                   [(a(lv.node_ids), a(lv.down), a(lv.graph.adj),
                     a(lv.graph.deg)) for lv in j.levels],
                   j.level_ns, j.ep, j.n, IndexOptions(**_qs_opts(600)),
                   "cpu")
    return j, p


@pytest.mark.parametrize("kind,entry_sample", [
    ("nsw", 0), ("hnsw", 0), ("hnsw", 128)])
def test_query_sharded_on_workers_matches_caller_and_jax(
        kind, entry_sample, monkeypatch):
    """Each part in its own worker of a pool passed in (twice: the same
    workers), without a pool (one for the call), against this process's
    parts and the JAX function; the descent's #6 launches are counted
    here as in the caller's loop."""
    rng = np.random.default_rng(9)
    qs = rng.integers(0, 2**32, size=(13, 32), dtype=np.uint32)  # padded
    if kind == "nsw":
        j, p = _nsw_pair(rng.integers(0, 2**32, size=(500, 32),
                                      dtype=np.uint32))
    else:
        j, p = _hnsw_pair()
        j.query_entry_sample = p.query_entry_sample = entry_sample
    mesh = cpu_mesh(S)
    before = dma_beam_search.plain_calls
    want = knns_query_sharded(p, qs, 5, 32, mesh=mesh)  # in this process
    here = dma_beam_search.plain_calls - before
    assert here > 0 if (kind, entry_sample) == ("hnsw", 0) else here == 0
    assert_same(want, jax_query_sharded(j, qs, 5, 32, mesh=jax_make_mesh(S)))
    monkeypatch.setattr("hnsw_itu_tpu_torch.parallel.mesh.device_groups",
                        lambda m: [[s] for s in range(m.size)])
    with CardPool(mesh) as pool:
        pids = pool.pids
        for _ in range(2):
            before = dma_beam_search.plain_calls
            assert_same(knns_query_sharded(p, qs, 5, 32, pool=pool), want)
            assert dma_beam_search.plain_calls - before == here
            assert pool.pids == pids
        with pytest.raises(ValueError, match="another mesh"):
            knns_query_sharded(p, qs, 5, 32, mesh=cpu_mesh(2), pool=pool)
    assert_same(knns_query_sharded(p, qs, 5, 32, mesh=mesh), want)
    assert not multiprocessing.active_children()


def test_general_knns_on_workers_nsw(jax_index, data, per_shard_workers):
    """ShardedNSW (fixed entries) through the workers equals the caller's
    loop and the JAX index at the same entries."""
    _, qs = data
    idx, ref = carried(jax_index, ShardedNSW), carried(jax_index, ShardedNSW)
    ref._pool = caller_pool(ref.mesh)
    jax_index.query_entry_sample = 0
    try:
        got = idx.knns(qs, K, 32)
        assert not idx._pool.in_caller and idx.last_route == "general"
        assert_same(got, ref.knns(qs, K, 32))
        assert_same(got, jax_index.knns(qs, K, 32))
    finally:
        jax_index.query_entry_sample = JaxShardedHNSW.DEFAULT_ENTRY_SAMPLE
        idx.close()
