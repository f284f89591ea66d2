"""Device mesh helpers (port of hnsw_itu_tpu/parallel/mesh.py).

The JAX package drives a 1-D ``jax.sharding.Mesh`` from one process
through ``jax.shard_map``. The port keeps that single-controller model: a
``Mesh`` is an ordered tuple of ``torch.device``s, shard ``s`` keeps its
tensors on ``devices[s]``, and one process drives every shard's work. A
device may appear more than once: several shards then share one card
(the counterpart of the JAX tests' virtual 8-device CPU mesh), and the
CPU tests pass ``["cpu"] * S``.

Work on a mesh of several distinct cards runs in a ``CardPool``: one
long-lived worker process per card, each on its own interpreter, started
once from a fork server and kept until the pool is closed. The caller's
tensors are shared with the workers, not copied: a card's through CUDA
IPC, a CPU tensor through shared memory, so a worker reads the caller's
index and writes the caller's result tensors in place. Both the build and
the queries are bound by the host's Python and launches, not the cards:
from one caller the cards took turns (16 shards on four cards: ``knns``
30-34 ms against about 7 ms of device time a card; 11-13 ms from the
workers, ``PERF.md``). The build
(``map_devices``: a pool for one call) built 4 x 632,512 points in 6.85 s
on four NVIDIA H100 80GB HBM3 at 700.00 W against 16.11 s on one. Python
threads share one interpreter lock, which every PyTorch op releases and
takes back: one worker thread a shard built four shards of one card
5.7-8.9x slower than the caller's loop. A mesh that names one device has
no workers: its work runs in the caller.
"""

from __future__ import annotations

import gc
import multiprocessing
import time
import traceback
import weakref
from multiprocessing.reduction import ForkingPickler
from dataclasses import dataclass

import numpy as np
import torch

from ..device import require_cuda

AXIS = "shard"


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices, one per shard; a device may repeat."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: int | None = None, *, devices=None) -> Mesh:
    """A mesh over exactly ``devices`` (any torch devices, repeats
    allowed) or, without them, over the first ``n_devices`` CUDA cards
    (all of them when None). Raises without a card, and when more cards
    are asked for than exist, as the JAX ``make_mesh`` does."""
    if devices is not None:
        devs = tuple(_device(d) for d in devices)
        if not devs or (n_devices is not None and n_devices != len(devs)):
            raise ValueError(f"n_devices={n_devices} for {len(devs)} devices")
        return Mesh(devs)
    require_cuda(0)
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if not 1 <= n <= have:
        raise ValueError(f"requested {n} devices, have {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def _to(x, device: torch.device) -> torch.Tensor:
    """A tensor on ``device``: a tensor is moved (itself when it is there
    already), a numpy array converted (uint32 words as int32 with the same
    bits)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.require(x, requirements=["C", "W"])  # copies a read-only view
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def shard_leading(mesh: Mesh, x) -> list[torch.Tensor]:
    """Split an [S, ...] array (or a sequence of S arrays) along its
    leading axis: entry ``s`` of the result lies on ``mesh.devices[s]``."""
    if len(x) != mesh.size:
        raise ValueError(f"{len(x)} shards for a mesh of {mesh.size}")
    return [_to(x[s], d) for s, d in enumerate(mesh.devices)]


def replicate(mesh: Mesh, x) -> list[torch.Tensor]:
    """One copy of ``x`` per distinct device of the mesh, listed per shard:
    shards that name the same device share one tensor, and a tensor that
    already lies on a device is not copied there."""
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = _to(x, d)
    return [copies[d] for d in mesh.devices]


def device_groups(mesh: Mesh) -> list[list[int]]:
    """The mesh's shards grouped by device, in order of first appearance,
    each group in shard order."""
    groups: dict[torch.device, list[int]] = {}
    for s, d in enumerate(mesh.devices):
        groups.setdefault(d, []).append(s)
    return list(groups.values())


def _counters() -> list:
    """Every kernel wrapper's launch counters, as (wrapper, name)."""
    from ..ops.dma_search import dma_beam_search
    from ..ops.fused_search import fused_beam_search
    from ..ops.hamming import hamming_block
    from ..ops.mini_search import mini_beam_search

    return [(f, c) for f in (dma_beam_search, fused_beam_search,
                             hamming_block, mini_beam_search)
            for c in ("kernel_launches", "plain_calls")]


def _add_counts(deltas: list) -> None:
    """Add a worker's launch counts (one a counter of ``_counters``) to
    this process's."""
    from ..ops import _kernels

    for (fn, name), n in zip(_counters(), deltas):
        _kernels.count(fn, name, n)


def _run(fn, device, shards, args):
    """One group's work: its card made current and drained before the
    result goes back (so the caller sees every write to the tensors it
    shared). Returns ("ok", result, the launch counts made here)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    before = [getattr(f, c) for f, c in _counters()]
    out = fn(device, shards, args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return "ok", out, [getattr(f, c) - n
                       for (f, c), n in zip(_counters(), before)]


def _handle(store: dict, msg):
    """One message of ``CardPool``'s protocol in a worker; returns the
    reply for the caller."""
    kind = msg[0]
    if kind == "job":  # ("job", fn, keys, keep_cache, device, shards, args)
        fn, keys, _, device, shards, args = msg[1:]
        objs = [store[key] for key in keys]
        return _run(lambda *a: fn(*objs, *a), device, shards, args)
    if kind == "bind":  # ("bind", key, obj)
        store[msg[1]] = msg[2]
    else:  # ("drop", key)
        del store[msg[1]]
    return "ok", None, [0] * len(_counters())


def _work(conn) -> None:
    """A worker process: handles the caller's messages one at a time until
    ``None`` or the caller's end of the pipe closes. Before it replies to
    a job that does not keep its cache (a build, or other one-off work)
    it collects cycles and gives its card's free cached blocks back to
    the driver: a build's must not stay reserved beside a card's tables.
    A query job keeps its temporaries cached for the next one. Each reply
    carries the worker's milliseconds: unpickling the message ("load"),
    the job with its card's synchronize ("job"), the clean-up ("clean").
    On the way out it drops every tensor the caller shared (a worker's
    exit runs no finalizer, so the caller would count them as in use for
    good)."""
    store: dict = {}
    try:
        while True:
            try:
                blob = conn.recv_bytes()
            except EOFError:  # the caller is gone
                break
            t0 = time.perf_counter()
            msg = ForkingPickler.loads(blob)
            del blob
            if msg is None:
                break
            t1 = time.perf_counter()
            try:
                reply = _handle(store, msg)
            except Exception as e:  # sent to the caller, which raises it
                e.add_note(traceback.format_exc())
                e.__traceback__ = None  # its frames hold the shared tensors
                reply = ("error", e, None)
            t2 = time.perf_counter()
            job = msg[0] == "job"
            release = job and not msg[3]
            if release or not job or reply[0] == "error":
                gc.collect()  # cycles that may hold shared tensors
            cuda = release and msg[4].type == "cuda"
            del msg
            if cuda:
                torch.cuda.empty_cache()
            conn.send((*reply, {"load": (t1 - t0) * 1e3,
                                "job": (t2 - t1) * 1e3,
                                "clean": (time.perf_counter() - t2) * 1e3}))
            del reply
    finally:
        store.clear()
        gc.collect()
        conn.close()


def _stop(workers: list) -> None:
    """Stop ``CardPool`` workers: each is asked to end, then joined (killed
    if it does not end within a minute)."""
    for _, conn in workers:
        try:
            conn.send(None)
        except OSError:  # it has died already
            pass
    for proc, conn in workers:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
            proc.join()
        conn.close()
    workers.clear()


class CardPool:
    """A long-lived executor over ``mesh``: one worker process for each
    group of ``device_groups(mesh)`` (one a distinct card), when there are
    several; with one group there are no workers and ``map`` runs in the
    caller.

    Workers fork from a fork server (``multiprocessing`` "forkserver",
    which starts once in the caller's life, with its environment at that
    time), so what they are sent must pickle: functions by name
    (module-level, or a ``functools.partial`` of one), tensors shared (a
    card's through CUDA IPC, a CPU tensor through shared memory), never
    copied. The caller's cards are synchronized before a job goes out, so
    a worker reads what the caller wrote; a worker makes its card current,
    runs its job, synchronizes its card and replies, so the caller may
    read what the worker wrote as soon as the call returns. The workers'
    kernel launch counts are added to the caller's. The first failing
    group's error is raised in the caller, noted with its shards and
    device; a worker that died is reported with its exit code, and the
    pool then refuses every call. Nothing falls back to the caller.

    ``bind`` keeps objects (an index's shard tensors) in the workers until
    ``drop``, so a call sends only its own arguments. ``close`` (or the
    end of a ``with`` block, or the pool's collection, or the caller's
    exit) stops the workers, which first drop everything they hold."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.groups = device_groups(mesh)
        self._workers: list = []  # (process, connection) a group
        self._keys = 0
        self._dead = None  # why the pool refuses calls
        # host ms of the last call: "call" in all; with workers also
        # "dump" (pickling), "sync" (the caller's cards) and, a dict a
        # worker in group order, "workers" (``_work``'s load, job, clean)
        self.last_ms: dict = {}
        self._close = weakref.finalize(self, _stop, self._workers)
        if len(self.groups) == 1:
            return
        # a fork server imports PyTorch and the port once in this process's
        # life; each worker forks from it, with no card touched before it runs
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload([__name__.rsplit(".", 1)[0] + ".sharded"])
        try:
            for _ in self.groups:
                conn, child = ctx.Pipe()
                # daemonic: a worker never outlives this process
                proc = ctx.Process(target=_work, args=(child,), daemon=True)
                proc.start()
                child.close()
                self._workers.append((proc, conn))
        except BaseException:
            self.close()
            raise

    @property
    def pids(self) -> list[int]:
        """The workers' process ids, in group order (none in the caller)."""
        return [proc.pid for proc, _ in self._workers]

    @property
    def in_caller(self) -> bool:
        """True where the mesh names one device: no workers."""
        return len(self.groups) == 1

    def close(self) -> None:
        """Stop the workers (each drops what it holds first); idempotent."""
        self._close()
        self._dead = self._dead or "closed"

    def __enter__(self) -> "CardPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _noted(self, e: BaseException, g: list[int]) -> BaseException:
        e.add_note(f"in shards {g} of {self.mesh.size}, on "
                   f"{self.mesh.devices[g[0]]}")
        return e

    def _exchange(self, msgs: list) -> list:
        """Send ``msgs[j]`` to worker ``j`` and wait for every reply; every
        message is pickled before any is sent, so a job that does not
        pickle reaches no worker. Returns the results in group order, the
        launch counts added here."""
        if self._dead:
            raise RuntimeError(f"card pool over {self.mesh.size} shards "
                               f"refuses calls: {self._dead}")
        t0 = time.perf_counter()
        blobs = [ForkingPickler.dumps(m) for m in msgs]
        t1 = time.perf_counter()
        for d in dict.fromkeys(self.mesh.devices):  # writes still queued
            if d.type == "cuda":                     # on the shared tensors
                torch.cuda.synchronize(d)
        t2 = time.perf_counter()
        sent = []
        for (_, conn), blob in zip(self._workers, blobs):
            try:
                conn.send_bytes(blob)
                sent.append(True)
            except OSError:  # its end of the pipe is gone: it died
                sent.append(False)
        del blobs
        replies = []
        for g, (proc, conn), ok in zip(self.groups, self._workers, sent):
            reply = None
            if ok:
                try:
                    reply = conn.recv()
                except (EOFError, OSError):  # it died before replying
                    pass
            if reply is None:
                proc.join(timeout=60)
                why = f"worker exited with code {proc.exitcode}"
                self._dead = self._dead or (
                    f"{why} (shards {g}, {self.mesh.devices[g[0]]})")
                reply = ("error", RuntimeError(why), None, None)
            replies.append(reply)
        for g, (status, value, _, _) in zip(self.groups, replies):
            if status == "error":
                raise self._noted(value, g)
        for _, _, counts, _ in replies:
            _add_counts(counts)
        self.last_ms = {"call": (time.perf_counter() - t0) * 1e3,
                        "dump": (t1 - t0) * 1e3, "sync": (t2 - t1) * 1e3,
                        "workers": [ms for *_, ms in replies]}
        return [value for _, value, _, _ in replies]

    def map(self, fn, args, *, bound: tuple = (),
            keep_cache: bool = False) -> list:
        """``fn(*objs, device, shards, [args[s] for s in shards])`` for
        every group, at once, ``objs`` the group's objects bound under the
        keys ``bound``; returns ``[(shards, result), ...]`` in group
        order. ``keep_cache``: the workers keep their cards' cached blocks
        for the next job (queries); by default they give them back (a
        build's)."""
        if self.in_caller:
            if bound:
                raise ValueError("a mesh of one device has no workers")
            g = self.groups[0]
            t0 = time.perf_counter()
            try:
                out = [(g, fn(self.mesh.devices[g[0]], g,
                              [args[s] for s in g]))]
            except Exception as e:
                raise self._noted(e, g)
            self.last_ms = {"call": (time.perf_counter() - t0) * 1e3}
            return out
        out = self._exchange([("job", fn, bound, keep_cache,
                               self.mesh.devices[g[0]], g,
                               [args[s] for s in g]) for g in self.groups])
        return list(zip(self.groups, out))

    def bind(self, objs: list) -> int:
        """Keep ``objs[j]`` in worker ``j`` (its tensors shared, not
        copied) until ``drop``; returns the key that ``map`` names."""
        if self.in_caller:
            raise ValueError("a mesh of one device has no workers to bind")
        self._keys += 1
        self._exchange([("bind", self._keys, o) for o in objs])
        return self._keys

    def drop(self, key: int) -> None:
        """Release what ``bind`` kept under ``key`` in every worker."""
        self._exchange([("drop", key)] * len(self.groups))


def map_devices(mesh: Mesh, fn, args) -> list:
    """``fn(device, shards, [args[s] for s in shards])`` for every group
    of ``device_groups(mesh)``, at once, on a ``CardPool`` of its own
    (stopped before this returns); returns ``[(shards, result), ...]`` in
    group order. With one group, ``fn`` runs in the caller's process; with
    more, in one worker process a group. Results should be small: they
    come back through a pipe; tensors in ``args`` are shared, so a worker
    writes the caller's tensors in place."""
    with CardPool(mesh) as pool:
        return pool.map(fn, args)
