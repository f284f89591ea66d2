"""Device mesh helpers (port of hnsw_itu_tpu/parallel/mesh.py).

The JAX package drives a 1-D ``jax.sharding.Mesh`` from one process
through ``jax.shard_map``. The port keeps that single-controller model: a
``Mesh`` is an ordered tuple of ``torch.device``s, shard ``s`` keeps its
tensors on ``devices[s]``, and one process drives every shard's work. A
device may appear more than once: several shards then share one card
(the counterpart of the JAX tests' virtual 8-device CPU mesh), and the
CPU tests pass ``["cpu"] * S``.

The sharded ``knns`` loops over the shards in the caller: no launch
waits for its card, so the cards run their shards at once, but the
caller's launches bound it (16 shards on four cards: 25-35 ms against
6-7 ms of device time a card). The build is bound by the host's Python
and launches (hundreds of small ops a chunk and shard) and reads counts
back several times a chunk, so ``map_devices`` runs it with one worker
process per distinct card, each on its own interpreter, writing the
caller's shard tensors in place through CUDA IPC: 4 x 632,512 points
built in 6.85 s on four NVIDIA H100 80GB HBM3 at 700.00 W against 16.11
s on one (2.35x; 3.2x inside the workers; ``PERF.md``). Python threads
share one interpreter lock, which every PyTorch op releases and takes
back: one worker thread a shard built four shards of one card 5.7-8.9x
slower than the caller's loop.
"""

from __future__ import annotations

import gc
import multiprocessing
import traceback
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


def _work(conn) -> None:
    """A worker process: receives one job (fn, device, shards, args),
    runs it, releases the caller's shared tensors (a worker's exit runs
    no finalizer, so the caller would count them as in use for good),
    then replies with ``_run``'s triple or ("error", the exception with
    its traceback noted on it, None)."""
    job = conn.recv()
    try:
        reply = _run(*job)
    except Exception as e:  # sent to the caller, which raises it
        e.add_note(traceback.format_exc())
        e.__traceback__ = None  # its frames hold the shared tensors
        reply = ("error", e, None)
    del job
    gc.collect()
    conn.send(reply)
    conn.close()


def map_devices(mesh: Mesh, fn, args) -> list:
    """``fn(device, shards, [args[s] for s in shards])`` for every group
    of ``device_groups(mesh)``, at once; returns ``[(shards, result),
    ...]`` in group order.

    With one group, ``fn`` runs in the caller's process. With more, each
    group runs in a worker process of its own, forked from a fork server
    (``multiprocessing`` "forkserver", which starts once, with the
    caller's environment at that time): ``fn`` must be a module-level
    function (or a ``functools.partial`` of one), and its arguments and
    result must pickle. Tensors in ``args`` are shared, not copied: a
    card's through CUDA IPC, a CPU tensor through shared memory
    (``torch.multiprocessing``), so a worker writes the caller's tensors
    in place. Results should be small: they come back through a pipe. The
    kernel wrappers' launch counters of the workers are added to the
    caller's. Every worker is joined before this returns; the error of the
    first failing group is raised here, noted with its shards and
    device."""
    groups = device_groups(mesh)

    def noted(e, g):
        e.add_note(f"in shards {g} of {mesh.size}, on {mesh.devices[g[0]]}")
        return e

    if len(groups) == 1:
        g = groups[0]
        try:
            return [(g, fn(mesh.devices[g[0]], g, [args[s] for s in g]))]
        except Exception as e:
            raise noted(e, g)
    # a fork server imports PyTorch and the port once in this process's
    # life; each worker forks from it, with no card touched before it runs
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__.rsplit(".", 1)[0] + ".sharded"])
    workers = []
    try:
        for g in groups:
            conn, child = ctx.Pipe()
            # daemonic: a worker never outlives this process
            proc = ctx.Process(target=_work, args=(child,), daemon=True)
            proc.start()
            child.close()
            workers.append((proc, conn))
        for g, (_, conn) in zip(groups, workers):
            conn.send((fn, mesh.devices[g[0]], g, [args[s] for s in g]))
    except BaseException:  # a job that does not pickle, say: stop them all
        for proc, conn in workers:
            proc.kill()
            proc.join()
            conn.close()
        raise
    replies = []
    for proc, conn in workers:
        try:
            reply = conn.recv()
        except EOFError:  # the worker died before it could reply
            reply = None
        conn.close()
        proc.join()
        replies.append(reply or ("error", RuntimeError(
            f"worker exited with code {proc.exitcode}"), None))
    for g, (status, value, _) in zip(groups, replies):
        if status == "error":
            raise noted(value, g)
    out = []
    for g, (_, result, counts) in zip(groups, replies):
        _add_counts(counts)
        out.append((g, result))
    return out
