"""Device mesh helpers (port of hnsw_itu_tpu/parallel/mesh.py).

The JAX package drives a 1-D ``jax.sharding.Mesh`` from one process
through ``jax.shard_map``. The port keeps that single-controller model: a
``Mesh`` is an ordered tuple of ``torch.device``s, shard ``s`` keeps its
tensors on ``devices[s]``, and one process drives every shard's work.
CUDA launches return before the device finishes, so work sent to
different cards overlaps. A device may appear more than once: several
shards then share one card (the counterpart of the JAX tests' virtual
8-device CPU mesh), and the CPU tests pass ``["cpu"] * S``.
"""

from __future__ import annotations

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
