"""Index persistence (port of hnsw_itu_tpu/utils/serialize.py, the
``hnsw`` kind of ``.npz`` format v1).

This is how a graph crosses between the packages: an index the JAX package
saved loads here as tensors on the caller's device, and the other way
round. ``from_numpy`` underneath turns host arrays into an ``HNSW``.
The ``bruteforce`` and ``nsw`` kinds come with slice 2.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass

import numpy as np
import torch

from ..graph import GraphArrays
from ..models.base import IndexOptions
from ..models.hnsw import HNSW, Level

FORMAT_VERSION = 1


@dataclass
class ResultAttrs:
    """Run metadata persisted with results/indexes (main.rs:311-334)."""

    format_size: bool = True
    data: str = "hamming"
    size: int = 0
    algo: str = "Bruteforce"
    buildtime: float = 0.0
    querytime: float = 0.0
    params: str = ""


def _t(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)  # sketch words keep their bit patterns
    return torch.from_numpy(a).to(device)


def from_numpy(points, adj, deg, levels, level_ns, ep, n, opts, device, *,
               metric: str = "hamming") -> HNSW:
    """An ``HNSW`` on ``device`` from host arrays: ``points`` uint32 (or
    int32) [cap, words], ``adj`` int32[cap, W], ``deg`` int32[cap], and
    ``levels`` a list of (node_ids, down, adj, deg) int32 arrays."""
    lv = [Level(_t(a, device), _t(d, device),
                GraphArrays(_t(la, device), _t(ld, device)))
          for a, d, la, ld in levels]
    return HNSW(_t(points, device), n,
                GraphArrays(_t(adj, device), _t(deg, device)), lv,
                level_ns, ep, metric, opts, device=device)


def save_index(path, index: HNSW, attrs: ResultAttrs | None = None) -> None:
    if not isinstance(index, HNSW):
        raise NotImplementedError(
            f"saving {type(index).__name__} is not ported yet (slice 2)")
    attrs = attrs or ResultAttrs()
    meta = {
        "version": FORMAT_VERSION,
        "metric": index.metric.name,
        "attrs": asdict(attrs),
        "opts": asdict(index.opts),
        "kind": "hnsw",
        "n": index.n,
        "ep": index.ep,
        "level_ns": index.level_ns,
    }
    host = lambda t: t.cpu().numpy()  # noqa: E731
    arrays = {
        "points": host(index.points).view(np.uint32),
        "adj": host(index.base.adj),
        "deg": host(index.base.deg),
    }
    for l, lv in enumerate(index.levels):
        arrays[f"l{l}_node_ids"] = host(lv.node_ids)
        arrays[f"l{l}_down"] = host(lv.down)
        arrays[f"l{l}_adj"] = host(lv.graph.adj)
        arrays[f"l{l}_deg"] = host(lv.graph.deg)
    if index.id_map is not None:
        arrays["id_map"] = host(index.id_map)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_index(path, device):
    """Returns (index, ResultAttrs), the index's tensors on ``device``."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported index format version {meta.get('version')}")
        if meta["kind"] != "hnsw":
            raise NotImplementedError(
                f"loading a {meta['kind']!r} index is not ported yet "
                "(slice 2)")
        levels = [(z[f"l{l}_node_ids"], z[f"l{l}_down"], z[f"l{l}_adj"],
                   z[f"l{l}_deg"]) for l in range(len(meta["level_ns"]))]
        idx = from_numpy(z["points"], z["adj"], z["deg"], levels,
                         meta["level_ns"], meta["ep"], meta["n"],
                         IndexOptions(**meta["opts"]), device,
                         metric=meta["metric"])
        if "id_map" in z.files:
            idx.id_map = _t(z["id_map"], device)
    return idx, ResultAttrs(**meta["attrs"])
