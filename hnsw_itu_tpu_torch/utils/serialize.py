"""Index persistence (port of hnsw_itu_tpu/utils/serialize.py: the
``bruteforce``, ``nsw`` and ``hnsw`` kinds of ``.npz`` format v1).

This is how an index crosses between the packages: an index the JAX
package saved loads here as tensors on the caller's device, and the other
way round. ``from_numpy`` underneath turns host arrays into an ``HNSW``;
``builder_from_numpy`` turns a JAX builder's state, as host arrays, into a
port ``HNSWBuilder`` at the same point of the build.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass

import numpy as np
import torch

from ..graph import GraphArrays
from ..models.base import IndexOptions
from ..models.bruteforce import Bruteforce
from ..models.hnsw import HNSW, HNSWBuilder, Level
from ..models.nsw import NSW
from ..ops.metrics import Hamming

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


def _points_np(index) -> np.ndarray:
    """The index's points as the JAX package stores them: Hamming
    sketches as uint32 words, every other metric in its own dtype."""
    a = index.points.cpu().numpy()
    return a.view(np.uint32) if isinstance(index.metric, Hamming) else a


def from_numpy(points, adj, deg, levels, level_ns, ep, n, opts, device, *,
               metric: str = "hamming") -> HNSW:
    """An ``HNSW`` on ``device`` from host arrays: ``points`` [cap, D]
    (uint32 sketch words, or the metric's dtype), ``adj`` int32[cap, W],
    ``deg`` int32[cap], and
    ``levels`` a list of (node_ids, down, adj, deg) int32 arrays."""
    lv = [Level(_t(a, device), _t(d, device),
                GraphArrays(_t(la, device), _t(ld, device)))
          for a, d, la, ld in levels]
    return HNSW(_t(points, device), n,
                GraphArrays(_t(adj, device), _t(deg, device)), lv,
                level_ns, ep, metric, opts, device=device)


def builder_from_numpy(state: dict, opts: IndexOptions, device, *,
                       metric: str = "hamming") -> HNSWBuilder:
    """A port ``HNSWBuilder`` on ``device`` that continues a build from a
    builder's state given as host arrays:

      points     uint32 (or int32) [size, words]
      adj, deg   int32[size, W], int32[size]: the base layer
      spill      int32[size + 1, X]: the spill buffer (its last row, the
                 scatter junk row, is not carried)
      levels     list of (node_ids, down, adj, deg) int32 arrays, at the
                 build capacity of each level
      level_ns, ep, n
      rng_state  ``np.random.RandomState.get_state()`` of the level RNG

    ``opts`` are the builder's options (``size`` = the current capacity).
    """
    def own(a):  # the builder mutates in place: never share the caller's
        return _t(np.array(a), device)

    b = HNSWBuilder(opts, metric, device=device)
    b.points = own(state["points"])
    b.base = GraphArrays(own(state["adj"]), own(state["deg"]))
    b.spill = own(state["spill"])
    b.spill[-1] = -1
    b.levels = [Level(own(a), own(d), GraphArrays(own(la), own(ld)))
                for a, d, la, ld in state["levels"]]
    b.level_ns = [int(x) for x in state["level_ns"]]
    b.ep = None if state["ep"] is None else int(state["ep"])
    b.n = int(state["n"])
    b._rng.set_state(state["rng_state"])
    return b


def save_index(path, index, attrs: ResultAttrs | None = None) -> None:
    """Save a ``Bruteforce``, ``NSW`` or ``HNSW`` as the JAX package
    does."""
    attrs = attrs or ResultAttrs()
    meta = {
        "version": FORMAT_VERSION,
        "metric": index.metric.name,
        "attrs": asdict(attrs),
        "opts": asdict(getattr(index, "opts", IndexOptions())),
    }
    host = lambda t: t.cpu().numpy()  # noqa: E731
    if isinstance(index, Bruteforce):
        meta["kind"] = "bruteforce"
        meta["n"] = index.size()
        arrays = {"points": np.concatenate(index._chunks,
                                           axis=0)[: index.size()]}
    elif isinstance(index, NSW):
        meta.update(kind="nsw", n=index.n, ep=index.ep)
        arrays = {"points": _points_np(index),
                  "adj": host(index.graph.adj), "deg": host(index.graph.deg)}
    elif isinstance(index, HNSW):
        meta.update(kind="hnsw", n=index.n, ep=index.ep,
                    level_ns=index.level_ns)
        arrays = {"points": _points_np(index),
                  "adj": host(index.base.adj), "deg": host(index.base.deg)}
        for l, lv in enumerate(index.levels):
            arrays[f"l{l}_node_ids"] = host(lv.node_ids)
            arrays[f"l{l}_down"] = host(lv.down)
            arrays[f"l{l}_adj"] = host(lv.graph.adj)
            arrays[f"l{l}_deg"] = host(lv.graph.deg)
    else:
        raise TypeError(f"cannot serialize index type {type(index)!r}")
    if getattr(index, "id_map", None) is not None:
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
        opts = IndexOptions(**meta["opts"])
        kind = meta["kind"]
        if kind == "bruteforce":
            idx = Bruteforce(meta["metric"], device=device)
            idx.extend(z["points"])
            idx.build()
        elif kind == "nsw":
            idx = NSW(_t(z["points"], device), meta["n"],
                      GraphArrays(_t(z["adj"], device), _t(z["deg"], device)),
                      meta["ep"], meta["metric"], opts, device=device)
        elif kind == "hnsw":
            levels = [(z[f"l{l}_node_ids"], z[f"l{l}_down"], z[f"l{l}_adj"],
                       z[f"l{l}_deg"]) for l in range(len(meta["level_ns"]))]
            idx = from_numpy(z["points"], z["adj"], z["deg"], levels,
                             meta["level_ns"], meta["ep"], meta["n"], opts,
                             device, metric=meta["metric"])
        else:
            raise ValueError(f"unknown index kind {kind!r}")
        if "id_map" in z.files:
            idx.id_map = _t(z["id_map"], device)
    return idx, ResultAttrs(**meta["attrs"])
