"""Command-line interface (port of hnsw_itu_tpu/cli.py).

The six subcommands of ``tpu-hnsw`` with the same flags, defaults, log
lines, result attributes and exit codes: ``query``, ``index``,
``query-index``, ``ground-truth``, ``inspect`` and ``evaluate``. Defaults:
k=10, ef=96, efc=96, m=24, M=256, algorithm=hnsw; ground-truth k=100,
sorted. Result files carry 1-based u64 ids and the data/size/algo/
buildtime/querytime/params attributes.

The work runs on the card: ``main(argv, device=None)`` takes the CUDA
device (``require_cuda``, which raises without one); a caller that wants
the CPU passes ``device="cpu"`` from Python. ``-S/--single-threaded`` is
the one route the user picks onto the host: the build runs wholly on the
native engine (``host_warmup = size``) and the query on
``native.host_knns`` with one thread, after a per-level greedy descent.

Loading and computing are apart, so the card can run the compute where
h5py is missing: ``build_from_points`` and ``query_points`` work on arrays
and ``finish_result`` sorts and pads; ``build_index``, ``query_index`` and
``write_result`` add the HDF5 reading and writing (h5py is imported only
then). The JAX CLI's persistent compile cache has no counterpart here.

Run it as ``python -m hnsw_itu_tpu_torch.cli ...`` or ``tpu-hnsw-torch``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .device import require_cuda
from .models import IndexOptions
from .models.bruteforce import Bruteforce
from .models.hnsw import HNSW, HNSWBuilder
from .models.nsw import NSW, NSWBuilder
from .ops.metrics import sketches_from_u64
from .utils import (BufferedDataset, ResultAttrs, SearchStats, load_index,
                    recall_files, recall_tie_tolerant, save_index)
from .utils import logging as ulog

log = ulog.get("cli")

ALGOS = ("bruteforce", "nsw", "hnsw")
ID_INF = np.iinfo(np.int32).max
# inspect's connectivity check runs the real search (k = ef = size) up to
# this size, and a host BFS over the adjacency past it
SEARCH_CONN_MAX = 4096


def format_size_string(size: int) -> str:
    # main.rs:250-259
    if 90_000 <= size <= 110_000:
        return "100K"
    if 270_000 <= size <= 330_000:
        return "300K"
    if 9_000_000 <= size <= 11_000_000:
        return "10M"
    if 27_000_000 <= size <= 33_000_000:
        return "30M"
    if 90_000_000 <= size <= 110_000_000:
        return "100M"
    return str(size)


def load_points(path, metric="hamming", start=0, length=None) -> np.ndarray:
    """Stream the HDF5 dataset named after ``metric``: u64 sketch words
    for Hamming (int32 words here), float32 vectors for ``l2``, int32 for
    ``l2int``."""
    with BufferedDataset.open(path, metric) as ds:
        if metric == "hamming":
            blocks = [sketches_from_u64(b)
                      for b in ds.iter_chunks(start, length)]
        else:
            dt = np.float32 if metric == "l2" else np.int32
            blocks = [np.asarray(b, dtype=dt)
                      for b in ds.iter_chunks(start, length)]
    if not blocks:
        return np.zeros((0, 32), np.int32)
    return np.concatenate(blocks, axis=0)


def _native_metric_or_exit(metric: str, what: str) -> None:
    from . import native

    if metric not in native.METRIC_CODE:
        raise SystemExit(
            f"--single-threaded {what} need the native host engine, which "
            f"supports {sorted(native.METRIC_CODE)} — not {metric!r}"
        )


def build_from_points(pts: np.ndarray, algorithm: str, opts: IndexOptions,
                      single_threaded: bool, metric: str, device, *,
                      format_size: bool = True):
    """Build an index over host points with build progress and timing;
    returns (index, ResultAttrs). ``opts.size`` becomes the point count;
    ``single_threaded`` builds wholly on the native host engine."""
    size = pts.shape[0]
    opts.size = size
    log.info("Building index size=%d algorithm=%s single_threaded=%s",
             size, algorithm, single_threaded)
    t0 = time.perf_counter()
    if algorithm == "bruteforce":
        idx = Bruteforce(metric, device=device)
        idx.extend(pts)
        idx.build()
    else:
        builder_cls = NSWBuilder if algorithm == "nsw" else HNSWBuilder
        if single_threaded:
            _native_metric_or_exit(metric, "builds")
            # exact sequential insert order (main.rs:203-210): the whole
            # build on the native host engine
            opts.host_warmup = size
        b = builder_cls(opts, metric=metric, device=device)

        def progress(done, total=size, _last=[0]):
            # build heartbeat every 100k rows with percent (main.rs:140-146)
            if done - _last[0] >= 100_000 or done >= total:
                _last[0] = done
                log.info("Processed %d/%d (%d%%)", done, total,
                         done * 100 // max(total, 1))

        b.extend_batched(pts, progress=progress)
        idx = b.build()
        drops = b.total_edge_drops()
        if drops:
            log.info("reverse-edge drops during build: %d (%.3f%% of %d "
                     "appended edges)", drops,
                     drops * 100.0 / max(size * opts.connections, 1),
                     size * opts.connections)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    buildtime = time.perf_counter() - t0
    log.info("Total build time: %.2fs, per element: %.2fus",
             buildtime, buildtime / max(size, 1) * 1e6)
    attrs = ResultAttrs(
        format_size=format_size,
        data=metric,
        size=size,
        algo={"bruteforce": "Bruteforce", "nsw": "Nsw",
              "hnsw": "Hnsw"}[algorithm],
        buildtime=buildtime,
        params=f"index=(efc={opts.ef_construction},m={opts.connections},"
               f"M={opts.max_connections})",
    )
    return idx, attrs


def build_index(datafile, algorithm: str, opts: IndexOptions,
                single_threaded: bool, start=None, length=None,
                metric: str = "hamming", *, device):
    """build_index parity (main.rs:111-179): open, range-slice, then
    ``build_from_points``."""
    log.info("Opening %s", datafile)
    with BufferedDataset.open(datafile, metric) as ds:
        total = ds.size()
    skip = start or 0
    take = length if length is not None else total
    size = min(take, total - skip)
    if take != size:
        log.warning("Dataset range will be smaller than specified len (%d)",
                    size)
    pts = load_points(datafile, metric, start=skip, length=take)
    return build_from_points(pts, algorithm, opts, single_threaded, metric,
                             device,
                             format_size=start is None and length is None)


def _host_query(index, qs: np.ndarray, k: int, ef: int):
    """The ``-S`` query: the native host engine on one thread, entered
    through the per-level ef=1 greedy descent for HNSW (hnsw.rs:285-293),
    ids mapped back through ``id_map``."""
    from . import native

    name = index.metric.name
    points_np = index.points.cpu().numpy()
    if isinstance(index, HNSW):
        eps = np.full((qs.shape[0],), index.ep, np.int32)
        for lv, n_l in zip(reversed(index.levels), reversed(index.level_ns)):
            node_ids = lv.node_ids[:n_l].cpu().numpy()
            _, loc = native.host_knns(
                points_np[node_ids], name, lv.graph.adj[:n_l].cpu().numpy(),
                lv.graph.deg[:n_l].cpu().numpy(), n_l, qs, 1, 1, threads=1,
                eps=eps)
            down = lv.down[:n_l].cpu().numpy()
            eps = down[np.clip(loc[:, 0], 0, n_l - 1)].astype(np.int32)
        graph = index.base
    else:
        graph = index.graph
        eps = np.full((qs.shape[0],), index.ep, np.int32)
    dists, ids = native.host_knns(
        points_np, name, graph.adj.cpu().numpy(), graph.deg.cpu().numpy(),
        index.size(), qs, k, ef, threads=1, eps=eps)
    if index.id_map is not None:
        idm = index.id_map.cpu().numpy()
        ids = np.where(ids >= ID_INF, ids,
                       idm[np.clip(ids, 0, idm.shape[0] - 1)])
    return dists, ids


def query_points(qs: np.ndarray, index, attrs: ResultAttrs, k: int, ef: int,
                 single_threaded: bool = False, query_hop: int = 0):
    """query_index parity on arrays (main.rs:181-222): (dists, ids) as
    host arrays, the visited statistics logged, ``attrs`` given the query
    time and ef. ``query_hop`` > 0 sets the mini path's one-hop rerank."""
    if k > ef:
        log.error("k=%d is greater than ef=%d, this can have adverse "
                  "effects", k, ef)
    log.info("Start querying k=%d ef=%d queries=%d single_threaded=%s",
             k, ef, qs.shape[0], single_threaded)
    t0 = time.perf_counter()
    if single_threaded and not isinstance(index, Bruteforce):
        _native_metric_or_exit(index.metric.name, "queries")
        dists, ids = _host_query(index, qs, k, ef)
    else:
        if hasattr(index, "enable_inline"):
            index.enable_inline()
        if query_hop and hasattr(index, "query_hop"):
            index.query_hop = query_hop
            if index.mini is None:
                log.warning(
                    "--query-hop only applies to the mini-table path; this "
                    "index serves queries via %s, so it is a no-op",
                    "the fused kernel" if index.fused is not None
                    else "the general beam search",
                )
        res = index.knns(qs, k, ef)
        ids = res.ids.cpu().numpy()
        dists = res.dists.cpu().numpy()
    querytime = time.perf_counter() - t0
    log.info("Total query time: %.3fs, per query: %.2fus",
             querytime, querytime / max(qs.shape[0], 1) * 1e6)
    # per-graph-size visited percentiles + distance calls (main.rs:71-109)
    stats = getattr(index, "last_stats", None)
    if stats and "visited_q" in stats:
        s = SearchStats(graph_size=index.size())
        s.record(stats["visited_q"], stats["steps_q"])
        s.report(log)
    attrs.querytime = querytime
    attrs.params = f"{attrs.params},query=(ef={ef})"
    return dists, ids


def query_index(queryfile, index, attrs: ResultAttrs, k: int, ef: int,
                single_threaded: bool = False, query_hop: int = 0):
    """Load the queries, then ``query_points``."""
    log.info("Opening %s", queryfile)
    qs = load_points(queryfile, index.metric.name)
    return query_points(qs, index, attrs, k, ef, single_threaded, query_hop)


def finish_result(ids: np.ndarray, dists: np.ndarray, k: int, sort: bool):
    """Pad short rows by repeating the first element, with a warning
    (main.rs:467-474), then sort each row by (distance, id) when asked.
    Returns (ids, dists)."""
    bad = ids >= ID_INF
    if bad.any():
        log.warning("search returned fewer than k elements; padding")
        ids = np.where(bad, ids[:, :1], ids)
        dists = np.where(bad, dists[:, :1], dists)
    if sort:
        order = np.lexsort((ids, dists), axis=-1)
        ids = np.take_along_axis(ids, order, axis=-1)
        dists = np.take_along_axis(dists, order, axis=-1)
    return ids, dists


def write_result(path, dists, ids, k, sort, attrs: ResultAttrs,
                 write_dists: bool = False):
    """write_result parity (main.rs:262-309): a ``knns`` dataset of
    1-based u64 ids and the file attributes; ``write_dists`` adds the
    distances as a ``dists`` dataset (what ``evaluate --tie-tolerant``
    reads)."""
    log.info("Writing result to %s sort=%s", path, sort)
    ids, dists = finish_result(ids, np.asarray(dists), k, sort)
    out = BufferedDataset.create(path, (ids.shape[0], k), "knns")
    out.write_rows(ids.astype(np.uint64) + 1, 0)
    if write_dists:
        with_d = BufferedDataset.with_file(out.file, (ids.shape[0], k),
                                           "dists")
        with_d.write_rows(dists.astype(np.uint64), 0)
    size = format_size_string(attrs.size) if attrs.format_size \
        else str(attrs.size)
    log.info("Writing result attributes data=%s size=%s algo=%s buildtime=%s "
             "querytime=%s params=%s", attrs.data, size, attrs.algo,
             attrs.buildtime, attrs.querytime, attrs.params)
    out.add_attr("data", attrs.data)
    out.add_attr("size", size)
    out.add_attr("algo", attrs.algo)
    out.add_attr("buildtime", attrs.buildtime)
    out.add_attr("querytime", attrs.querytime)
    out.add_attr("params", attrs.params)
    out.close()


def _opts_from_args(a) -> IndexOptions:
    return IndexOptions(
        ef_construction=a.ef_construction,
        connections=a.connections,
        max_connections=a.max_connections,
        reorder=getattr(a, "reorder", False),
    )


def _device(a) -> torch.device:
    """The caller's device, or the card."""
    return require_cuda() if a.device is None else torch.device(a.device)


# -- subcommand actions ------------------------------------------------------

def cmd_query(a):
    idx, attrs = build_index(a.datafile, a.algorithm, _opts_from_args(a),
                             a.single_threaded, metric=a.metric,
                             device=_device(a))
    if a.indexfile:
        log.info("Serializing index to %s", a.indexfile)
        save_index(a.indexfile, idx, attrs)
    dists, ids = query_index(a.queryfile, idx, attrs, a.k, a.ef,
                             a.single_threaded, query_hop=a.query_hop)
    write_result(a.outfile, dists, ids, a.k, a.sort, attrs,
                 write_dists=a.write_dists)


def cmd_index(a):
    idx, attrs = build_index(a.datafile, a.algorithm, _opts_from_args(a),
                             a.single_threaded, a.start, a.len,
                             metric=a.metric, device=_device(a))
    log.info("Serializing index to %s (size=%d)", a.outfile, idx.size())
    save_index(a.outfile, idx, attrs)


def cmd_query_index(a):
    log.info("Reading index %s", a.indexfile)
    idx, attrs = load_index(a.indexfile, _device(a))
    log.info("Read index size=%d", idx.size())
    dists, ids = query_index(a.queryfile, idx, attrs, a.k, a.ef,
                             a.single_threaded, query_hop=a.query_hop)
    write_result(a.outfile, dists, ids, a.k, a.sort, attrs,
                 write_dists=a.write_dists)


def cmd_ground_truth(a):
    """ground-truth parity (main.rs:716-753): brute-force scan, ``knns``
    and ``dists`` datasets (ids 1-based; u64 distances, float64 for
    ``l2``)."""
    idx, attrs = build_index(a.datafile, "bruteforce", IndexOptions(),
                             False, a.start, a.len, metric=a.metric,
                             device=_device(a))
    dists, ids = query_index(a.queryfile, idx, attrs, a.k, a.k)
    ids, dists = finish_result(ids, dists, a.k, a.sort)
    log.info("Writing result to %s sort=%s", a.outfile, a.sort)
    import h5py

    with h5py.File(a.outfile, "w") as f:
        knns = BufferedDataset.with_file(f, (ids.shape[0], a.k), "knns")
        ddt = np.float64 if a.metric == "l2" else np.uint64
        dd = BufferedDataset.with_file(f, (ids.shape[0], a.k), "dists",
                                       dtype=ddt)
        knns.write_rows(ids.astype(np.uint64) + 1, 0)
        dd.write_rows(dists.astype(ddt), 0)


def _reachability(adj: np.ndarray, n: int, ep: int) -> int:
    """Nodes reachable from ``ep`` over the padded adjacency, by frontier
    BFS on the host (the whole-index search of main.rs:793-800 at any
    scale)."""
    visited = np.zeros(n, bool)
    visited[ep] = True
    frontier = np.array([ep], np.int64)
    while frontier.size:
        nbrs = adj[frontier].ravel()
        nbrs = nbrs[(nbrs >= 0) & (nbrs < n)]
        nbrs = np.unique(nbrs)
        new = nbrs[~visited[nbrs]]
        visited[new] = True
        frontier = new
    return int(visited.sum())


def cmd_inspect(a):
    """inspect parity (main.rs:756-821): attrs, per-layer degree stats
    and percentiles, whole-index connectivity."""
    idx, attrs = load_index(a.indexfile, _device(a))
    print(attrs)

    def print_layer(name, deg, n):
        deg = np.sort(deg[:n].cpu().numpy())
        total = int(deg.sum())
        print(f"\n{name} has {n} nodes, {total} total connections, "
              f"and {total // max(n, 1)} average connections")
        print("connection distribution:")
        for i in range(11):
            j = min(n - 1, n // 10 * i)
            print(f"p{i*10} {int(deg[j])}")

    if isinstance(idx, Bruteforce):
        return
    if isinstance(idx, HNSW):
        for l in range(len(idx.levels) - 1, -1, -1):
            print_layer(f"layer{l}", idx.levels[l].graph.deg,
                        idx.level_ns[l])
        print_layer("base", idx.base.deg, idx.n)
        graph, ep = idx.base, idx.base_ep()
    elif isinstance(idx, NSW):
        print_layer("base", idx.graph.deg, idx.n)
        graph, ep = idx.graph, idx.ep
    # up to SEARCH_CONN_MAX nodes the reference's own check (one query,
    # k = ef = size) through the real search; past it a host BFS answers
    # the same reachability question
    size = idx.size()
    if size <= SEARCH_CONN_MAX:
        res = idx.knns(idx.points[:1], size, size)  # node 0's point
        reached = int((res.ids[0] < ID_INF).sum())
        how = "search with k=ef=size"
    else:
        reached = _reachability(graph.adj.cpu().numpy(), size, ep)
        how = "host BFS from the entry point"
    print(f"\nquery on whole index returned {reached}/{size} elements "
          f"({how})")


def cmd_evaluate(a):
    rec = recall_files(a.result, a.truth, a.k)
    print(f"recall@{a.k or 'k'}: {rec:.5f}")
    if a.tie_tolerant:
        with BufferedDataset.open(a.result, "dists") as r:
            rd = r.read_all()
        with BufferedDataset.open(a.truth, "dists") as t:
            td = t.read_all()
        k = a.k or rd.shape[1]
        tt = recall_tie_tolerant(rd, td[:, : rd.shape[1]], k)
        print(f"tie-tolerant recall@{k}: {tt:.5f}")


# -- parser ------------------------------------------------------------------

def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-hnsw-torch",
        description="HNSW/NSW/bruteforce K-NN index on an NVIDIA GPU "
                    "(hnsw-itu parity; the PyTorch port of tpu-hnsw)",
    )
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-q", "--quiet", action="count", default=0)
    sub = p.add_subparsers(dest="command", required=True)

    def common_build(sp):
        # the HDF5 dataset is named after the metric (l2 = float32,
        # l2int = int32)
        sp.add_argument("--metric", choices=["hamming", "l2", "l2int"],
                        default="hamming")
        sp.add_argument("-c", "--ef-construction", type=int, default=96)
        sp.add_argument("-m", "--connections", type=int, default=24)
        sp.add_argument("-M", "--max-connections", type=int, default=256)
        sp.add_argument("-a", "--algorithm", choices=ALGOS, default="hnsw")
        sp.add_argument("--reorder", action="store_true",
                        help="BFS-relabel the finished graph for memory "
                             "locality (results keep original ids; no "
                             "reference analogue). On the mini-table path "
                             "the relabel's id ties are re-randomized by "
                             "bit-reversed tie keys")
        sp.add_argument("-S", "--single-threaded", action="store_true",
                        help="sequential inserts (exact reference ordering)")

    q = sub.add_parser("query", help="build, query, write result")
    q.add_argument("-d", "--datafile", required=True)
    q.add_argument("-Q", "--queryfile", required=True)
    q.add_argument("-o", "--outfile", default="result.h5")
    q.add_argument("-i", "--indexfile", default=None)
    q.add_argument("-k", type=int, default=10)
    q.add_argument("-e", "--ef", type=int, default=96)
    common_build(q)
    q.add_argument("-s", "--sort", action="store_true")
    q.add_argument("--write-dists", action="store_true",
                   help="also store true distances as a 'dists' dataset "
                        "(enables evaluate --tie-tolerant; no reference "
                        "analogue)")
    q.add_argument("--query-hop", type=int, default=0,
                   help="one-hop exact rerank seeds (mini-table path)")
    q.set_defaults(fn=cmd_query)

    ix = sub.add_parser("index", help="build and serialize an index")
    ix.add_argument("-d", "--datafile", required=True)
    ix.add_argument("-o", "--outfile", default="index.idx")
    ix.add_argument("-b", "--start", type=int, default=None)
    ix.add_argument("-l", "--len", type=int, default=None)
    common_build(ix)
    ix.set_defaults(fn=cmd_index)

    qi = sub.add_parser("query-index", help="query a serialized index")
    qi.add_argument("-i", "--indexfile", required=True)
    qi.add_argument("-Q", "--queryfile", required=True)
    qi.add_argument("-o", "--outfile", default="result.h5")
    qi.add_argument("-k", type=int, default=10)
    qi.add_argument("-e", "--ef", type=int, default=96)
    qi.add_argument("-s", "--sort", action="store_true")
    qi.add_argument("--write-dists", action="store_true",
                    help="also store true distances as a 'dists' dataset")
    qi.add_argument("-S", "--single-threaded", action="store_true")
    qi.add_argument("--query-hop", type=int, default=0,
                    help="one-hop exact rerank seeds (mini-table path)")
    qi.set_defaults(fn=cmd_query_index)

    gt = sub.add_parser("ground-truth", help="exact k-NN via brute force")
    gt.add_argument("-d", "--datafile", required=True)
    gt.add_argument("-Q", "--queryfile", required=True)
    gt.add_argument("-o", "--outfile", default="groundtruth.h5")
    gt.add_argument("-b", "--start", type=int, default=None)
    gt.add_argument("-l", "--len", type=int, default=None)
    gt.add_argument("-k", type=int, default=100)
    gt.add_argument("-s", "--sort", action=argparse.BooleanOptionalAction,
                    default=True)
    gt.add_argument("--metric", choices=["hamming", "l2", "l2int"],
                    default="hamming")
    gt.set_defaults(fn=cmd_ground_truth)

    ins = sub.add_parser("inspect", help="read information from an index")
    ins.add_argument("indexfile")
    ins.set_defaults(fn=cmd_inspect)

    ev = sub.add_parser("evaluate",
                        help="recall@k of a result vs ground truth")
    ev.add_argument("result")
    ev.add_argument("truth")
    ev.add_argument("-k", type=int, default=None)
    ev.add_argument("--tie-tolerant", action="store_true",
                    help="also report distance-threshold recall (immune "
                         "to k-boundary tie-break mismatch; needs dists "
                         "datasets in both files — write the result with "
                         "--write-dists)")
    ev.set_defaults(fn=cmd_evaluate)
    return p


def main(argv=None, device=None) -> int:
    """Run one subcommand. ``device`` None puts the work on the card
    (``require_cuda``, which raises without one); the tests pass
    "cpu"."""
    args = make_parser().parse_args(argv)
    args.device = device
    ulog.setup(args.verbose - args.quiet)
    try:
        args.fn(args)
    except (FileNotFoundError, OSError, ValueError, KeyError) as e:
        # anyhow-style clean error surface (main.rs:31,63)
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
