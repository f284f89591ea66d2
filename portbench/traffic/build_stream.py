"""Traffic kind ``build_stream``: rows arrive as one stream and are
inserted into the index in the configuration's chunks.

Mix parameters: ``warm_rows`` (rows inserted in set-up: the native
warmup, then device chunks until every chunk is full-size),
``eval_queries`` (queries of the reference's search over the graph),
``eval_rows`` (window rows whose nearest earlier neighbor is checked),
``nearest_miss_limit`` (the limit of that check).

Set-up makes the configuration's points and the evaluation queries on
the card from the seed, copies them to the host, and inserts the first
``warm_rows`` with ``HNSWBuilder.extend_batched``. The window then hands
the builder the stream's next rows a group at a time (``scan_group``
chunks of ``batch_size * 16`` rows) until ``--seconds`` have passed or
the stream ends; a group ends with a synchronize. A traced run inserts
the stream's rows untraced for ``--seconds`` first (``trace.py``), then
traces its window; all are judged.

Judged (``judge``) on the base-layer graph the builder holds after the
window, over every row handed to it:

* ``bad_rows``: rows that break the graph's invariants
  (``reference/graph.py``);
* ``recall_miss``: 1 - recall@k of the reference's own beam search over
  the graph, at the configuration's query settings (entry sample, ef,
  ``max_steps``), against the exact top-k of those rows;
* ``nearest_miss``: the share of ``eval_rows`` window rows, drawn from
  the seed, that list no neighbor at the exact distance of their nearest
  row among those inserted before their chunk. The build selects on
  distances; selected at a lower precision, the nearest is missed more
  often, though the graph stays sound and searchable.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import trace as tr
from portbench.reference import exact, generator, graph as rg, judge as jd


def make_builder(ctx):
    """The system under test: the port's builder at the configuration's
    options."""
    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
    from hnsw_itu_tpu_torch.ops import _kernels

    if ctx.device.type == "cuda":
        _kernels.build_kernels()
    opts = IndexOptions(size=ctx.config["points"], **ctx.config["index"])
    return HNSWBuilder(opts, device=ctx.device)


def run(ctx, system=None) -> dict:
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    n = cfg["points"]
    opts = cfg["index"]
    chunk = opts["batch_size"] * 16
    group = chunk * opts["scan_group"]
    clock = tr.Phases(ctx.t0)
    pts, qs = generator.make_data(ctx.seed, n, mix["eval_queries"], dev)
    pts_host = pts.cpu().numpy().view(np.uint32)
    qs_host = qs.cpu().numpy()
    del pts, qs
    clock.lap("data", dev)
    b = (system or make_builder)(ctx)
    warm = min(n, mix["warm_rows"])
    b.extend_batched(pts_host[:warm])
    clock.lap("warm_rows", dev)
    setup_s = time.perf_counter() - ctx.t0

    traced = ctx.trace and dev.type == "cuda"
    off = warm

    def send(seconds):
        """Groups of the stream's next rows for ``seconds``, at least one:
        (groups, start, end)."""
        nonlocal off
        groups, start = 0, time.perf_counter()
        deadline = start + seconds
        while off < n:
            take = min(group, n - off)
            with torch.profiler.record_function("portbench.group"):
                b.extend_batched(pts_host[off : off + take])
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            off += take
            groups += 1
            if time.perf_counter() >= deadline:
                break
        return groups, start, time.perf_counter()

    with tr.no_gc():
        if traced:  # the same traffic untraced first (trace.py)
            o0 = off
            _, s0, e0 = send(ctx.seconds)
            untraced = {"window_s": e0 - s0,
                        "chunks": math.ceil((off - o0) / chunk)}
            b.timings = {}
        first = off
        with tr.profiled(traced, True) as prof:
            groups, start, end = send(ctx.seconds)
        rows = off - first
    rec = {"kind": "build", "setup_s": setup_s, "window_s": end - start,
           "rows": rows, "warm_rows": warm, "chunk_rows": chunk,
           "chunks": math.ceil(rows / chunk),
           "groups": groups, "attempted": groups, "failed": 0,
           "phases": clock.laps,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0)}
    if traced:
        from hnsw_itu_tpu_torch.models import _build

        rec.update(trace=tr.summarize(prof), untraced=untraced,
                   spans_ms=_build.span_ms(b.timings))
        if rec["chunks"] and untraced["chunks"]:
            rec["notes"] = {"traced_per_untraced_chunk": (
                rec["window_s"] / rec["chunks"]) / (untraced["window_s"]
                                                    / untraced["chunks"])}
    g = b.base
    rec["graph"] = (g.adj, g.deg)
    rec["host"] = (pts_host, qs_host, off)
    del b, g
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def judge(ctx, rec) -> list:
    """bad_rows (limit 0), recall_miss (limit: 1 - the configuration's
    recall@k) and nearest_miss (limit: the mix's)."""
    mix, dev, q = ctx.mix, ctx.device, ctx.config["query"]
    k, ef = q["k"], q["ef"]
    adj, deg = rec.pop("graph")
    pts_host, qs_host, n = rec.pop("host")
    bad = rg.bad_rows(adj, deg, n)
    pts = torch.from_numpy(pts_host[:n].view(np.int32)).to(dev)
    qs = torch.from_numpy(qs_host).to(dev)
    entry = rg.strided_entry(pts, qs, n, q["entry_sample"])
    # max_steps "auto" as the configuration's route resolves it
    steps = q["max_steps"] or max(2 * ef, 64)
    _, ids = rg.beam_search(pts, adj, qs, entry, n=n, ef=max(ef, k), k=k,
                            max_steps=steps)
    gd, gi = exact.exact_topk(pts, qs, k)
    if exact.check_topk(pts, qs, gd, gi):
        raise RuntimeError("the reference's top-k is not exact")
    r = float(jd.recall(ids, gi).mean())
    # window rows drawn from the seed; each chunk's search saw the rows
    # inserted before the chunk
    warm, chunk = rec["warm_rows"], rec["chunk_rows"]
    take = min(mix["eval_rows"], n - warm)
    rows = warm + np.sort(np.random.default_rng(ctx.seed).choice(
        n - warm, take, replace=False))
    limits = warm + (rows - warm) // chunk * chunk
    gaps = rg.nearest_gaps(pts, adj, torch.from_numpy(rows).to(dev),
                           torch.from_numpy(limits).to(dev))
    miss = float((gaps > 0).double().mean()) if take else 0.0
    found = gaps[gaps != exact.INF]
    rec.setdefault("notes", {}).update(
        graph_recall=r, nearest_gap_mean=float(found.double().mean())
        if found.numel() else None)
    rec["failed"] = int(bad > 0)
    limit = round(1.0 - ctx.config["guarantee"]["recall_at_10"], 6)
    return [("bad_rows", bad, 0), ("recall_miss", 1.0 - r, limit),
            ("nearest_miss", miss, mix["nearest_miss_limit"])]
