"""Traffic kind ``knns_closed_loop``: one client sends batches of queries
to ``knns`` and waits for each answer before sending the next.

Mix parameters: ``batch`` (queries a call), ``pool`` (distinct batches
drawn from the seed, sent in turn), ``keep_stride`` (besides the first
and last call of every batch, every call whose index is the seed's
offset modulo this stride is kept for judging).

Set-up makes the points and the query pool on the card from the seed,
copies both to the host (a client holds its data there), builds the
index with the port's ``HNSWBuilder`` at the configuration's options,
materializes its query table (``enable_inline``; the route has to be
the one the configuration states), sets the query options, and sends
every batch of the pool once. The window then sends batches in turn for
``--seconds`` and at least once each. A call starts when the host hands
``knns`` the batch and ends when the ids and distances are on the host.
A traced run sends the same traffic untraced for ``--seconds`` first
(``trace.py``), then traces its window.

Judged (``judge``): every kept call's answer, each row held to the
exact distances of its ids and to the exact top-k (``reference/``).
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import trace as tr
from portbench.reference import exact, generator, judge as jd


def build_index(ctx, pts_host):
    """The system under test: the port's index at the configuration's
    options, its table and query settings."""
    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
    from hnsw_itu_tpu_torch.ops import _kernels

    cfg = ctx.config
    if ctx.device.type == "cuda":
        _kernels.build_kernels()
    opts = IndexOptions(size=cfg["points"], **cfg["index"])
    b = HNSWBuilder(opts, device=ctx.device)
    b.extend_batched(pts_host)
    index = b.build()
    del b
    index.enable_inline()
    q = cfg["query"]
    index.query_batch = q["query_batch"]
    index.query_entry_sample = q["entry_sample"]
    index.query_entry_beams = q["entry_beams"]
    index.query_hop = q["hop"]
    index.query_tie = q["tie"]
    index.max_steps = q["max_steps"]
    t = cfg["table"]
    got = {"route": index.route(q["k"], q["ef"])}
    if index.mini is not None:
        got.update(W=index.mini_W, mini_words=index.mini_words)
    if got != t:
        raise RuntimeError(f"the index serves {got}, the configuration "
                           f"states {t}")
    return index


def table_shape(index, cfg) -> dict:
    """What the roofline readers need of the table that served."""
    q = cfg["query"]
    words = index.points.shape[1]
    if index.mini is not None:
        return {"route": "mini", "W": index.mini_W,
                "mini_words": index.mini_words, "words": words,
                "ef": max(q["ef"], q["k"])}
    return {"route": "fused", "W": int(index.fused.ids.shape[1]),
            "words": words, "ef": max(q["ef"], q["k"])}


def run(ctx, system=None) -> dict:
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    n, k, ef = cfg["points"], cfg["query"]["k"], cfg["query"]["ef"]
    B, pool = mix["batch"], mix["pool"]
    clock = tr.Phases(ctx.t0)
    pts, qs = generator.make_data(ctx.seed, n, B * pool, dev)
    # uint32 words, as sketches come to a user and as the port takes them
    # without a copy
    pts_host = pts.cpu().numpy().view(np.uint32)
    qs_host = qs.cpu().numpy().view(np.uint32)
    del pts, qs
    batches = [qs_host[b * B : (b + 1) * B] for b in range(pool)]
    clock.lap("data", dev)
    index = (system or build_index)(ctx, pts_host)
    clock.lap("index", dev)
    for q in batches:  # every shape the window sends
        r = index.knns(q, k, ef)
        r.ids.cpu(), r.dists.cpu()
    clock.lap("warm", dev)
    setup_s = time.perf_counter() - ctx.t0

    stride = mix["keep_stride"]
    offset = ctx.seed % stride

    def send(seconds):
        """Batches in turn for ``seconds`` and at least once each."""
        w = SimpleNamespace(lat=[], kept=[], latest={}, stats={},
                            counts=[0] * pool)
        w.start = time.perf_counter()
        deadline = w.start + seconds
        i = 0
        while True:
            b = i % pool
            t = time.perf_counter()
            with torch.profiler.record_function("portbench.call"):
                r = index.knns(batches[b], k, ef)
                ids, d = r.ids.cpu().numpy(), r.dists.cpu().numpy()
            t1 = time.perf_counter()
            w.lat.append(t1 - t)
            w.stats[b] = getattr(index, "last_stats", None)
            w.counts[b] += 1
            w.latest[b] = (i, b, ids, d)
            if i < pool or i % stride == offset:
                w.kept.append(w.latest[b])
            i += 1
            if t1 >= deadline and i >= pool:
                break
        w.calls, w.end = i, t1
        return w

    traced = ctx.trace and dev.type == "cuda"
    with tr.no_gc():
        if traced:  # the same traffic untraced first (trace.py)
            w0 = send(ctx.seconds)
        with tr.profiled(traced, True) as prof:
            w = send(ctx.seconds)
    calls, kept, stats, counts = w.calls, w.kept, w.stats, w.counts
    # and the last call of every batch
    seen = {x[0] for x in kept}
    kept += [x for x in w.latest.values() if x[0] not in seen]
    rec = {"kind": "query", "setup_s": setup_s,
           "window_s": w.end - w.start, "calls": calls, "queries": calls * B,
           "latencies_s": w.lat,
           "kept": kept, "calls_per_batch": counts,
           "attempted": calls, "failed": 0, "phases": clock.laps,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0)}
    if traced:
        rec["trace"] = tr.summarize(prof)
        rec["untraced"] = {"window_s": w0.end - w0.start, "calls": w0.calls}
        rec["notes"] = {"traced_per_untraced_call": (
            rec["window_s"] / calls) / (rec["untraced"]["window_s"]
                                        / w0.calls)}
    if all(s is not None for s in stats.values()):
        rec["search_stats"] = {b: {"steps": s["steps"],
                                   "visited": s["visited"],
                                   "queries": s["queries"]}
                               for b, s in stats.items()}
        rec["table"] = table_shape(index, cfg)
    rec["host"] = (pts_host, batches)
    del index, stats, w
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def judge(ctx, rec) -> list:
    """bad_rows (limit 0) and recall_miss (limit: 1 - the configuration's
    recall@k); sets ``recall_at_10`` in ``rec``."""
    dev, k = ctx.device, ctx.config["query"]["k"]
    pts_host, batches = rec.pop("host")
    pts = torch.from_numpy(pts_host.view(np.int32)).to(dev)
    n = pts.shape[0]
    qs = [torch.from_numpy(q.view(np.int32)).to(dev) for q in batches]
    gt = []
    for q in qs:
        d, i = exact.exact_topk(pts, q, k)
        if exact.check_topk(pts, q, d, i):
            raise RuntimeError("the reference's top-k is not exact")
        gt.append(i)
    bad, worst = 0, 1.0
    first = {}
    for i, b, ids, d in rec["kept"]:
        bad_i = jd.bad_answer_rows(pts, qs[b], ids, d, n)
        r = float(jd.recall(ids, gt[b]).mean())
        bad += bad_i
        worst = min(worst, r)
        first.setdefault(b, r)
        rec["failed"] += bad_i > 0
    rec["recall_at_10"] = float(np.mean([first[b] for b in sorted(first)]))
    rec["judged_calls"] = len(rec["kept"])
    limit = round(1.0 - ctx.config["guarantee"]["recall_at_10"], 6)
    return [("bad_rows", bad, 0), ("recall_miss", 1.0 - worst, limit)]
