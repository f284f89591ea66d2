#!/usr/bin/env python3
"""Drive the PyTorch port's query path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--n 100000] [--nq 10000]

Run from the root of a checkout. Phases, each printed as it ends:

  1. card and build: nvidia-smi's name and power limit, torch and CUDA
     versions, and the fused beam-search kernel compiled by nvcc from
     hnsw_itu_tpu_torch/csrc/ for sm_90a;
  2. small random graphs: kernel against its plain PyTorch version for the
     seven (W, ef) pairs of the JAX kernel's contract and the clamped-key
     case, keys/visited/steps equal;
  3. data and build: make_dataset(0, n, nq), the HNSW built on the host by
     the native engine (efc=96, m=24, M=64), tensors on the card;
  4. oracle: exact k=10 ground truth on the card, its distances equal to
     the native host scan's on 256 queries;
  5. query: sampled entry (1024) + fused kernel at k=10, ef=32, 32 steps,
     one batch; warm run, then the best of 3; recall@10 >= 0.93, the
     kernel launched and the plain version never called;
  6. kernel against the plain version at the slice shapes: every query,
     the same init keys, keys/visited/steps equal; both timed.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits nonzero
without that line; so does a machine without CUDA, and a directory
without the package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
K, EF, MAX_STEPS, SAMPLE = 10, 32, 32, 1024
RECALL_GATE = 0.93  # bench.py's gate
KERNEL_SRC = "hnsw_itu_tpu_torch/csrc/fused_beam_search.cu"
KERNEL_REPLACES = "hnsw_itu_tpu/ops/pallas_search.py:267"
PAIRS = [(16, 24), (32, 64), (64, 48), (32, 32), (32, 16), (64, 96),
         (32, 128)]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back
    runs, by CUDA events, after one warm run."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_diff(got, want) -> int:
    """Largest |got - want| over tuples of int32 tensors (0 = equal)."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def random_graph(rng, cap, w, words):
    import numpy as np

    pts = rng.integers(0, 2**32, size=(cap, words), dtype=np.uint32)
    adj = np.full((cap, w), -1, np.int32)
    for i in range(cap):
        deg = rng.integers(w // 2, w + 1)
        adj[i, :deg] = rng.choice(cap, size=deg, replace=False)
    return pts, adj


def phase_card():
    import torch

    from hnsw_itu_tpu_torch.ops import _kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}, python {sys.version.split()[0]}")
    _kernels.load_fused_beam_search(rebuild=True)
    info = _kernels.BUILD_INFO["fused_beam_search"]
    log(f"[1] built {KERNEL_SRC} with nvcc {' '.join(_kernels.NVCC_FLAGS)} "
        f"in {info['seconds']:.1f} s -> "
        f"{os.path.relpath(info['path'], HERE)}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[1]   ptxas: {line.strip()}")
    return smi


def phase_small_graphs(dev) -> int:
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.ops.fused_search import (fused_beam_search,
                                                     key_clamp,
                                                     materialize_fused)
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches, popcount_sum
    from hnsw_itu_tpu_torch.ops.search import beam_search_packed

    worst = 0
    cases = [(w, ef, 8, False) for w, ef in PAIRS] + [(16, 24, 25, True)]
    for w, ef, id_bits, clamped in cases:
        cap, words, B = 256, 32, 32
        rng = np.random.default_rng(w * 1000 + ef + clamped)
        pts, adj = random_graph(rng, cap, w, words)
        if clamped:  # low-diameter points: distances stay under the clamp
            flips = np.packbits(rng.random((cap, words * 32)) < 0.02,
                                axis=-1).view(np.uint32)
            pts = pts[0][None] ^ flips
        qs = pts[rng.integers(0, cap, size=B)] if clamped else \
            rng.integers(0, 2**32, size=(B, words), dtype=np.uint32)
        max_d = key_clamp(id_bits, words * 32)
        p, q = as_sketches(pts, dev), as_sketches(qs, dev)
        table = materialize_fused(p, torch.from_numpy(adj).to(dev))
        init = popcount_sum(q ^ p[0]).clamp(max=max_d) << id_bits
        kw = dict(ef=ef, id_bits=id_bits, max_d=max_d, max_steps=256)
        got = fused_beam_search(table, q, init, **kw)
        want = beam_search_packed(table.ids, table.data, q, init, **kw)
        torch.cuda.synchronize()
        err = max_abs_diff(got, want)
        worst = max(worst, err)
        log(f"[2] W={w} ef={ef} id_bits={id_bits}: kernel vs plain "
            f"max |diff| {err} over keys, visited, steps "
            f"(visited/q {got[1].float().mean():.1f}, "
            f"steps/q {got[2].float().mean():.1f})")
        if err:
            raise AssertionError(f"kernel != plain at W={w} ef={ef}")
    return worst


def phase_build(n, nq, dev):
    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
    from hnsw_itu_tpu_torch.utils import make_dataset

    t0 = time.perf_counter()
    pts, qs = make_dataset(0, n, nq)
    log(f"[3] make_dataset(0, {n}, {nq}): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    b = HNSWBuilder(IndexOptions(ef_construction=96, connections=24,
                                 max_connections=64, size=n, batch_size=256,
                                 host_warmup=n), device=dev)
    b.extend_batched(pts)
    index = b.build()
    log(f"[3] host build (native engine) + upload: "
        f"{time.perf_counter() - t0:.1f} s, levels {index.level_ns}, "
        f"ep {index.ep}")
    return pts, qs, index


def phase_oracle(pts, qs, dev):
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch import native
    from hnsw_itu_tpu_torch.models import Bruteforce

    t0 = time.perf_counter()
    bf = Bruteforce("hamming", device=dev)
    bf.extend(pts)
    gt = bf.build().knns(qs, K)
    torch.cuda.synchronize()
    gt_d, gt_i = gt.dists.cpu().numpy(), gt.ids.cpu().numpy()
    log(f"[4] oracle on the card: {time.perf_counter() - t0:.2f} s for "
        f"{len(qs)} x {len(pts)}")
    d_host, _ = native.host_bruteforce(pts, "hamming", qs[:256], K)
    if not np.array_equal(gt_d[:256], d_host):
        raise AssertionError("oracle distances != native host scan")
    log("[4] oracle distances equal the native host scan on 256 queries")
    return gt_i


def phase_query(index, qs, gt_i, dev):
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches
    from hnsw_itu_tpu_torch.utils import recall_at_k

    nq = len(qs)
    index.query_entry_sample = SAMPLE
    index.max_steps = MAX_STEPS
    index.query_batch = max(10240, nq)
    t0 = time.perf_counter()
    index.enable_inline()
    torch.cuda.synchronize()
    if index.fused is None:
        raise AssertionError("fused table not built")
    log(f"[5] fused table {tuple(index.fused.data.shape)}: "
        f"{index.fused.data.numel() * 4 / 1e9:.3f} GB data + ids, built in "
        f"{time.perf_counter() - t0:.2f} s")
    q = as_sketches(qs, dev)
    index.knns(q, K, EF)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        res = index.knns(q, K, EF)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
    if ids.shape != (nq, K) or dists.shape != (nq, K):
        raise AssertionError(f"result shape {ids.shape}, want {(nq, K)}")
    if not ((ids >= 0) & (ids < index.n)).all() or not (
            (dists >= 0) & (dists <= 1024)).all():
        raise AssertionError("ids or distances out of range")
    if not (np.diff(dists, axis=1) >= 0).all():
        raise AssertionError("distances not ascending")
    rec = recall_at_k(ids, gt_i, K)
    vis = index.last_stats["visited"] / nq
    steps = index.last_stats["steps"] / nq
    log(f"[5] knns k={K} ef={EF} max_steps={MAX_STEPS}: best of 3 "
        f"{best * 1e3:.2f} ms for {nq} queries = {nq / best:,.0f} QPS, "
        f"recall@10 {rec:.4f}, visited/q {vis:.1f}, steps/q {steps:.2f}")
    log(f"[5] kernel_launches {fused_beam_search.kernel_launches}, "
        f"plain_calls {fused_beam_search.plain_calls}")
    if rec < RECALL_GATE:
        raise AssertionError(f"recall@10 {rec:.4f} < {RECALL_GATE}")
    return best


def phase_slice_shapes(index, qs, dev, smi, knns_s):
    import torch

    from hnsw_itu_tpu_torch.models.nsw import _id_bits
    from hnsw_itu_tpu_torch.ops.entry import sampled_entry
    from hnsw_itu_tpu_torch.ops.fused_search import (fused_beam_search,
                                                     key_clamp)
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches, popcount_sum
    from hnsw_itu_tpu_torch.ops.search import beam_search_packed

    q = as_sketches(qs, dev)
    words = q.shape[1]
    id_bits = _id_bits(index.fused.cap)
    max_d = key_clamp(id_bits, words * 32)

    def entry():
        return sampled_entry(index.points, q, index.n, sample_size=SAMPLE,
                             metric=index.metric)

    eps = entry()
    d0 = popcount_sum(index.points[eps.long()] ^ q)
    order = torch.argsort(d0, stable=True)
    qs_o = q[order].contiguous()
    init = ((d0[order].clamp(max=max_d) << id_bits) | eps[order]).contiguous()
    kw = dict(ef=EF, id_bits=id_bits, max_d=max_d, max_steps=MAX_STEPS)
    got = fused_beam_search(index.fused, qs_o, init, **kw)
    want = beam_search_packed(index.fused.ids, index.fused.data, qs_o, init,
                              **kw)
    torch.cuda.synchronize()
    err = max_abs_diff(got, want)
    log(f"[6] {len(qs)} queries at N={index.n}: kernel vs plain max |diff| "
        f"{err} over keys, visited, steps")
    if err:
        raise AssertionError("kernel != plain at the slice shapes")
    k_ms = cuda_ms(lambda: fused_beam_search(index.fused, qs_o, init, **kw),
                   10)
    p_ms = cuda_ms(lambda: beam_search_packed(
        index.fused.ids, index.fused.data, qs_o, init, **kw), 2)
    e_ms = cuda_ms(entry, 10)
    log(f"[6] on {smi}: fused kernel {k_ms:.3f} ms, plain version "
        f"{p_ms:.3f} ms, sampled entry {e_ms:.3f} ms, whole knns "
        f"{knns_s * 1e3:.3f} ms (host clock), for {len(qs)} queries")
    return err, k_ms, p_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000, help="index points")
    ap.add_argument("--nq", type=int, default=10_000, help="queries")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "hnsw_itu_tpu_torch")):
        print("chip_smoke: hnsw_itu_tpu_torch/ not found beside the script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from hnsw_itu_tpu_torch import require_cuda
    from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search

    dev = require_cuda(0)
    t_start = time.perf_counter()
    smi = phase_card()
    err_small = phase_small_graphs(dev)

    # the main path: build, table, queries; only its launches count
    fused_beam_search.kernel_launches = 0
    fused_beam_search.plain_calls = 0
    pts, qs, index = phase_build(args.n, args.nq, dev)
    gt_i = phase_oracle(pts, qs, dev)
    knns_s = phase_query(index, qs, gt_i, dev)
    launches = fused_beam_search.kernel_launches
    plain = fused_beam_search.plain_calls
    if launches <= 0 or plain != 0:
        raise AssertionError(
            f"main path launches {launches}, plain calls {plain}")

    err_slice, k_ms, p_ms = phase_slice_shapes(index, qs, dev, smi, knns_s)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": [{
        "name": "fused_beam_search",
        "route": "cuda",
        "source": KERNEL_SRC,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max(err_small, err_slice),
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
