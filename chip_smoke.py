#!/usr/bin/env python3
"""Drive the PyTorch port's query paths and its batched builds once on one
NVIDIA GPU and check them; with ``--cards 4``, its sharded paths on four.

    python3 chip_smoke.py [--n 100000] [--nq 10000] [--mini-n 2200000]
                          [--build-n 1000000] [--cli-n 1000000]
                          [--shards 4] [--shard-n 632512]
                          [--flagship-n 10120192] [--cards 1|4]

Run from the root of a checkout. Phases 1-18 run by default, on card 0;
``--cards 4`` runs phase 1 and phase 19 alone, and raises below four
cards. Phases, each printed as it ends:

  1. card and build: nvidia-smi's name and power limit, torch and CUDA
     versions, and the five kernels compiled by nvcc from
     hnsw_itu_tpu_torch/csrc/ for sm_90a (one nvcc each, in parallel),
     with ptxas's register and spill lines for every instance, and the
     three beam kernels' resident warps per SM;
  2. small random cases: each kernel against its plain PyTorch version:
     the fused kernel for the seven (W, ef) pairs of the JAX kernel's
     contract and the clamped-key case (keys/visited/steps equal), the
     mini kernel for the seven (W, ef, mini_words) cases of the JAX mini
     kernels' contract with 1, 4 and 8 seeds and tie_bits 0 and 8
     (d/ids/visited/steps equal), the gather kernel across W, ef, seeds,
     a node map and repeated ids (keys/visited/steps equal), the Hamming
     block kernel on odd and batched shapes, the three beam kernels on
     the edges of their id set, slots and merge (W 128 and 24, all-fresh
     and one-id rows, ef 1 and 128; for the gather and mini kernels ids
     near 2^31 - 1, colliding ids, ef seeds, tie_bits 31 and seeds that
     repeat an id; for the fused kernel a row repeating an id with another
     sketch, keys at the clamp of id_bits 25 and 30, ids at 2^id_bits - 1,
     max_steps 0), the cases of hnsw_itu_tpu_torch/testing.py;
  3. data and build: make_dataset(0, n, nq), the HNSW built on the host by
     the native engine (efc=96, m=24, M=64), tensors on the card;
  4. oracle: exact k=10 ground truth on the card, its distances equal to
     the native host scan's on 256 queries;
  5. query: sampled entry (1024) + fused kernel at k=10, ef=32, 32 steps,
     one batch; warm run, then the best of 3; recall@10 >= 0.93, the
     kernel launched and the plain version never called;
  6. kernel against the plain version at the slice shapes: every query,
     the same init keys, keys/visited/steps equal; both timed, with the
     bound and the resident warps; then the ef sweep (32 to 128 at 32
     steps), each point also against the plain version;
  7. the mini path, with the 100k index freed: make_dataset(0, mini_n,
     nq) built on the card as phase 9 builds (a 50k native warmup, then
     device chunks on the gather and Hamming block kernels) into at least
     2.2M rows, past the 2^21 ids an int32 packed key holds, so the
     policy refuses the fused table by itself; the oracle,
     enable_inline() picking the mini table, and knns at k=10, ef=32
     (sampled entry 1024, max_steps auto): warm run, best of 3,
     recall@10 >= 0.93; then ef=96 (beam capacity 128) and one call with
     4 entry seeds, a one-hop rerank of 8 and the bit-reversed tie order;
     the mini kernel launched at both capacities and the plain version
     never called; then recall@10 at ef=32 and 64 with the 1024-point and
     the 65,536-point entry sample (the JAX package's own 2M run's);
  8. mini kernel against the plain version at the slice shapes: every
     query at ef=32 and ef=96, and with 4 seeds and tie_bits; both timed,
     its resident warps, both byte counts of its bound (whole rows, and
     ids first, the read it does), the ef sweep (32 to 128 at 32 steps),
     and the exact rerank kernel held to its plain version on every
     query, both timed apart beside its bound;
  9. the device build, with the mini index freed: make_dataset(0,
     build_n, nq) and HNSWBuilder.extend_batched at the JAX bench's options
     (efc=96, m=24, M=64, batch_size 256, a 50k native host warmup, then
     device chunks with the 1024-point sampled entry and scan_group 8):
     host and device seconds apart, CUDA-event totals per build phase
     (entry, search, select, apply), level sizes (equal to the JAX
     package's at 1M and 100k), edge drops, and the gather and Hamming
     block kernels launched with their plain versions never called;
 10. the build kernels against their plain versions at the build's
     shapes: one chunk of 4096 searches at ef=96 over the finished base
     layer (keys/visited/steps equal; its resident warps, the ef sweep),
     then the [4096, 96, 96] select blocks of those beams; both timed,
     with the pairwise_mxu route beside the block kernel; and the sampled
     entry kernel against its plain version at the 1M cell's shape
     (10,000 queries, a 1024-point sample), one launch, timed with its
     bound beside the plain chain and pairwise_mxu + argmin;
 11. the device-built index served on the fused path: oracle, fused
     table, knns at k=10, ef=32, max_steps auto; best of 3,
     recall@10 >= 0.93, the fused kernel's launches in those calls (the
     plain version never called); then the kernel against its plain
     version on every query at those shapes, both timed, with the bound;
 12. the JAX CLI's query command at its defaults, on build_n points (the
     data of phase 9): HNSWBuilder.extend_batched at efc=96, m=24, M=256,
     the other IndexOptions at their defaults (a 50k native warmup,
     16384-row chunks), every search on the general beam search (rows 256
     wide: kernel #6 is never launched) and the select and prune blocks
     on the Hamming block kernel; host and device seconds apart, CUDA-event
     build phases, level sizes, edge drops, the kernels' launches and plain
     calls; then enable_inline() and knns at k=10, ef=96 with no entry
     sample (the greedy descent, then the general base search): warm run,
     best of 3, recall@10 >= 0.93, visited and steps per query, the route,
     the descent and the base search timed apart, and the same call on
     CPU copies of the index for 256 queries, dists/ids/visited/steps
     equal;
 13. the greedy descent (query_entry_sample 0) on the M=64 indexes: on the
     100k index of phase 5 (run before it is freed) and the 1M index of
     phase 11, knns at k=10, ef=32: recall@10 >= 0.93, the gather kernel
     launched for the descent and the fused kernel for the base, neither
     plain version called; every level's descent launch against its plain
     version, the entries equal to greedy_search's, the descent and the
     base kernel timed apart; then a 100k NSW at M=64 built on the card
     and served through the general route and the fused path, recall@10
     >= 0.93 on both.

 14. the CLI on the card, on phase 12's index saved to .npz (then
     freed): ``python -m hnsw_itu_tpu_torch.cli inspect`` as a subprocess
     (rc 0, every layer's degree percentiles, the host-BFS connectivity
     line); load_index on the card and the CLI's query_points at k=10,
     ef=96: ids and dists equal to phase 12's knns, then its sort and pad
     and recall@10 >= 0.93; -S (the native host engine, one thread) on
     1000 queries, recall@10 >= 0.93, timed. The card machine has no
     h5py: the HDF5 subcommands run in the CPU tests;
 15. the BFS reorder: a from_numpy copy of phase 11's 1M index reordered
     and served on its own fused table (k=10, ef=32, sampled entry): ids
     in the original space, recall@10 >= 0.93, tie-tolerant recall within
     0.005 of the unreordered index's, the fused kernel launched and its
     plain version never called, then held against it on every query;
     and a copy of phase 7's mini index reordered (its own mini table;
     tie_bits auto = the capacity's bits): knns recall@10 at ef=32, the
     mini kernel against its plain version on every query at those tie
     bits; each timed beside the unreordered index;
 16. the other metrics: l2 on L2_N float32 points of L2_DIM dimensions
     (make_l2_dataset), built on the card at the bench's options (no
     native warmup; every search on the general beam search, neither
     Hamming kernel launched), the oracle Bruteforce("l2") on the card,
     knns at k=10, ef=96 through the greedy descent: recall@10 >= 0.93,
     the device busy share of one batch, and the same call on CPU copies
     for 256 queries (dists within rtol 1e-5, ids equal where untied);
     l2int: the point3d example on the card, its golden distances;
 17. sharding (``hnsw_itu_tpu_torch.parallel``) on a mesh that names the
     one card ``shards`` times: (c), on phase 11's 1M index before it is
     freed, knns_query_sharded at k=10, ef=32 with the sampled entry and
     with the greedy descent (#6), dists and ids equal to the index's
     single-device general route on every query, both timed; (b) a
     4 x 50,000-point sharded build equal, shard by shard, to 1-shard
     builds of the same rows; (a), with everything earlier freed,
     ShardedHNSW.build of make_dataset(0, shards x shard_n, nq) (four of
     the JAX 10M flagship's 632,512-point shards: efc=96, m=24, M=64,
     4096-row chunks, each shard entered at its row 0) on #6 and #7, its
     seconds, ns and edge drops; the oracle; enable_inline() with one
     fused table a shard; knns at k=10 with the per-shard 1024-point
     sampled entry at ef 32 to 128, best of 3, #1 launched once a shard a
     call and its plain version never called; the headline is the smallest
     ef with recall@10 >= 0.93 (the phase fails without one); at it every
     shard's #1 against its plain version on every query, timed with its
     bound, the entry, the merge against a numpy two-key merge, and one
     call's device time by kernel; then the general route on 1000 queries;
 18. the JAX 10M runner's configuration (benches/run_10m.py), with
     everything earlier freed: make_dataset(0, flagship_n, nq) (10,120,192
     points, results_10m.json's n) built on the card at the runner's
     options (efc=96, m=24, M=64, batch_size 1024: 16,384-row chunks after
     a 50k native warmup), its level sizes equal to the JAX builder's
     draw, #6 and #7 launched and their plain versions never called, both
     held to their plain versions at one build chunk, and the sampled
     entry kernel held to its plain version at 8192 queries against
     samples of 1024 and 65,536; the oracle on the
     card; the runner's attribution (the general route, ef=64, 2048
     queries, entry samples 1024 and 65,536, dedup by beam); the mini
     table the policy picks from the card's free memory (its W, mini_words,
     bytes, seconds and the card's memory share), the runner's five plan
     points and the JAX record's point (ef 64, hop 8, es 65,536) at k=10
     over every query in batches of 8192, best of 3, each with recall@10,
     tie-tolerant recall, launches (plain calls 0) and the entry, mini
     kernel (with its bound) and the rerank kernel (held to its plain
     version on every query, with its bound and the plain version's time)
     timed apart; recall@10 >= 0.93 at
     the best point, where the mini kernel is held to its plain version on
     every query; then, the policy's table freed, the table of the JAX
     package's default budget (1.1e10 bytes: W=32, mini_words=7) at the
     JAX record's point, held the same way.
 19. (``--cards 4`` only) the sharded paths on four cards, each card's
     work in its long-lived worker process (``parallel/mesh.py``
     ``CardPool``): (a) ShardedHNSW.build
     of 4 x shard_n points at phase 17's options on a mesh naming card 0
     four times and on the four cards, in the order one, four, four, one,
     each build equal shard by shard to the first, the host seconds, their
     ratio and the CUDA-event build spans per card; then knns at k=10,
     ef=32 on both meshes' fused tables, ids and dists equal, both timed;
     the four-card knns (on the workers) equal on every query to this
     process's loop over the same shards, both timed, with the pool's
     timings, each card's device ms and the busy share; (b)
     knns_query_sharded over phase 9's build_n-point device-built index on
     the four cards (one pool kept across the calls), with the sampled
     entry and the greedy descent, equal on every query to the same call
     on card 0 four times and to the index's general route, all three
     timed; (c) the JAX
     sharded runner's configuration (benches/run_sharded_10m.py):
     make_dataset(0, flagship_n, nq) in 16 shards of 632,512 as one
     ShardedHNSW over the four cards (four contiguous shards and 21.4 GB
     of fused tables a card), its build on #6 and #7 (spans per card; both
     held to their plain versions at one chunk of the last card), the
     oracle, knns at ef 32 to 128 against the 0.93 gate with #1 launched
     once a shard a call, every shard's #1 against its plain version at
     ef=32 on every query on its card, the per-card entry and #1 times,
     every ef's knns on the workers against this process's loop (every
     query; timed at ef=32, as in (a)), the merge against numpy, the
     memory the cards keep once the index is closed; (d) the runner's own
     recipe on the same
     data: 16 HNSWBuilder indexes (efc=96, m=24, M=64, batch_size 256, a
     20k native warmup), one worker process a card building and serving
     its four shards, the four cards at once, each shard served
     on its fused table (query batch 8192, 1024-point sampled entry,
     max_steps = ef) at ef 48 and 32, best of 2, ids shifted by the shard
     offset and merged by (distance, id): recall@10 beside the runner's
     record, build seconds per shard and per card, and the wall
     attributed to the uploads, the pool's start, each card's work, the
     pool's close and the merge.

In phases 5, 7, 11 and 17 every query batch whose step replays its CUDA
graph (``hnsw_itu_tpu_torch/models/step_graphs.py``) is held afterwards
to the eager step of the same batch under the settings it ran with
(dists, ids, visited and steps equal, else the phase raises), and the
phase logs its captures, replays and eager steps (``ReplayCheck``).

Every phase's seconds are logged (``phase seconds``).

The line before the last is the kernels' JSON record (with ``--cards 4``
that of #1, #6 and #7 on phase 19's path); the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits nonzero
without that line; so does a machine without CUDA, and a directory
without the package.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
K, EF, MAX_STEPS, SAMPLE = 10, 32, 32, 1024
RECALL_GATE = 0.93  # bench.py's gate
KERNEL_SRC = "hnsw_itu_tpu_torch/csrc/fused_beam_search.cu"
KERNEL_REPLACES = "hnsw_itu_tpu/ops/pallas_search.py:267"
MINI_SRC = "hnsw_itu_tpu_torch/csrc/mini_beam_search.cu"
MINI_REPLACES = "hnsw_itu_tpu/ops/pallas_dma_search.py:680"
MINI_COVERS = ["hnsw_itu_tpu/ops/pallas_dma_search.py:875 (#4, beam half 128)",
               "hnsw_itu_tpu/ops/pallas_dma_search.py:534 (#5, unpacked)"]
PAIRS = [(16, 24), (32, 64), (64, 48), (32, 32), (32, 16), (64, 96),
         (32, 128)]
MINI_CASES = [(64, 48, 3), (64, 96, 7), (32, 32, 3), (32, 48, 31),
              (32, 64, 31), (64, 128, 7), (32, 96, 7)]
MINI_CAP = 2_200_000  # index rows of the mini phase, at least
MINI_EFS = (32, 96)  # beam capacity 64 and 128
DMA_SRC = "hnsw_itu_tpu_torch/csrc/dma_beam_search.cu"
DMA_REPLACES = "hnsw_itu_tpu/ops/pallas_dma_search.py:355"
HAM_SRC = "hnsw_itu_tpu_torch/csrc/hamming_block.cu"
HAM_REPLACES = "hnsw_itu_tpu/ops/pallas_hamming.py:26"
ENTRY_SRC = "hnsw_itu_tpu_torch/csrc/sampled_entry.cu"
# no TPU kernel: the JAX sampled entry is XLA code
ENTRY_REPLACES = "hnsw_itu_tpu/ops/entry.py sampled_entry (XLA, no kernel)"
# the JAX bench's build (bench.py:180-188), IndexOptions defaults spelled out
BUILD_N = 1_000_000
BUILD_OPTS = dict(ef_construction=96, connections=24, max_connections=64,
                  batch_size=256, host_warmup=50_000, entry_sample=1024,
                  scan_group=8)
# level sizes the JAX package's builder draws at these options: they depend
# on the RNG alone, not on the data (BENCH_r05.json, its 1M and 100k legs)
JAX_LEVEL_NS = {1_000_000: [41230, 1695, 78, 1], 100_000: [4183, 169, 10, 1],
                # phase 18, at the 10M runner's options (FLAGSHIP_OPTS):
                # the JAX builder's _random_level stream at its seed
                # (tests/test_torch_flagship.py)
                10_120_192: [420726, 17766, 729, 26]}
# the JAX CLI's query command (hnsw_itu_tpu/cli.py:287-292, 446-449): efc,
# m and M from its flags, every other IndexOptions field at its default
CLI_OPTS = dict(ef_construction=96, connections=24, max_connections=256,
                host_warmup=50_000)
CLI_EF = 96  # the CLI's -e default
PARITY_Q = 256  # queries of the CUDA-vs-CPU check of the general route
NSW_N = 100_000  # points of the NSW phase
# phase 16's l2 cell: the width of the SISAP 2023 LAION clip768 embeddings
# that the sketches binarize, at one of that task's sizes (100K)
L2_N, L2_DIM = 100_000, 768
# the JAX package's own 2M mini-path run used this entry sample
# (benches/results_2m.json: recall@10 0.9703 at ef=32, 0.9833 at ef=64)
MINI_WIDE_SAMPLE = 65_536
# (gather-kernel case) W, ef, seeds, node map, repeated ids
GATHER_CASES = [(32, 24, 1, False, False), (64, 48, 1, False, False),
                (64, 96, 1, False, False), (32, 128, 1, False, False),
                (64, 1, 1, True, False), (32, 24, 4, False, False),
                (64, 96, 4, True, False), (64, 48, 1, True, True),
                (32, 128, 4, True, True), (64, 96, 1, False, True)]
# [M, N, words] or [P, M, N, words]: a prune block of the M=256 build
# (prune_budget rows of 256 neighbors plus the spill width); blocks of 95
# and 97 rows and columns (not multiples of 16 or 8); words 1, 31, 33 and
# 64; a 2-D block wider than one tile in both directions
HAM_SHAPES = [(7, 129, 32), (96, 96, 32), (130, 33, 5), (3, 72, 72, 32),
              (17, 96, 96, 32), (5, 31, 65, 7), (256, 264, 264, 32),
              (4, 95, 97, 1), (4, 97, 95, 31), (3, 96, 96, 33),
              (64, 200, 64), (1000, 4100, 32)]
# [P, C, words] blocks of x against itself (hamming_block(x, x), as the
# build calls it): C = 95, 97, 96 and 264, words 64, and P past 65,535
HAM_SELF_SHAPES = [(16, 96, 96, 32), (6, 95, 95, 32), (6, 97, 97, 32),
                   (4, 264, 264, 32), (2, 264, 264, 64), (70_000, 12, 12, 32)]
# the ef sweep of the redesigned kernels, at a fixed expansion bound: a
# flat time says read latency bounds them, a rising one that their
# per-step loops still cost
SWEEP_EFS, SWEEP_STEPS = (32, 64, 96, 128), 32
# phase 17: index sharding at one of the JAX 10M flagship's shards
# (benches/run_sharded_10m.py: 10,120,192 points in 16 shards of 632,512,
# each below the fused kernel's 2^21 ids); four of them fill one card
SHARDS, SHARD_N = 4, 632_512
# the JAX bench's and the 10M runner's shard options; batch_size caps the
# sharded schedule's chunks (the single-card build's steady 4096 rows)
SHARD_OPTS = dict(ef_construction=96, connections=24, max_connections=64,
                  batch_size=4096, host_warmup=0)
SHARD_EFS = (32, 48, 64, 96, 128)
INDEP_N = 50_000  # rows a shard of the shard-independence check
GENERAL_Q = 1000  # queries of the sharded general route
# phase 18: the JAX 10M runner's configuration (benches/run_10m.py; its
# record benches/results_10m.json: 10,120,192 points, 10k queries, k=10)
FLAGSHIP_N = 10_120_192
# run_10m.py:83,96-98: batch_size 1024 past 4M points (16,384-row chunks);
# every other IndexOptions field at its default, spelled out
FLAGSHIP_OPTS = dict(ef_construction=96, connections=24, max_connections=64,
                     batch_size=1024, host_warmup=50_000, entry_sample=1024,
                     scan_group=8)
FLAGSHIP_QUERY_BATCH = 8192  # run_10m.py:245
FLAGSHIP_GT_Q = 2048  # queries of the runner's attribution (run_10m.py:225)
# the runner's plan past 4M points (run_10m.py:266-268): (ef, hop, entry
# sample, max_steps; None: max(2 ef, 64))
FLAGSHIP_PLAN = [(64, 0, 1024, None), (64, 8, 8192, 256), (96, 8, 8192, 256),
                 (96, 8, 1024, None), (128, 8, 1024, None)]
# the JAX record's point (results_10m.json: mini(mw=7)+hop8, recall@10
# 0.931 at ef=64 with a 65,536-point entry sample)
FLAGSHIP_JAX_POINT = (64, 8, 65_536, None)
# the JAX package's table budget, HNSW_TPU_INLINE_QUERY_BYTES's default
# (hnsw_itu_tpu/models/nsw.py:161-174): (W=32, mini_words=7) at 10M
JAX_TABLE_BUDGET = int(1.1e10)
# phase 19 (--cards 4): the JAX sharded runner (benches/run_sharded_10m.py,
# its record benches/results_sharded_10m.json) over four cards: its
# 10,120,192 points in 16 shards of 632,512, four contiguous shards a card
CARDS = 4
RUNNER_SHARDS = 16
FLAGSHIP_CARD_EFS = (32, 48, 64, 128)  # 19c's sweep of the ShardedHNSW
# 19d: the runner's own recipe, each shard a full HNSWBuilder index
# (run_sharded_10m.py:117-119), served at its query settings (:151-154)
RUNNER_OPTS = dict(ef_construction=96, connections=24, max_connections=64,
                   batch_size=256, host_warmup=20_000)
RUNNER_EFS = (48, 32)
RUNNER_QUERY_BATCH = 8192
# recall@10 of the record at each ef, measured on a TPU (a reference for
# recall, not for time)
RUNNER_JAX_RECALL = {48: 0.9995, 32: 0.9994}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
# the H100 SXM's dense int8 tensor-core rate (NVIDIA's data sheet): kernel
# #7's bit products, 2 operations each, counted at it
INT8_OPS_PER_S = 1.979e15
# __popc: 16 results per clock per SM at compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput), 132 SMs at the
# H100 SXM's 1.98 GHz boost clock: the ceiling of #7's earlier one-__popc-
# a-word-pair design, kept on record as popc_ms
POPC_PER_S = 16 * 132 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_cards() -> None:
    """Wait for every visible card: ``torch.cuda.synchronize()`` alone
    waits for the current one only, and a sharded call runs on all."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed(fn):
    """(host-clock ms of one ``fn()`` after a warm one, every card
    synchronized around it, its result)."""
    fn()
    sync_cards()
    t0 = time.perf_counter()
    res = fn()
    sync_cards()
    return (time.perf_counter() - t0) * 1e3, res


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


class ReplayCheck:
    """Phase ``tag``'s query steps: the step graphs' counters
    (``StepGraphs.captures``, ``.replays``, ``.eager_steps``), and every
    step that replayed a graph held, when the phase ends, to the eager
    step of the same batch under the settings it ran with: dists, ids,
    visited and steps equal (raises otherwise, and where ``replays`` asks
    for replays and none ran). The eager steps run with ``timings`` on,
    which no graph serves; their counts are taken back, so the phase's
    launch counts stay its own."""

    SETTINGS = ("query_entry_sample", "query_entry_beams", "query_hop",
                "query_tie", "max_steps")

    def __init__(self, tag, replays=True):
        self.tag, self.want_replays = tag, replays

    def __enter__(self):
        from hnsw_itu_tpu_torch.models.nsw import QueryIndex
        from hnsw_itu_tpu_torch.models.step_graphs import StepGraphs

        self.counters = lambda: (StepGraphs.captures, StepGraphs.replays,
                                 StepGraphs.eager_steps)
        self.before, self.replayed = self.counters(), []
        self.step = QueryIndex._step
        check = self

        def step(index, q, k, ef, route):
            n = StepGraphs.replays
            out = check.step(index, q, k, ef, route)
            if StepGraphs.replays != n:
                check.replayed.append((
                    index, q.clone(), k, ef, route,
                    {a: getattr(index, a) for a in check.SETTINGS}, out))
            return out

        QueryIndex._step = step
        return self

    def __exit__(self, kind, *exc):
        from hnsw_itu_tpu_torch.models.nsw import QueryIndex

        QueryIndex._step = self.step
        if kind is None:
            self.verify()
        return False

    def _eager(self, index, q, k, ef, route, settings):
        from hnsw_itu_tpu_torch.models.step_graphs import (STEP_COUNTERS,
                                                           StepGraphs,
                                                           taken_back)

        now = {a: getattr(index, a) for a in self.SETTINGS}
        timings = index.timings
        try:
            for a, v in settings.items():
                setattr(index, a, v)
            index.timings = {}
            with taken_back(STEP_COUNTERS + ((StepGraphs, "eager_steps"),)):
                return self.step(index, q, k, ef, route)
        finally:
            for a, v in now.items():
                setattr(index, a, v)
            index.timings = timings

    def verify(self):
        captures, replays, eager = (a - b for a, b in zip(self.counters(),
                                                           self.before))
        diff = dict.fromkeys(("dists", "ids", "visited", "steps"), 0)
        for index, q, k, ef, route, settings, got in self.replayed:
            want = self._eager(index, q, k, ef, route, settings)
            for name, g, w in zip(diff, got, want):
                diff[name] += int((g != w).sum()) if g.shape == w.shape \
                    else g.numel()
        self.record = {"captures": captures, "replays": replays,
                       "eager_steps": eager, "checked": len(self.replayed),
                       "differing": diff}
        log(f"[{self.tag}] step graphs: {captures} captures, {replays} "
            f"replays, {eager} eager steps; {len(self.replayed)} replayed "
            "steps held to the eager step of the same batch: "
            + ", ".join(f"{v} {k}" for k, v in diff.items())
            + " differing")
        if any(diff.values()) or (self.want_replays and not self.replayed):
            raise AssertionError(f"[{self.tag}] step graph replays: "
                                 f"{self.record}")


def device_breakdown(fn, calls: int = 3, top: int = 6):
    """Device time of one ``fn()`` by kernel, from torch.profiler over
    ``calls`` runs after a warm one: (total ms, [(kernel, ms), ...])."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        if "CUDA" in str(e.device_type):  # kernels, not the ops launching them
            us[e.key] = us.get(e.key, 0.0) + e.self_device_time_total
    ranked = sorted(us.items(), key=lambda kv: -kv[1])[:top]
    return (sum(us.values()) / calls / 1e3,
            [(k, v / calls / 1e3) for k, v in ranked])


def bound_ms(nbytes: int) -> float:
    """Least time for ``nbytes`` of device-memory traffic at HBM's rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def rerank_bytes(points, adj, qs, beam, *, k, seeds):
    """Bytes the exact rerank needs (csrc/exact_rerank.cu), two counts:
    by shape (each query, every slot's id and row, the seeds' whole
    adjacency rows and every entry's row, the answer's (d, id) pairs out)
    and the least (each input byte once: the queries, the ids, the
    distinct adjacency rows of valid seeds and the distinct rows of valid
    ids among the beams and those rows, the answer out)."""
    import torch

    from hnsw_itu_tpu_torch.ops.mini_search import (IINF,
                                                    rerank_exact_plain)

    (B, H), (cap, words) = beam.shape, points.shape
    row = words * 4
    S = min(seeds, H)
    W = adj.shape[1] if S else 0
    kout = min(k, H + S * W) if S else min(k, H)
    shape = B * (row + H * (4 + row) + S * W * (4 + row) + kout * 8)
    ids = beam.reshape(-1)
    least = B * (row + H * 4 + kout * 8)
    if S:
        sid = rerank_exact_plain(points, qs, beam, k=H)[1][:, :S]
        sid = torch.unique(sid[sid < IINF])
        least += sid.numel() * W * 4
        ids = torch.cat([ids, adj[sid.long()].reshape(-1)])
    ids = torch.unique(ids[(ids >= 0) & (ids < cap)])
    return shape, least + ids.numel() * row


def rerank_vs_plain(points, adj, qs, beam, *, k, seeds, smi, tag):
    """The mini route's rerank at these shapes (``rerank_onehop`` with
    ``seeds``, else ``rerank_exact``): its kernel against its plain
    version, bit-exact on every query (raises otherwise), one kernel
    launch and no plain call; then both timed by CUDA events beside the
    kernel's bound. Returns {"ms", "plain_ms", "bound_ms"}."""
    from hnsw_itu_tpu_torch.ops.mini_search import (rerank_exact,
                                                    rerank_exact_plain,
                                                    rerank_onehop,
                                                    rerank_onehop_plain)

    if seeds:
        fn = rerank_onehop

        def kernel():
            return rerank_onehop(points, adj, qs, beam, k=k, seeds=seeds)

        def plain():
            return rerank_onehop_plain(points, adj, qs, beam, k=k,
                                       seeds=seeds)
    else:
        fn = rerank_exact

        def kernel():
            return rerank_exact(points, qs, beam, k=k)

        def plain():
            return rerank_exact_plain(points, qs, beam, k=k)

    before = (fn.kernel_launches, fn.plain_calls)
    got, want = kernel(), plain()
    if (fn.kernel_launches, fn.plain_calls) != (before[0] + 1, before[1]):
        raise AssertionError(f"[{tag}] rerank kernel not launched once")
    if [g.shape for g in got] != [w.shape for w in want] \
            or max_abs_diff(got, want):
        raise AssertionError(f"[{tag}] rerank kernel != plain version")
    B, H = beam.shape
    shape, least = rerank_bytes(points, adj, qs, beam, k=k, seeds=seeds)
    out = {"ms": cuda_ms(kernel, 10), "plain_ms": cuda_ms(plain, 3),
           "bound_ms": bound_ms(least), "bound_by_shape_ms": bound_ms(shape)}
    log(f"[{tag}] on {smi}: {fn.__name__} of {B} beams of {H} (seeds "
        f"{seeds}, k {k}): kernel equal to the plain version on every "
        f"query; kernel {out['ms']:.3f} ms, bound {out['bound_ms']:.3f} ms "
        f"({least / 1e9:.3f} GB, each input byte once; by shape "
        f"{shape / 1e9:.3f} GB = {out['bound_by_shape_ms']:.3f} ms), plain "
        f"version {out['plain_ms']:.3f} ms")
    return out


def phase_card():
    import torch

    from hnsw_itu_tpu_torch.ops import _kernels

    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    for line in cards:
        log(line)  # each card's name and power limit, as nvidia-smi gives them
    smi = cards[0]
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _kernels.build_kernels(rebuild=True)
    log(f"[1] built {len(_kernels.KERNELS)} kernels in parallel in "
        f"{time.perf_counter() - t0:.1f} s, nvcc "
        f"{' '.join(_kernels.NVCC_FLAGS)}")
    for name in _kernels.KERNELS:
        info = _kernels.BUILD_INFO[name]
        log(f"[1] built hnsw_itu_tpu_torch/csrc/{name}.cu in "
            f"{info['seconds']:.1f} s -> "
            f"{os.path.relpath(info['path'], HERE)}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[1]   ptxas: {line.strip()}")
    for name, shapes in (("fused_beam_search", ((32, 64), (128, 64),
                                                (32, 128))),
                         ("dma_beam_search", ((1, 24), (96, 24), (96, 64))),
                         ("mini_beam_search", ((32, 64), (96, 64)))):
        log(f"[1] {name}: resident warps per SM (occupancy calculator) at "
            + ", ".join(f"ef={ef} W={w}: "
                        f"{_kernels.resident_warps(name, ef, w)}"
                        for ef, w in shapes))
    return smi


def phase_small_graphs(dev) -> int:
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.ops.fused_search import (fused_beam_search,
                                                     key_clamp,
                                                     materialize_fused)
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches, popcount_sum
    from hnsw_itu_tpu_torch.ops.search import beam_search_packed
    from hnsw_itu_tpu_torch.testing import random_graph

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
    """make_dataset + the native host build of ``n`` points."""
    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
    from hnsw_itu_tpu_torch.utils import make_dataset

    t0 = time.perf_counter()
    pts, qs = make_dataset(0, n, nq)
    log(f"[3] make_dataset(0, {n}, {nq}): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    b = HNSWBuilder(IndexOptions(ef_construction=96, connections=24,
                                 max_connections=64, size=n,
                                 batch_size=256, host_warmup=n), device=dev)
    b.extend_batched(pts)
    index = b.build()
    log(f"[3] host build (native engine) of {n} points + upload: "
        f"{time.perf_counter() - t0:.1f} s, levels {index.level_ns}, ep "
        f"{index.ep}")
    return pts, qs, index


def phase_oracle(pts, qs, dev, tag="4", with_dists=False):
    """Exact k=10 ground truth on the card: ids, and with ``with_dists``
    (ids, dists)."""
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
    log(f"[{tag}] oracle on the card: {time.perf_counter() - t0:.2f} s "
        f"for {len(qs)} x {len(pts)}")
    d_host, _ = native.host_bruteforce(pts, "hamming", qs[:256], K)
    if not np.array_equal(gt_d[:256], d_host):
        raise AssertionError("oracle distances != native host scan")
    log(f"[{tag}] oracle distances equal the native host scan on 256 "
        "queries")
    return (gt_i, gt_d) if with_dists else gt_i


def phase_query(index, qs, gt_i, dev):
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.ops.entry import sampled_entry
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
    sampled_entry.kernel_launches = sampled_entry.plain_calls = 0
    index.knns(q, K, EF)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        res = index.knns(q, K, EF)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    entry = entry_main_path("5", 4, -(-nq // index.query_batch))
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
    return best, entry


def fused_at_served_shapes(index, qs, dev, smi, *, max_steps, tag,
                           sweep=False, ef=EF):
    """The fused kernel against its plain version on every query at beam
    width ``ef``, with the init keys knns makes (sampled entry, queries
    sorted by entry distance): keys/visited/steps equal; both timed, the
    bytes the search must move and their bound, the resident warps; with
    ``sweep`` also the ef sweep at SWEEP_STEPS expansions. ``index`` needs
    ``fused``, ``points``, ``n`` and ``metric``."""
    import torch

    from hnsw_itu_tpu_torch.models.nsw import _id_bits
    from hnsw_itu_tpu_torch.ops import _kernels
    from hnsw_itu_tpu_torch.ops.entry import sampled_entry
    from hnsw_itu_tpu_torch.ops.fused_search import (fused_beam_search,
                                                     key_clamp)
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches, popcount_sum
    from hnsw_itu_tpu_torch.ops.search import beam_search_packed

    table = index.fused
    q = as_sketches(qs, dev)
    B, words = q.shape
    id_bits = _id_bits(table.cap)
    max_d = key_clamp(id_bits, words * 32)

    def entry():
        return sampled_entry(index.points, q, index.n, sample_size=SAMPLE,
                             metric=index.metric)

    eps = entry()
    d0 = popcount_sum(index.points[eps.long()] ^ q)
    order = torch.argsort(d0, stable=True)
    qs_o = q[order].contiguous()
    init = ((d0[order].clamp(max=max_d) << id_bits) | eps[order]).contiguous()

    def check(ef, steps):
        """(max |diff|, kernel ms, plain ms, bytes, plain stats, (steps/q,
        visited/q)); raises where the kernel and the plain version differ"""
        kw = dict(ef=ef, id_bits=id_bits, max_d=max_d, max_steps=steps)
        got = fused_beam_search(table, qs_o, init, **kw)
        st = {}
        want = beam_search_packed(table.ids, table.data, qs_o, init,
                                  stats=st, **kw)
        torch.cuda.synchronize()
        err = max_abs_diff(got, want)
        if err:
            raise AssertionError(f"fused kernel != plain at N={index.n}, "
                                 f"ef={ef}, max_steps={steps}")
        k_ms = cuda_ms(lambda: fused_beam_search(table, qs_o, init, **kw), 10)
        p_ms = cuda_ms(lambda: beam_search_packed(
            table.ids, table.data, qs_o, init, **kw), 2)
        # bytes the search must move: each expansion's W ids and each valid
        # neighbor's sketch (the dedup key holds the distance, so every one
        # is read), the queries and entry keys in, keys and counts out
        nbytes = (st["rows"] * table.width * 4 + st["edges"] * words * 4
                  + B * (words + 1) * 4 + B * ef * 4 + B * 8)
        return err, k_ms, p_ms, nbytes, st, (
            float(got[2].float().mean()), float(got[1].float().mean()))

    err, k_ms, p_ms, nbytes, st, (steps_q, vis_q) = check(ef, max_steps)
    b_ms = bound_ms(nbytes)
    warps = _kernels.resident_warps("fused_beam_search", ef, table.width)
    log(f"[{tag}] {B} queries at N={index.n}, ef={ef}, max_steps "
        f"{max_steps}: kernel vs plain max |diff| {err} over keys, visited, "
        f"steps (steps/q {steps_q:.2f}, visited/q {vis_q:.1f})")
    log(f"[{tag}] on {smi}: fused kernel {k_ms:.3f} ms ({warps} resident "
        f"warps/SM), plain version {p_ms:.3f} ms, for {B} queries")
    log(f"[{tag}] the search reads {st['rows']} rows, {st['edges']} valid "
        f"edges: {nbytes / 1e9:.3f} GB, bound {b_ms:.3f} ms at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s")
    out = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": b_ms, "steps_q": steps_q, "visited_q": vis_q,
           "resident_warps": warps, "entry": entry}
    if sweep:
        out["sweep"] = []
        for ef in SWEEP_EFS:
            e, ms, _, nb, _, (sq, vq) = check(ef, SWEEP_STEPS)
            out["max_abs_err"] = max(out["max_abs_err"], e)
            out["sweep"].append({"ef": ef, "ms": ms, "bound_ms": bound_ms(nb),
                                 "steps_q": sq, "visited_q": vq})
            log(f"[{tag}] sweep ef={ef} max_steps={SWEEP_STEPS}: fused "
                f"kernel {ms:.3f} ms, steps/q {sq:.2f}, visited/q {vq:.1f}, "
                f"bound {bound_ms(nb):.3f} ms (kernel vs plain max |diff| "
                f"{e})")
    return out


def phase_slice_shapes(index, qs, dev, smi, knns_s):
    fused = fused_at_served_shapes(index, qs, dev, smi, max_steps=MAX_STEPS,
                                   tag="6", sweep=True)
    e_ms = cuda_ms(fused.pop("entry"), 10)
    log(f"[6] on {smi}: sampled entry {e_ms:.3f} ms, whole knns "
        f"{knns_s * 1e3:.3f} ms (host clock), for {len(qs)} queries")
    return fused


def mini_seeds(points, q, n, mw, beams, sample=SAMPLE):
    """Seeds of the mini path as HNSW.knns makes them: sampled entry (top
    ``beams`` of a ``sample``-point sample), prefix distances, queries
    sorted by the nearest seed."""
    import torch

    from hnsw_itu_tpu_torch.ops.entry import sampled_entry_topk
    from hnsw_itu_tpu_torch.ops.metrics import HAMMING, popcount_sum

    eps = sampled_entry_topk(points, q, n, sample_size=sample, beams=beams,
                             metric=HAMMING)[0]
    d0 = popcount_sum(points[eps.long(), :mw] ^ q[:, None, :mw])
    order = torch.argsort(d0.min(dim=1).values, stable=True)
    return q[order].contiguous(), d0[order], eps[order]


def mini_bytes(st, visited, B, W, mw, ef):
    """Bytes a mini search must move, two counts: each expansion's W ids,
    queries and seeds in, keys and counts out, and either every valid
    neighbor's prefix (a whole-row read) or each fresh neighbor's prefix
    only (the ids-first read the kernel does: its bound)."""
    io = B * mw * 4 + B * 8 + B * ef * 8 + B * 8
    fresh = int(visited.long().sum()) - B
    return (st["rows"] * W * 4 + st["edges"] * mw * 4 + io,
            mini_ids_first_bytes(st["rows"], fresh, B, W, mw, ef))


def mini_ids_first_bytes(rows, fresh, B, W, mw, ef):
    """The ids-first count of ``mini_bytes`` (the kernel's bound) from the
    search's row fetches (the sum of its steps) and fresh neighbors."""
    return rows * W * 4 + fresh * mw * 4 + B * mw * 4 + B * 8 + B * ef * 8 \
        + B * 8


def mini_vs_plain(table, q, d0, eps, *, ef, max_steps, tie_bits=0,
                  stats=None):
    """Kernel and plain version of the mini search on the same inputs:
    max |diff| over d, ids, visited and steps."""
    import torch

    from hnsw_itu_tpu_torch.ops.mini_search import (mini_beam_search,
                                                    mini_beam_search_plain)

    kw = dict(ef=ef, mini_words=table.shape[2] - 1, max_steps=max_steps,
              tie_bits=tie_bits)
    got = mini_beam_search(table, q, d0, eps, **kw)
    want = mini_beam_search_plain(table, q, d0, eps, stats=stats, **kw)
    torch.cuda.synchronize()
    return max_abs_diff(got, want), got


def phase_small_mini(dev) -> int:
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.ops.metrics import as_sketches, popcount_sum
    from hnsw_itu_tpu_torch.ops.mini_search import materialize_mini
    from hnsw_itu_tpu_torch.testing import random_graph

    worst = 0
    for w, ef, mw in MINI_CASES:
        for E, tie in ((1, 0), (4, 8), (8, 8)):
            cap, words, B = 256, 32, 32
            rng = np.random.default_rng(w + ef + mw + E)
            pts, adj = random_graph(rng, cap, w, words)
            qs = rng.integers(0, 2**32, size=(B, words), dtype=np.uint32)
            seeds = np.stack([rng.choice(cap, size=E, replace=False)
                              for _ in range(B)]).astype(np.int32)
            p, q = as_sketches(pts, dev), as_sketches(qs, dev)
            table = materialize_mini(p, torch.from_numpy(adj).to(dev),
                                     mini_words=mw)
            s = torch.from_numpy(seeds).to(dev)
            d0 = popcount_sum(p[s.long(), :mw] ^ q[:, None, :mw])
            err, got = mini_vs_plain(table, q, d0, s, ef=ef, max_steps=256,
                                     tie_bits=tie)
            worst = max(worst, err)
            log(f"[2] mini W={w} ef={ef} mw={mw} seeds={E} tie_bits={tie}: "
                f"kernel vs plain max |diff| {err} over d, ids, visited, "
                f"steps (visited/q {got[2].float().mean():.1f}, "
                f"steps/q {got[3].float().mean():.1f})")
            if err:
                raise AssertionError(f"mini kernel != plain at W={w} "
                                     f"ef={ef} mw={mw} E={E} tie={tie}")
    return worst


def gather_vs_plain(adj, points, node_map, q, d0, eps, *, ef, max_steps):
    """Gather kernel and its plain version on the same inputs: (max |diff|
    over keys, visited and steps, the kernel's outputs)."""
    import torch

    from hnsw_itu_tpu_torch.ops.dma_search import (dma_beam_search,
                                                   dma_beam_search_plain)

    args = (adj, points, node_map, q, d0, eps)
    got = dma_beam_search(*args, ef=ef, max_steps=max_steps)
    want = dma_beam_search_plain(*args, ef=ef, max_steps=max_steps)
    torch.cuda.synchronize()
    return max_abs_diff(got, want), got


def phase_small_build_kernels(dev):
    """Small random cases of the two build kernels against their plain
    versions: (gather max |diff|, Hamming block max |diff|)."""
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.ops.hamming import (hamming_block,
                                                hamming_block_plain)
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches, popcount_sum
    from hnsw_itu_tpu_torch.testing import random_graph

    worst6 = 0
    for w, ef, E, mapped, repeats in GATHER_CASES:
        cap, words, B = 256, 32, 32
        rng = np.random.default_rng(w + ef + 10 * E + 100 * mapped + repeats)
        pts, adj = random_graph(rng, cap, w, words)
        if repeats:
            adj[:, w // 2 :] = adj[:, : w // 2]
        nm = None
        if mapped:  # the graph's ids map into a point array twice as large
            nm_np = rng.permutation(2 * cap)[:cap].astype(np.int32)
            big = rng.integers(0, 2**32, size=(2 * cap, words),
                               dtype=np.uint32)
            big[nm_np] = pts
            pts, nm = big, torch.from_numpy(nm_np).to(dev)
        qs = rng.integers(0, 2**32, size=(B, words), dtype=np.uint32)
        seeds = np.stack([rng.choice(cap, size=E, replace=False)
                          for _ in range(B)]).astype(np.int32)
        p, q = as_sketches(pts, dev), as_sketches(qs, dev)
        s = torch.from_numpy(seeds).to(dev)
        rows = s.long() if nm is None else nm[s.long()].long()
        d0 = popcount_sum(p[rows] ^ q[:, None, :])
        if E == 1:
            s, d0 = s[:, 0], d0[:, 0]
        err, got = gather_vs_plain(torch.from_numpy(adj).to(dev), p, nm, q,
                                   d0, s, ef=ef, max_steps=256)
        worst6 = max(worst6, err)
        log(f"[2] gather W={w} ef={ef} seeds={E} node_map={mapped} "
            f"repeats={repeats}: kernel vs plain max |diff| {err} over keys, "
            f"visited, steps (visited/q {got[1].float().mean():.1f}, "
            f"steps/q {got[2].float().mean():.1f})")
        if err:
            raise AssertionError(f"gather kernel != plain at W={w} ef={ef} "
                                 f"E={E} mapped={mapped} repeats={repeats}")
    worst7 = 0
    for shape, self_block in ([(s, False) for s in HAM_SHAPES]
                              + [(s, True) for s in HAM_SELF_SHAPES]):
        rng = np.random.default_rng(sum(shape))
        *lead, m, n, words = shape
        a = as_sketches(rng.integers(0, 2**32, size=(*lead, m, words),
                                     dtype=np.uint32), dev)
        b = a if self_block else as_sketches(rng.integers(
            0, 2**32, size=(*lead, n, words), dtype=np.uint32), dev)
        err = max_abs_diff((hamming_block(a, b),),
                           (hamming_block_plain(a, b),))
        worst7 = max(worst7, err)
        log(f"[2] hamming block {tuple(shape)}"
            f"{' (a is b)' if self_block else ''}: kernel vs plain max "
            f"|diff| {err}")
        if err:
            raise AssertionError(f"hamming kernel != plain at {shape}")
    return worst6, worst7


def phase_small_edges(dev):
    """The beam kernels' edge cases and repeated-seed cases
    (hnsw_itu_tpu_torch/testing.py) against their plain versions through
    the wrappers: (fused, gather, mini max |diff|)."""
    import torch

    from hnsw_itu_tpu_torch.ops.fused_search import (FusedTable,
                                                     fused_beam_search,
                                                     key_clamp)
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches, popcount_sum
    from hnsw_itu_tpu_torch.ops.mini_search import materialize_mini
    from hnsw_itu_tpu_torch.ops.search import beam_search_packed
    from hnsw_itu_tpu_torch.testing import (FUSED_EDGES, GATHER_EDGES,
                                            MINI_EDGES, REPEATED_SEEDS,
                                            edge_inputs, fused_edge_inputs,
                                            repeated_seed_inputs)

    def fused(case, pts, ids, data, qs, eps, ef, id_bits, max_steps):
        p, q = as_sketches(pts, dev), as_sketches(qs, dev)
        table = FusedTable(ids=torch.from_numpy(ids).to(dev),
                           data=as_sketches(data, dev))
        e = torch.from_numpy(eps).to(dev)
        max_d = key_clamp(id_bits, q.shape[1] * 32)
        init = (popcount_sum(q ^ p[e.long()]).clamp(max=max_d)
                << id_bits) | e
        kw = dict(ef=ef, id_bits=id_bits, max_d=max_d, max_steps=max_steps)
        got = fused_beam_search(table, q, init, **kw)
        want = beam_search_packed(table.ids, table.data, q, init, **kw)
        torch.cuda.synchronize()
        err = max_abs_diff(got, want)
        log(f"[2] fused {case}: kernel vs plain max |diff| {err} (visited/q "
            f"{got[1].float().mean():.1f}, steps/q "
            f"{got[2].float().mean():.1f})")
        if err:
            raise AssertionError(f"fused kernel != plain at {case}")
        return err

    def gather(case, pts, adj, qs, seeds, ef):
        p, q = as_sketches(pts, dev), as_sketches(qs, dev)
        s = torch.from_numpy(seeds).to(dev)
        d0 = popcount_sum(p[s.long()] ^ q[:, None, :])
        err, got = gather_vs_plain(torch.from_numpy(adj).to(dev), p, None, q,
                                   d0, s, ef=ef, max_steps=256)
        log(f"[2] gather {case}: kernel vs plain max |diff| {err} "
            f"(visited/q {got[1].float().mean():.1f}, steps/q "
            f"{got[2].float().mean():.1f})")
        if err:
            raise AssertionError(f"gather kernel != plain at {case}")
        return err

    def mini(case, pts, adj, qs, seeds, w, ef, mw, tie):
        p, q = as_sketches(pts, dev), as_sketches(qs, dev)
        table = materialize_mini(p, torch.from_numpy(adj).to(dev),
                                 mini_words=mw)[:, :w].contiguous()
        s = torch.from_numpy(seeds).to(dev)
        d0 = popcount_sum(p[s.long(), :mw] ^ q[:, None, :mw])
        err, got = mini_vs_plain(table, q, d0, s, ef=ef, max_steps=256,
                                 tie_bits=tie)
        log(f"[2] mini {case} mw={mw} tie_bits={tie}: kernel vs plain max "
            f"|diff| {err} (visited/q {got[2].float().mean():.1f}, steps/q "
            f"{got[3].float().mean():.1f})")
        if err:
            raise AssertionError(f"mini kernel != plain at {case} tie={tie}")
        return err

    worst1 = worst6 = worst_mini = 0
    for kind, cap, w, ef, id_bits, steps in FUSED_EDGES:
        worst1 = max(worst1, fused(
            f"edge {kind} cap={cap} W={w} ef={ef} id_bits={id_bits} "
            f"max_steps={steps}", *fused_edge_inputs(kind, cap, w, id_bits),
            ef, id_bits, steps))
    for kind, cap, w, ef, E in GATHER_EDGES:
        worst6 = max(worst6, gather(
            f"edge {kind} cap={cap} W={w} ef={ef} seeds={E}",
            *edge_inputs(kind, cap, w, E), ef))
    for kind, cap, w, ef, E, mw, tie in MINI_EDGES:
        worst_mini = max(worst_mini, mini(
            f"edge {kind} cap={cap} W={w} ef={ef} seeds={E}",
            *edge_inputs(kind, cap, w, E, salt=mw), w, ef, mw, tie))
    for w, ef, E, distinct, tie in REPEATED_SEEDS:
        case = f"W={w} ef={ef}, {E} seeds over {distinct} ids"
        inputs = repeated_seed_inputs(w, E, distinct)
        worst6 = max(worst6, gather(case, *inputs, ef))
        worst_mini = max(worst_mini, mini(case, *inputs, w, ef, 7, tie))
    return worst1, worst6, worst_mini


def phase_mini_query(index, qs, gt_i, dev):
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.ops.entry import sampled_entry
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches
    from hnsw_itu_tpu_torch.ops.mini_search import mini_beam_search
    from hnsw_itu_tpu_torch.utils import recall_at_k

    nq = len(qs)
    index.query_entry_sample = SAMPLE
    index.max_steps = None  # the bench's rule past 200k: max(2 ef, 64)
    index.query_batch = max(10240, nq)
    t0 = time.perf_counter()
    index.enable_inline()
    torch.cuda.synchronize()
    if index.fused is not None or index.mini is None:
        raise AssertionError("the policy did not pick the mini table")
    W, mw = index.mini_W, index.mini_words
    log(f"[7] mini table picked by the policy: W={W}, mini_words={mw}, "
        f"{tuple(index.mini.shape)} int32 = "
        f"{index.mini.numel() * 4 / 1e9:.3f} GB, "
        f"built in {time.perf_counter() - t0:.2f} s")
    q = as_sketches(qs, dev)

    def run(ef):
        res = index.knns(q, K, ef)
        ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
        if ids.shape != (nq, K) or not ((ids >= 0) & (ids < index.n)).all() \
                or not (np.diff(dists, axis=1) >= 0).all():
            raise AssertionError(f"bad mini result at ef={ef}")
        return (recall_at_k(ids, gt_i, K), index.last_stats["visited"] / nq,
                index.last_stats["steps"] / nq)

    out = {}
    sampled_entry.kernel_launches = sampled_entry.plain_calls = 0
    for ef in MINI_EFS:
        before = mini_beam_search.kernel_launches
        index.knns(q, K, ef)
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            index.knns(q, K, ef)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        rec, vis, steps = run(ef)
        cap = 64 if ef <= 64 else 128
        out[ef] = {"knns_ms": best * 1e3, "recall": rec}
        log(f"[7] knns k={K} ef={ef} (beam capacity {cap}, max_steps "
            f"{index._steps_cap(ef)}): best of 3 {best * 1e3:.2f} ms for "
            f"{nq} queries = {nq / best:,.0f} QPS, recall@10 {rec:.4f}, "
            f"visited/q {vis:.1f}, steps/q {steps:.2f}, kernel launches at "
            f"capacity {cap}: {mini_beam_search.kernel_launches - before}")
        if mini_beam_search.kernel_launches == before:
            raise AssertionError(f"mini kernel not launched at ef={ef}")
        if ef == EF and rec < RECALL_GATE:
            raise AssertionError(f"recall@10 {rec:.4f} < {RECALL_GATE}")
    entry = entry_main_path("7", 5 * len(MINI_EFS),
                            -(-nq // index.query_batch))
    index.query_entry_beams, index.query_hop = 4, 8
    index.query_tie = "bitrev"
    rec, vis, steps = run(EF)
    log(f"[7] knns ef={EF} with 4 entry seeds, one-hop rerank of 8, "
        f"bit-reversed ties (tie_bits {index._tie_bits()}): recall@10 "
        f"{rec:.4f}, visited/q {vis:.1f}, steps/q {steps:.2f}")
    index.query_entry_beams, index.query_hop = 1, 0
    index.query_tie = "auto"
    # ROADMAP §3: the entry sample of the JAX package's own 2M mini run
    # beside the bench's
    out["samples"] = {}
    for sample in (SAMPLE, MINI_WIDE_SAMPLE):
        index.query_entry_sample = sample
        for ef in (32, 64):
            rec, vis, steps = run(ef)
            out["samples"][f"{sample}/{ef}"] = rec
            log(f"[7] knns ef={ef} with a {sample}-point entry sample: "
                f"recall@10 {rec:.4f}, visited/q {vis:.1f}, steps/q "
                f"{steps:.2f}")
    index.query_entry_sample = SAMPLE
    return out, entry


def phase_mini_slice_shapes(index, qs, dev, smi, knns_ms):
    import torch

    from hnsw_itu_tpu_torch.ops import _kernels
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches
    from hnsw_itu_tpu_torch.ops.mini_search import (mini_beam_search,
                                                    mini_beam_search_plain)

    table, W, mw = index.mini, index.mini_W, index.mini_words
    B = len(qs)
    q_all = as_sketches(qs, dev)
    total, top = device_breakdown(lambda: index.knns(q_all, K, EF))
    log(f"[8] knns ef={EF} on the device (torch.profiler, 3 calls): "
        f"{total:.3f} ms per call, {100 * total / knns_ms:.0f}% of the "
        f"{knns_ms:.3f} ms host-clock call")
    for name, ms in top:
        log(f"[8]   {ms:.3f} ms  {name[:100]}")
    qs_o, d0, eps = mini_seeds(index.points, q_all, index.n, mw, 1)

    def bounds(st, visited, ef):
        return mini_bytes(st, visited, B, W, mw, ef)

    out, worst = {}, 0
    for ef in MINI_EFS:
        steps = index._steps_cap(ef)
        st = {}
        err, got = mini_vs_plain(table, qs_o, d0, eps, ef=ef,
                                 max_steps=steps, stats=st)
        worst = max(worst, err)
        log(f"[8] {B} queries at N={index.n}, ef={ef}: kernel vs plain "
            f"max |diff| {err} over d, ids, visited, steps")
        if err:
            raise AssertionError(f"mini kernel != plain at ef={ef}")
        kw = dict(ef=ef, mini_words=mw, max_steps=steps)
        k_ms = cuda_ms(lambda: mini_beam_search(table, qs_o, d0, eps, **kw),
                       10)
        p_ms = cuda_ms(lambda: mini_beam_search_plain(table, qs_o, d0, eps,
                                                      **kw), 2)
        whole, by_ids = bounds(st, got[2], ef)
        b_ms = bound_ms(by_ids)
        warps = _kernels.resident_warps("mini_beam_search", ef, W)
        out[ef] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                   "bound_whole_rows_ms": bound_ms(whole),
                   "bound_ids_first_ms": bound_ms(by_ids),
                   "resident_warps": warps}
        log(f"[8] on {smi}, ef={ef}: mini kernel {k_ms:.3f} ms ({warps} "
            f"resident warps/SM), plain version {p_ms:.3f} ms; the search "
            f"reads {st['rows']} rows ({st['rows'] / B:.2f}/q), "
            f"{st['edges']} valid edges ({st['edges'] / st['rows']:.1f}/row),"
            f" {int(got[2].long().sum()) - B} fresh: whole-row count "
            f"{whole / 1e9:.3f} GB = {bound_ms(whole):.3f} ms, ids-first "
            f"count {by_ids / 1e9:.3f} GB = {bound_ms(by_ids):.3f} ms at "
            f"{HBM_BYTES_PER_S / 1e12} TB/s; bound {b_ms:.3f} ms")
        if ef == EF:  # _query_step_mini's rerank_exact of this beam
            out["rerank"] = rerank_vs_plain(index.points, None, qs_o, got[1],
                                            k=K, seeds=0, smi=smi, tag="8")
    sweep = []
    for ef in SWEEP_EFS:
        st = {}
        err, got = mini_vs_plain(table, qs_o, d0, eps, ef=ef,
                                 max_steps=SWEEP_STEPS, stats=st)
        worst = max(worst, err)
        if err:
            raise AssertionError(f"mini kernel != plain in the sweep, ef={ef}")
        ms = cuda_ms(lambda ef=ef: mini_beam_search(
            table, qs_o, d0, eps, ef=ef, mini_words=mw,
            max_steps=SWEEP_STEPS), 10)
        b = bound_ms(bounds(st, got[2], ef)[1])
        sweep.append({"ef": ef, "ms": ms, "bound_ms": b,
                      "steps_q": float(got[3].float().mean()),
                      "visited_q": float(got[2].float().mean())})
        log(f"[8] sweep ef={ef} max_steps={SWEEP_STEPS}: mini kernel "
            f"{ms:.3f} ms, steps/q {sweep[-1]['steps_q']:.2f}, visited/q "
            f"{sweep[-1]['visited_q']:.1f}, bound {b:.3f} ms "
            f"(kernel vs plain max |diff| {err})")
    qs4, d4, eps4 = mini_seeds(index.points, q_all, index.n, mw, 4)
    index.query_tie = "bitrev"
    tie_bits = index._tie_bits()
    index.query_tie = "auto"
    err, _ = mini_vs_plain(table, qs4, d4, eps4, ef=EF,
                           max_steps=index._steps_cap(EF), tie_bits=tie_bits)
    worst = max(worst, err)
    log(f"[8] {B} queries, ef={EF}, 4 seeds, bit-reversed ties (tie_bits "
        f"{tie_bits}): kernel vs plain max |diff| {err}")
    if err:
        raise AssertionError("mini kernel != plain with 4 seeds and ties")
    # one seed at those tie bits: phase 15's reordered index against this
    # tells the tie order's cost from the relabel's
    kw = dict(ef=EF, mini_words=mw, max_steps=index._steps_cap(EF),
              tie_bits=tie_bits)
    err, _ = mini_vs_plain(table, qs_o, d0, eps, **{
        k: v for k, v in kw.items() if k != "mini_words"})
    worst = max(worst, err)
    out["tie_bits_ms"] = cuda_ms(lambda: mini_beam_search(
        table, qs_o, d0, eps, **kw), 10)
    log(f"[8] on {smi}: {B} queries, ef={EF}, one seed, tie_bits "
        f"{tie_bits}: mini kernel {out['tie_bits_ms']:.3f} ms (tie_bits 0: "
        f"{out[EF]['ms']:.3f} ms), kernel vs plain max |diff| {err}")
    if err:
        raise AssertionError("mini kernel != plain with bit-reversed ties")
    return worst, out, sweep


def phase_device_build(n, nq, dev, *, cap=None, tag="9", opts=BUILD_OPTS):
    """make_dataset + HNSWBuilder.extend_batched of ``n`` points into an
    index of ``cap`` rows (default ``n``) at ``opts`` (the bench's options
    by default): the native host warmup, then the device chunks (gather
    kernel, Hamming block kernel). Returns (pts, qs, index, record)."""
    import torch

    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.models import _build
    from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
    from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
    from hnsw_itu_tpu_torch.ops.hamming import hamming_block
    from hnsw_itu_tpu_torch.utils import make_dataset

    t0 = time.perf_counter()
    pts, qs = make_dataset(0, n, nq)
    log(f"[{tag}] make_dataset(0, {n}, {nq}): "
        f"{time.perf_counter() - t0:.1f} s")
    opts = IndexOptions(size=cap or n, **{**opts, "host_warmup": min(
        opts["host_warmup"], n)})
    b = HNSWBuilder(opts, device=dev)
    b.timings = {}
    warm_done = []

    def progress(off):
        if not warm_done:
            torch.cuda.synchronize()
            warm_done.append(time.perf_counter())

    # the build's own launches only
    dma_beam_search.kernel_launches = dma_beam_search.plain_calls = 0
    hamming_block.kernel_launches = hamming_block.plain_calls = 0
    t0 = time.perf_counter()
    b.extend_batched(pts, progress=progress)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    index = b.build()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rec = {"dma_launches": dma_beam_search.kernel_launches,
           "dma_plain": dma_beam_search.plain_calls,
           "ham_launches": hamming_block.kernel_launches,
           "ham_plain": hamming_block.plain_calls}
    host_s = warm_done[0] - t0
    dev_s = t1 - warm_done[0]
    rec.update(host_s=host_s, device_s=dev_s, finish_s=t2 - t1,
               level_ns=index.level_ns, edge_drops=b.total_edge_drops())
    log(f"[{tag}] build of {n} points, {opts}: host warmup (native engine, "
        f"{opts.host_warmup} points, + upload) {host_s:.1f} s, device "
        f"chunks {dev_s:.1f} s, build() (spill drain, level trim) "
        f"{t2 - t1:.2f} s; levels {index.level_ns}, ep {index.ep}, "
        f"total_edge_drops {b.total_edge_drops()}")
    spans = _build.span_ms(b.timings)
    rec["spans_ms"] = spans
    for name in ("entry", "search", "select", "apply"):
        k = len(b.timings.get(name, ()))
        ms = spans.get(name, 0.0)
        log(f"[{tag}]   {name:6s} {ms:10.1f} ms over {k} spans "
            f"({ms / max(1, k):.3f} ms each; CUDA events, device timeline "
            "incl. launch gaps)")
    log(f"[{tag}] gather kernel launches {rec['dma_launches']}, plain_calls "
        f"{rec['dma_plain']}; hamming block launches {rec['ham_launches']}, "
        f"plain_calls {rec['ham_plain']}")
    if min(rec["dma_launches"], rec["ham_launches"]) <= 0 or \
            rec["dma_plain"] or rec["ham_plain"]:
        raise AssertionError(f"device build did not run on the kernels: {rec}")
    want = JAX_LEVEL_NS.get(n)
    if want is not None:
        log(f"[{tag}] level_ns {index.level_ns} vs the JAX package's {want}: "
            f"{'equal' if index.level_ns == want else 'DIFFERENT'}")
        if index.level_ns != want:
            raise AssertionError("level sizes differ from the JAX package's")
    return pts, qs, index, rec


def mxu_block(a, b):
    """``Hamming.pairwise_mxu``'s route on [P, M, words] blocks: bit unpack,
    one exact float32 torch.matmul, popcount terms."""
    from hnsw_itu_tpu_torch.ops.metrics import (exact_fp32_matmul,
                                                popcount_sum, unpack_bits)

    with exact_fp32_matmul():
        dots = (unpack_bits(a) @ unpack_bits(b).transpose(-1, -2)).int()
    return popcount_sum(a)[..., :, None] + popcount_sum(b)[..., None, :] \
        - 2 * dots


def hamming_bound(a, b, out) -> dict:
    """Kernel #7's bound on ``hamming_block(a, b) -> out``: the larger of
    its bit products (M N words 32 a block, 2 operations each) at the
    int8 tensor-core rate and its bytes (each input read once, one input
    when ``a is b``, the int32 output written once) at HBM's rate; which
    of the two bounds it; and, as ``popc_ms``, the word popcounts at the
    __popc rate (the ceiling of the earlier __popc design)."""
    words = a.shape[-1]
    pairs = out.numel() * words  # word pairs, one popcount each
    ops_ms = 2 * pairs * 32 / INT8_OPS_PER_S * 1e3
    nbytes = (a.numel() + (0 if b is a else b.numel()) + out.numel()) * 4
    mem_ms = bound_ms(nbytes)
    return {"bound_ms": max(ops_ms, mem_ms),
            "bound_by": "operations" if ops_ms > mem_ms else "bytes",
            "ops_ms": ops_ms, "bytes_ms": mem_ms, "bytes": nbytes,
            "popc_ms": pairs / POPC_PER_S * 1e3}


def hamming_vs_plain(x, what, smi, tag):
    """Kernel #7 on the block ``x`` [P, C, words] against itself (as the
    build's select and prune blocks run it), held against its plain
    version and against ``Hamming.pairwise_mxu``'s route (max |diff| must
    be 0 for both), and timed beside both with its bound
    (``hamming_bound``); the ``pairwise_mxu`` route is its library
    call."""
    from hnsw_itu_tpu_torch.ops.hamming import (hamming_block,
                                                hamming_block_plain)

    got = hamming_block(x, x)
    err = max_abs_diff((got,), (hamming_block_plain(x, x),))
    log(f"[{tag}] hamming block {tuple(got.shape)} ({what}): kernel vs "
        f"plain max |diff| {err}")
    if err:
        raise AssertionError(f"hamming kernel != plain at {tuple(x.shape)}")
    if max_abs_diff((got,), (mxu_block(x, x),)):
        raise AssertionError(f"pairwise_mxu route != hamming block at "
                             f"{tuple(x.shape)}")
    k_ms = cuda_ms(lambda: hamming_block(x, x), 10)
    p_ms = cuda_ms(lambda: hamming_block_plain(x, x), 2)
    l_ms = cuda_ms(lambda: mxu_block(x, x), 5)
    bd = hamming_bound(x, x, got)
    log(f"[{tag}] on {smi}: hamming block {k_ms:.3f} ms, plain "
        f"{p_ms:.3f} ms, pairwise_mxu route (unpack + float32 "
        f"torch.matmul) {l_ms:.3f} ms; bit products {bd['ops_ms']:.4f} ms "
        f"at {INT8_OPS_PER_S:.3e} op/s, {bd['bytes'] / 1e9:.4f} GB = "
        f"{bd['bytes_ms']:.4f} ms: bound {bd['bound_ms']:.4f} ms by "
        f"{bd['bound_by']} ({bd['bound_ms'] / k_ms:.0%} of it); the __popc "
        f"ceiling {bd['popc_ms']:.4f} ms")
    return {"shape": list(got.shape), "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"], "library_ms": l_ms,
            "popc_ms": bd["popc_ms"]}


def entry_bound(B, S, words) -> dict:
    """The sampled entry kernel's bound (csrc/sampled_entry.cu) on B
    queries against an S-point sample: the larger of its bit products
    (B S words 32 bit pairs, 2 operations each, at the int8 tensor-core
    rate, as #7's ``hamming_bound`` counts them) and its bytes (the
    queries and the sample rows read once, the int32 ids written); its
    m16n8k256 products."""
    ops_ms = 2 * B * S * words * 32 / INT8_OPS_PER_S * 1e3
    nbytes = (B + S) * words * 4 + B * 4
    mem_ms = bound_ms(nbytes)
    mma = -(-B // 16) * -(-S // 8) * -(-words // 8)
    return {"bound_ms": max(ops_ms, mem_ms),
            "bound_by": "operations" if ops_ms > mem_ms else "bytes",
            "bytes": nbytes, "mma": mma}


def entry_main_path(tag, calls, batches):
    """The sampled entry's counters since they were zeroed, after ``calls``
    knns calls of ``batches`` query batches each on card tensors: one
    kernel launch a batch and no plain call (raises otherwise)."""
    from hnsw_itu_tpu_torch.ops.entry import sampled_entry

    rec = {"batches": calls * batches,
           "launches": sampled_entry.kernel_launches,
           "plain_calls": sampled_entry.plain_calls}
    log(f"[{tag}] sampled entry: {rec['launches']} kernel launches, "
        f"{rec['plain_calls']} plain calls for {rec['batches']} query "
        "batches")
    if rec["launches"] != rec["batches"] or rec["plain_calls"]:
        raise AssertionError(f"[{tag}] sampled entry on the main path: {rec}")
    return rec


def entry_vs_plain(points, q, n, sample, smi, tag):
    """The sampled entry at a query batch's shape: one kernel launch and
    no plain call, its ids equal to its plain version's (raises
    otherwise), then timed by CUDA events beside its bound
    (``entry_bound``), its plain version (ids, gather, ``pairwise_mxu``
    blocks, argmin) and the library yardstick (``pairwise_mxu`` and
    ``argmin`` on the gathered sample)."""
    import torch

    from hnsw_itu_tpu_torch.ops.entry import (sampled_entry,
                                              sampled_entry_plain,
                                              strided_sample_ids)
    from hnsw_itu_tpu_torch.ops.metrics import HAMMING

    def kernel():
        return sampled_entry(points, q, n, sample_size=sample,
                             metric=HAMMING)

    def plain():
        return sampled_entry_plain(points, q, n, sample_size=sample,
                                   metric=HAMMING)

    before = (sampled_entry.kernel_launches, sampled_entry.plain_calls)
    got = kernel()
    torch.cuda.synchronize()
    if (sampled_entry.kernel_launches, sampled_entry.plain_calls) != \
            (before[0] + 1, before[1]):
        raise AssertionError(f"[{tag}] sampled entry: not one launch")
    want = plain()
    diff = int((got != want).sum())
    err = int((got.long() - want.long()).abs().max()) if diff else 0
    if diff:
        raise AssertionError(f"[{tag}] sampled entry kernel != plain on "
                             f"{diff} of {q.shape[0]} queries (ids up to "
                             f"{err} apart)")
    ids = strided_sample_ids(n, sample, device=q.device)
    rows = points[ids.long()]
    B, words = q.shape
    bd = entry_bound(B, sample, words)
    k_ms = cuda_ms(kernel, 20)
    p_ms = cuda_ms(plain, 3)
    l_ms = cuda_ms(lambda: torch.argmin(HAMMING.pairwise_mxu(q, rows),
                                        dim=1), 3)
    log(f"[{tag}] on {smi}: sampled entry {B} x {sample} ({words} words, "
        f"n {n}): kernel {k_ms:.4f} ms (ids equal to the plain version's), "
        f"plain {p_ms:.3f} ms, pairwise_mxu + argmin {l_ms:.3f} ms; bound "
        f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
        f"({bd['bound_ms'] / k_ms:.0%} of it); {bd['mma']} m16n8k256, "
        f"{bd['mma'] * 18 / (132 * 1.98e9) * 1e3:.4f} ms at the rate #7 "
        "showed (an estimate: about 18 SM clocks each at 1.98 GHz over 132 "
        "SMs)")
    return {"shape": [B, sample, words], "n": n, "ids_differing": diff,
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": l_ms, **bd}


def phase_build_kernels(index, qs, dev, smi):
    """The two build kernels against their plain versions at the build's
    shapes, on the finished index: one chunk of searches (ef = efc, seeded
    by the sampled entry as the build seeds them) and the ef sweep; then
    the select blocks of those beams; both timed with their bounds and
    yardsticks."""
    import torch

    from hnsw_itu_tpu_torch.ops import _kernels
    from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
    from hnsw_itu_tpu_torch.ops.entry import sampled_entry
    from hnsw_itu_tpu_torch.ops.metrics import (HAMMING, as_sketches,
                                                popcount_sum)
    from hnsw_itu_tpu_torch.ops.mini_search import IINF
    from hnsw_itu_tpu_torch.ops.search import beam_search_gather

    efc = BUILD_OPTS["ef_construction"]
    B = BUILD_OPTS["batch_size"] * 16  # one steady-state chunk
    q = as_sketches(qs[:B], dev)
    B, words = q.shape
    adj, points = index.base.adj, index.points
    W = adj.shape[1]
    eps = sampled_entry(points, q, index.n, sample_size=SAMPLE,
                        metric=HAMMING)
    d0 = popcount_sum(points[eps.long()] ^ q)
    steps = 2048  # search_select's expansion bound
    err6, got = gather_vs_plain(adj, points, None, q, d0, eps, ef=efc,
                                max_steps=steps)
    keys, vis, stp = got
    log(f"[10] {B} build searches (one chunk) at ef={efc} over the finished "
        f"base layer: kernel vs plain max |diff| {err6} over keys, visited, "
        f"steps (steps/q {stp.float().mean():.2f}, visited/q "
        f"{vis.float().mean():.1f})")
    if err6:
        raise AssertionError("gather kernel != plain at the build shapes")
    kw = dict(ef=efc, max_steps=steps)
    k6 = cuda_ms(lambda: dma_beam_search(adj, points, None, q, d0, eps, **kw),
                 10)
    p6 = cuda_ms(lambda: beam_search_gather(adj, points, None, q, d0, eps,
                                            **kw), 1)
    # bytes the searches must move: each expansion's W ids, each fresh
    # neighbor's sketch, queries and seeds in, keys and counts out
    rows = int(stp.long().sum())
    fresh = int(vis.long().sum()) - B
    nbytes6 = (rows * W * 4 + fresh * words * 4 + B * words * 4 + B * 8
               + B * efc * 8 + B * 8)
    b6 = bound_ms(nbytes6)
    warps = _kernels.resident_warps("dma_beam_search", efc, W)
    log(f"[10] on {smi}: gather kernel {k6:.3f} ms ({warps} resident "
        f"warps/SM), plain version {p6:.3f} ms for {B} searches; {rows} "
        f"expansions, {fresh} fresh neighbors: {nbytes6 / 1e9:.4f} GB, bound "
        f"{b6:.4f} ms at {HBM_BYTES_PER_S / 1e12} TB/s")
    dma = {"max_abs_err": err6, "ms": k6, "plain_ms": p6, "bound_ms": b6,
           "searches": B, "steps_q": rows / B, "resident_warps": warps}
    dma["sweep"] = []
    for ef in SWEEP_EFS:
        e6, (_, v, st) = gather_vs_plain(adj, points, None, q, d0, eps, ef=ef,
                                         max_steps=SWEEP_STEPS)
        if e6:
            raise AssertionError(f"gather kernel != plain in the sweep, "
                                 f"ef={ef}")
        ms = cuda_ms(lambda ef=ef: dma_beam_search(
            adj, points, None, q, d0, eps, ef=ef, max_steps=SWEEP_STEPS), 10)
        r, f_ = int(st.long().sum()), int(v.long().sum()) - B
        b = bound_ms(r * W * 4 + f_ * words * 4 + B * words * 4 + B * 8
                     + B * ef * 8 + B * 8)
        dma["sweep"].append({"ef": ef, "ms": ms, "bound_ms": b,
                             "steps_q": r / B, "visited_q": (f_ + B) / B})
        log(f"[10] sweep ef={ef} max_steps={SWEEP_STEPS}: gather kernel "
            f"{ms:.3f} ms, steps/q {r / B:.2f}, visited/q {(f_ + B) / B:.1f}, "
            f"bound {b:.4f} ms (kernel vs plain max |diff| {e6})")

    # the select blocks of those beams: [B, efc, efc]
    bi = (keys & 0xFFFFFFFF).to(torch.int32)
    cand = points[torch.where(bi < IINF, bi, 0).long()].contiguous()
    ham = hamming_vs_plain(cand, "select, one chunk", smi, "10")

    # the sampled entry at the 1M cell's shape: every query against the
    # 1024-point sample
    entry = entry_vs_plain(points, as_sketches(qs, dev), index.n, SAMPLE,
                           smi, "10")
    return {"dma": dma, "ham": ham, "entry": entry}


def phase_build_query(index, pts, qs, dev, smi):
    """Serve the device-built index on the fused path: oracle, enable_inline
    (fused table), knns at k=10, ef=32, max_steps auto; recall gate; the
    fused kernel's launches in those knns calls, then the kernel against
    its plain version on every query at those shapes."""
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.ops.entry import sampled_entry
    from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches
    from hnsw_itu_tpu_torch.utils import recall_at_k

    gt_i, gt_d = phase_oracle(pts, qs, dev, tag="11", with_dists=True)
    nq = len(qs)
    index.query_entry_sample = SAMPLE
    index.max_steps = None  # the bench's rule past 200k: max(2 ef, 64)
    index.query_batch = max(10240, nq)
    t0 = time.perf_counter()
    index.enable_inline()
    torch.cuda.synchronize()
    if index.fused is None:
        raise AssertionError("the policy did not pick the fused table")
    log(f"[11] fused table {tuple(index.fused.data.shape)}: "
        f"{index.fused.data.numel() * 4 / 1e9:.3f} GB, built in "
        f"{time.perf_counter() - t0:.2f} s")
    q = as_sketches(qs, dev)
    fused_beam_search.kernel_launches = fused_beam_search.plain_calls = 0
    sampled_entry.kernel_launches = sampled_entry.plain_calls = 0
    index.knns(q, K, EF)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        res = index.knns(q, K, EF)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    launches = fused_beam_search.kernel_launches
    plain = fused_beam_search.plain_calls
    entry = entry_main_path("11", 4, -(-nq // index.query_batch))
    ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
    if ids.shape != (nq, K) or not ((ids >= 0) & (ids < index.n)).all() \
            or not (np.diff(dists, axis=1) >= 0).all():
        raise AssertionError("bad result on the device-built index")
    log(f"[11] fused kernel launches {launches}, plain_calls {plain}")
    if launches <= 0 or plain != 0:
        raise AssertionError(f"served fused path launches {launches}, "
                             f"plain calls {plain}")
    rec = recall_at_k(ids, gt_i, K)
    log(f"[11] knns k={K} ef={EF} (max_steps {index._steps_cap(EF)}) on the "
        f"device-built index: best of 3 {best * 1e3:.2f} ms for {nq} queries "
        f"= {nq / best:,.0f} QPS, recall@10 {rec:.4f}, visited/q "
        f"{index.last_stats['visited'] / nq:.1f}, steps/q "
        f"{index.last_stats['steps'] / nq:.2f}")
    if rec < RECALL_GATE:
        raise AssertionError(f"recall@10 {rec:.4f} < {RECALL_GATE}")
    kernel = fused_at_served_shapes(index, qs, dev, smi, tag="11",
                                    max_steps=index._steps_cap(EF))
    del kernel["entry"]
    return {"recall": rec, "knns_ms": best * 1e3, "launches": launches,
            "entry": entry, "kernel": kernel, "gt_i": gt_i, "gt_d": gt_d}


def gather_bytes(rows, fresh, B, W, words, ef):
    """Bytes a gather search must move: each expansion's W ids, each fresh
    neighbor's sketch, queries and seeds in, keys and counts out."""
    return (rows * W * 4 + fresh * words * 4 + B * words * 4 + B * 8
            + B * ef * 8 + B * 8)


def greedy_descent(index, q, steps):
    """The reference descent: ``greedy_search`` (the general ef=1 beam
    search, bitmask dedup) on every level, top to bottom, following
    ``down``. Returns the base-layer entries int32[B]."""
    import torch

    from hnsw_itu_tpu_torch.ops.search import greedy_search

    eps = torch.full((q.shape[0],), index.ep, dtype=torch.int32,
                     device=q.device)
    for lv in reversed(index.levels):
        cap_l = lv.graph.adj.shape[0]
        _, best = greedy_search(
            lambda ids, ni=lv.node_ids: index.points[ni[ids].long()],
            lv.graph.adj, q, eps, metric=index.metric, capacity=cap_l,
            max_steps=steps)
        eps = lv.down[best.long().clamp(0, cap_l - 1)]
    return eps


def descent_on_kernel(index, q, dev, tag):
    """The greedy descent of ``index`` for queries ``q`` level by level on
    kernel #6 at ef=1, each level's launch held against its plain version
    (keys/visited/steps equal) and timed apart; the entries equal to the
    general ``greedy_search`` descent. Returns (eps, record)."""
    import torch

    from hnsw_itu_tpu_torch.models.hnsw import descent_eps
    from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
    from hnsw_itu_tpu_torch.ops.metrics import popcount_sum
    from hnsw_itu_tpu_torch.ops.search import beam_search_gather

    steps = index._steps_cap(EF)
    B, words = q.shape
    eps = torch.full((B,), index.ep, dtype=torch.int32, device=dev)
    err, k_ms, p_ms, nbytes = 0, 0.0, 0.0, 0
    for lv in reversed(index.levels):
        adj, ni = lv.graph.adj, lv.node_ids
        d0 = popcount_sum(index.points[ni[eps.long()].long()] ^ q)
        kw = dict(ef=1, max_steps=steps)
        e, got = gather_vs_plain(adj, index.points, ni, q, d0, eps, **kw)
        err = max(err, e)
        k_ms += cuda_ms(lambda: dma_beam_search(adj, index.points, ni, q, d0,
                                                eps, **kw), 10)
        p_ms += cuda_ms(lambda: beam_search_gather(adj, index.points, ni, q,
                                                   d0, eps, **kw), 1)
        keys, vis, stp = got
        nbytes += gather_bytes(int(stp.long().sum()),
                               int(vis.long().sum()) - B, B,
                               adj.shape[1], words, 1)
        eps = lv.down[(keys[:, 0] & 0xFFFFFFFF).clamp(
            max=adj.shape[0] - 1)]
    want = greedy_descent(index, q, steps)
    torch.cuda.synchronize()
    if err or not torch.equal(eps, want):
        raise AssertionError(f"descent on #6 (max |diff| {err}) != plain, "
                             "or its entries != greedy_search's")
    d_ms = cuda_ms(lambda: descent_eps(index.points, index.levels, q,
                                       index.ep, metric=index.metric,
                                       max_steps=steps), 10)
    g_ms = cuda_ms(lambda: greedy_descent(index, q, steps), 2)
    log(f"[{tag}] descent of {B} queries through {len(index.levels)} "
        f"levels: #6 at ef=1 vs plain max |diff| {err} over keys, visited, "
        f"steps; entries equal to greedy_search's; #6 launches "
        f"{k_ms:.3f} ms (plain {p_ms:.3f} ms, bound "
        f"{bound_ms(nbytes):.4f} ms); whole descent {d_ms:.3f} ms on #6, "
        f"{g_ms:.3f} ms on the general greedy_search")
    return eps, {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                 "bound_ms": bound_ms(nbytes), "descent_ms": d_ms,
                 "greedy_search_ms": g_ms, "levels": len(index.levels)}


def phase_descent(index, qs, gt_i, dev, smi, tag="13"):
    """knns with the greedy descent (query_entry_sample = 0) on a fused
    index: recall gate, #6 launched for the descent and the fused kernel
    for the base, neither plain version called; then the descent and the
    base kernel timed apart (``descent_on_kernel``; the fused kernel on
    the descent's init keys against its plain version)."""
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.models.nsw import _id_bits
    from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
    from hnsw_itu_tpu_torch.ops.fused_search import (fused_beam_search,
                                                     key_clamp)
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches, popcount_sum
    from hnsw_itu_tpu_torch.ops.search import beam_search_packed
    from hnsw_itu_tpu_torch.utils import recall_at_k

    nq = len(qs)
    index.query_entry_sample = 0
    index.max_steps = None
    q = as_sketches(qs, dev)
    dma_beam_search.kernel_launches = dma_beam_search.plain_calls = 0
    fused_beam_search.kernel_launches = fused_beam_search.plain_calls = 0
    index.knns(q, K, EF)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        res = index.knns(q, K, EF)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    counts = {"dma": dma_beam_search.kernel_launches,
              "dma_plain": dma_beam_search.plain_calls,
              "fused": fused_beam_search.kernel_launches,
              "fused_plain": fused_beam_search.plain_calls}
    ids = res.ids.cpu().numpy()
    dists = res.dists.cpu().numpy()
    if ids.shape != (nq, K) or not ((ids >= 0) & (ids < index.n)).all() \
            or not (np.diff(dists, axis=1) >= 0).all():
        raise AssertionError(f"bad result with the descent at N={index.n}")
    rec = recall_at_k(ids, gt_i, K)
    log(f"[{tag}] knns k={K} ef={EF} with the greedy descent "
        f"(query_entry_sample 0, max_steps {index._steps_cap(EF)}) at "
        f"N={index.n}, route {index.last_route}: best of 3 "
        f"{best * 1e3:.2f} ms for {nq} queries, recall@10 {rec:.4f}, "
        f"visited/q {index.last_stats['visited'] / nq:.1f}, steps/q "
        f"{index.last_stats['steps'] / nq:.2f}; launches {counts}")
    if index.last_route != "fused" or counts["dma"] <= 0 \
            or counts["fused"] <= 0 or counts["dma_plain"] \
            or counts["fused_plain"]:
        raise AssertionError(f"descent path did not run on the kernels: "
                             f"{index.last_route} {counts}")
    if rec < RECALL_GATE:
        raise AssertionError(f"recall@10 {rec:.4f} < {RECALL_GATE}")
    eps, desc = descent_on_kernel(index, q, dev, tag)
    # the base kernel on the descent's entries, as _query_step_fused runs it
    table = index.fused
    id_bits = _id_bits(table.cap)
    max_d = key_clamp(id_bits, q.shape[1] * 32)
    d0 = popcount_sum(index.points[eps.long()] ^ q)
    order = torch.argsort(d0, stable=True)
    qs_o = q[order].contiguous()
    init = ((d0[order].clamp(max=max_d) << id_bits) | eps[order]).contiguous()
    kw = dict(ef=EF, id_bits=id_bits, max_d=max_d,
              max_steps=index._steps_cap(EF))
    err = max_abs_diff(fused_beam_search(table, qs_o, init, **kw),
                       beam_search_packed(table.ids, table.data, qs_o, init,
                                          **kw))
    if err:
        raise AssertionError("fused kernel != plain after the descent")
    f_ms = cuda_ms(lambda: fused_beam_search(table, qs_o, init, **kw), 10)
    log(f"[{tag}] on {smi}: descent {desc['descent_ms']:.3f} ms, fused "
        f"kernel on its entries {f_ms:.3f} ms (vs plain max |diff| {err}), "
        f"whole knns {best * 1e3:.3f} ms (host clock)")
    desc.update(launches=counts["dma"], recall=rec, knns_ms=best * 1e3,
                fused_ms=f_ms, fused_launches=counts["fused"],
                n=index.n, fused_err=err)
    return desc


def cli_hamming_blocks(index, opts, smi):
    """Kernel #7 at the M=256 build's own shapes on the built index, each
    against its plain version: one select block (a full chunk of points
    searched at ef = efc from the sampled entry, its beam in pop order, as
    ``_build.search_select`` builds it) and one prune block (the
    ``prune_budget`` fullest base rows plus a spill width of extra
    candidates, in pop order, as ``graph.prune_rows`` builds it)."""
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.models import _build
    from hnsw_itu_tpu_torch.ops.metrics import HAMMING
    from hnsw_itu_tpu_torch.ops.mini_search import IINF
    from hnsw_itu_tpu_torch.ops.select import pop_order

    adj, points = index.base.adj, index.points
    cap, words = adj.shape[0], points.shape[1]

    def in_pop_order(ids, d, valid, pts):
        perm = pop_order(d, ids, valid)[0]
        return pts.gather(1, perm[:, :, None].expand(-1, -1, words))

    S = min(opts.batch_size * 16, index.n)  # the build's steady chunk
    chunk = points[index.n - S : index.n]
    eps = _build.entry_step(points, chunk, index.n,
                            sample_size=opts.entry_sample)
    bd, bi = _build.build_search(points, None, adj, chunk, eps,
                                 ef=opts.ef_construction)
    sel = in_pop_order(bi, bd, bi < IINF,
                       points[bi.clamp(0, cap - 1).long()]).contiguous()
    P = min(opts.prune_budget, index.n)
    nodes = torch.argsort(index.base.deg[:index.n], descending=True,
                          stable=True)[:P]
    extra = torch.from_numpy(np.random.default_rng(0).integers(
        0, index.n, (P, _build.SPILL_WIDTH), dtype=np.int32)).to(adj.device)
    ids = torch.cat([adj[nodes], extra], dim=1)
    nbr = points[ids.clamp(0, cap - 1).long()]
    d = HAMMING.one_to_many(points[nodes], nbr)
    prune = in_pop_order(ids, d, ids >= 0, nbr).contiguous()
    return {"select": hamming_vs_plain(sel, "select, one chunk", smi, "12"),
            "prune": hamming_vs_plain(prune, "prune, one budget", smi,
                                      "12")}


def phase_cli_default(pts, qs, gt_i, dev, smi):
    """Phase 12: the JAX CLI's query command at its defaults (efc=96, m=24,
    M=256, the other IndexOptions at their defaults, enable_inline(), knns
    at k=10, ef=96, no entry sample) on the port: the build's searches on
    the general beam search (rows 256 wide), its select and prune blocks
    on #7; the query on the greedy descent and the general base search."""
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.models import _build
    from hnsw_itu_tpu_torch.models.hnsw import HNSW, HNSWBuilder, descent_eps
    from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
    from hnsw_itu_tpu_torch.ops.hamming import hamming_block
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches
    from hnsw_itu_tpu_torch.utils import recall_at_k

    n, nq = len(pts), len(qs)
    opts = IndexOptions(size=n, **{**CLI_OPTS, "host_warmup": min(
        CLI_OPTS["host_warmup"], n)})
    b = HNSWBuilder(opts, device=dev)
    b.timings = {}
    warm_done = []

    def progress(off):
        if not warm_done:
            torch.cuda.synchronize()
            warm_done.append(time.perf_counter())

    dma_beam_search.kernel_launches = dma_beam_search.plain_calls = 0
    hamming_block.kernel_launches = hamming_block.plain_calls = 0
    t0 = time.perf_counter()
    b.extend_batched(pts, progress=progress)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    index = b.build()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rec = {"ham_launches": hamming_block.kernel_launches,
           "ham_plain": hamming_block.plain_calls,
           "dma_launches": dma_beam_search.kernel_launches,
           "dma_plain": dma_beam_search.plain_calls,
           "host_s": warm_done[0] - t0, "device_s": t1 - warm_done[0],
           "finish_s": t2 - t1, "level_ns": index.level_ns,
           "edge_drops": b.total_edge_drops()}
    log(f"[12] build of {n} points at the CLI's options, {opts}: host "
        f"warmup {rec['host_s']:.1f} s, device chunks {rec['device_s']:.1f} "
        f"s, build() {rec['finish_s']:.2f} s; levels {index.level_ns}, ep "
        f"{index.ep}, total_edge_drops {rec['edge_drops']}")
    rec["spans_ms"] = _build.span_ms(b.timings)
    for name in ("entry", "search", "select", "apply"):
        k = len(b.timings.get(name, ()))
        ms = rec["spans_ms"].get(name, 0.0)
        log(f"[12]   {name:6s} {ms:10.1f} ms over {k} spans "
            f"({ms / max(1, k):.3f} ms each; CUDA events)")
    log(f"[12] hamming block launches {rec['ham_launches']}, plain_calls "
        f"{rec['ham_plain']}; gather kernel launches {rec['dma_launches']} "
        f"(rows 256 wide: the general beam search serves every search), "
        f"plain_calls {rec['dma_plain']}")
    if rec["ham_launches"] <= 0 or rec["ham_plain"] or rec["dma_launches"] \
            or rec["dma_plain"]:
        raise AssertionError(f"the CLI build's kernel counts: {rec}")
    rec["ham"] = cli_hamming_blocks(index, opts, smi)
    del b
    t0 = time.perf_counter()
    index.enable_inline()
    torch.cuda.synchronize()
    log(f"[12] enable_inline() in {time.perf_counter() - t0:.2f} s: fused "
        f"{index.fused is not None}, mini {index.mini is not None}, inline "
        f"rows (beam dedup) {index.inline_rows}")
    q = as_sketches(qs, dev)
    index.knns(q, K, CLI_EF)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        res = index.knns(q, K, CLI_EF)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
    vis_q = index.last_stats["visited_q"]
    steps_q = index.last_stats["steps_q"]
    if ids.shape != (nq, K) or not ((ids >= 0) & (ids < index.n)).all() \
            or not (np.diff(dists, axis=1) >= 0).all():
        raise AssertionError("bad result on the CLI-default index")
    r10 = recall_at_k(ids, gt_i, K)
    rec.update(route=index.last_route, knns_ms=best * 1e3, recall=r10,
               visited_q=float(vis_q.mean()), steps_q=float(steps_q.mean()))
    log(f"[12] knns k={K} ef={CLI_EF} (query_entry_sample 0, max_steps "
        f"{index._steps_cap(CLI_EF)}, batches of {index.query_batch}), route "
        f"{index.last_route}: best of 3 {best * 1e3:.2f} ms for {nq} "
        f"queries = {nq / best:,.0f} QPS, recall@10 {r10:.4f}, visited/q "
        f"{rec['visited_q']:.1f}, steps/q {rec['steps_q']:.2f}")
    if index.last_route != "general":
        raise AssertionError(f"route {index.last_route}, want general")
    if r10 < RECALL_GATE:
        raise AssertionError(f"recall@10 {r10:.4f} < {RECALL_GATE}")
    # where the query time goes: the descent and the base search apart
    steps = index._steps_cap(CLI_EF)
    Bq = index.query_batch
    kw = dict(metric=index.metric, max_steps=steps)
    batches = [q[s : s + Bq] for s in range(0, nq, Bq)]
    eps = [descent_eps(index.points, index.levels, x, index.ep, **kw)
           for x in batches]
    rec["descent_ms"] = cuda_ms(lambda: [descent_eps(
        index.points, index.levels, x, index.ep, **kw) for x in batches], 1)
    rec["base_ms"] = cuda_ms(lambda: [index._query_step_general(
        x, e, k=K, ef=CLI_EF, max_steps=steps)
        for x, e in zip(batches, eps)], 1)
    log(f"[12] on {smi}: descent {rec['descent_ms']:.1f} ms, general base "
        f"search {rec['base_ms']:.1f} ms for {nq} queries (CUDA events)")
    # device busy share of one batch: profiler device time over host time
    one = q[:Bq]
    t0 = time.perf_counter()
    index.knns(one, K, CLI_EF)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    dev_ms, top = device_breakdown(lambda: index.knns(one, K, CLI_EF))
    rec.update(batch_host_ms=host_ms, batch_device_ms=dev_ms)
    log(f"[12] one batch of {len(one)} queries: {host_ms:.1f} ms host "
        f"clock, {dev_ms:.1f} ms device time (torch.profiler, mean of 3): "
        f"device busy {dev_ms / host_ms:.0%}; top kernels "
        + ", ".join(f"{k[:40]} {v:.1f} ms" for k, v in top))
    # the general route on CPU copies of the same index and queries
    cpu = HNSW(index.points, index.n, index.base, index.levels,
               index.level_ns, index.ep, index.metric, index.opts,
               device="cpu")
    cpu.inline_rows = index.inline_rows
    t0 = time.perf_counter()
    rc = cpu.knns(qs[:PARITY_Q], K, CLI_EF)
    same = (np.array_equal(rc.dists.numpy(), dists[:PARITY_Q])
            and np.array_equal(rc.ids.numpy(), ids[:PARITY_Q])
            and np.array_equal(cpu.last_stats["visited_q"], vis_q[:PARITY_Q])
            and np.array_equal(cpu.last_stats["steps_q"],
                               steps_q[:PARITY_Q]))
    log(f"[12] the same knns on CPU copies of the index, {PARITY_Q} "
        f"queries ({time.perf_counter() - t0:.1f} s): dists, ids, visited, "
        f"steps {'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("general route on CUDA != on CPU")
    return rec, index, (ids, dists)


def phase_nsw(nq, dev):
    """Phase 13, last part: a 100k NSW at M=64 built on the card (native
    warmup, then device chunks on #6 and #7), served through the general
    route (no table) and then the fused path; recall gate on both."""
    import torch

    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.models.nsw import NSWBuilder
    from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
    from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
    from hnsw_itu_tpu_torch.ops.hamming import hamming_block
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches
    from hnsw_itu_tpu_torch.utils import make_dataset, recall_at_k

    n = NSW_N
    pts, qs = make_dataset(0, n, nq)
    gt_i = phase_oracle(pts, qs, dev, tag="13")
    for f in (dma_beam_search, hamming_block, fused_beam_search):
        f.kernel_launches = f.plain_calls = 0
    t0 = time.perf_counter()
    b = NSWBuilder(IndexOptions(size=n, **BUILD_OPTS), device=dev)
    b.extend_batched(pts)
    index = b.build()
    torch.cuda.synchronize()
    rec = {"build_s": time.perf_counter() - t0,
           "dma_launches": dma_beam_search.kernel_launches,
           "ham_launches": hamming_block.kernel_launches,
           "edge_drops": b.total_edge_drops()}
    log(f"[13] NSW build of {n} points on the card ({BUILD_OPTS}): "
        f"{rec['build_s']:.1f} s, edge drops {rec['edge_drops']}, #6 "
        f"launches {rec['dma_launches']}, #7 launches {rec['ham_launches']}")
    index.query_entry_sample = SAMPLE
    q = as_sketches(qs, dev)
    for route in ("general", "fused"):
        if route == "fused":
            index.enable_inline()
        index.knns(q, K, EF)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = index.knns(q, K, EF)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        r10 = recall_at_k(res.ids.cpu().numpy(), gt_i, K)
        rec[route] = {"recall": r10, "knns_ms": ms}
        log(f"[13] NSW knns k={K} ef={EF} (sampled entry {SAMPLE}), route "
            f"{index.last_route}: {ms:.2f} ms, recall@10 {r10:.4f}")
        if index.last_route != route or r10 < RECALL_GATE:
            raise AssertionError(f"NSW {route}: route {index.last_route}, "
                                 f"recall@10 {r10:.4f}")
    plain = (dma_beam_search.plain_calls, hamming_block.plain_calls,
             fused_beam_search.plain_calls)
    if min(rec["dma_launches"], rec["ham_launches"],
           fused_beam_search.kernel_launches) <= 0 or any(plain):
        raise AssertionError(f"NSW phase kernel counts: {rec}, plain {plain}")
    return rec


def best_of_3(fn):
    """(best host-clock seconds of 3 runs after a warm one, every card
    synchronized around each, last result)."""
    fn()
    sync_cards()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        res = fn()
        sync_cards()
        best = min(best, time.perf_counter() - t0)
    return best, res


def index_copy(index, dev):
    """A fresh ``HNSW`` of the same arrays (``utils/serialize.py``
    ``from_numpy``), without the tables ``index`` holds."""
    from hnsw_itu_tpu_torch.utils import from_numpy

    host = lambda t: t.cpu().numpy()  # noqa: E731
    return from_numpy(
        host(index.points), host(index.base.adj), host(index.base.deg),
        [(host(lv.node_ids), host(lv.down), host(lv.graph.adj),
          host(lv.graph.deg)) for lv in index.levels],
        index.level_ns, index.ep, index.n, index.opts, dev)


def phase_reorder_fused(index, qs, gt_i, gt_d, dev, smi):
    """Phase 15, fused path: a reordered copy of the 1M device-built index
    (phase 11) on its fused table, k=10, ef=32 with the sampled entry as
    phase 11 serves it: ids in the original space, recall@10 >= 0.93,
    tie-tolerant recall within 0.005 of the unreordered index's, #1
    launched and its plain version never called; #1 against its plain
    version on every query; both indexes' knns timed."""
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches
    from hnsw_itu_tpu_torch.utils import recall_at_k, recall_tie_tolerant

    nq = len(qs)
    q = as_sketches(qs, dev)

    def serve(idx):
        idx.query_entry_sample = SAMPLE
        idx.max_steps = None
        idx.query_batch = max(10240, nq)
        return best_of_3(lambda: idx.knns(q, K, EF))

    def quality(res):
        ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
        if ids.shape != (nq, K) or not ((ids >= 0) & (ids < index.n)).all():
            raise AssertionError("bad result on the reordered index")
        return (recall_at_k(ids, gt_i, K),
                recall_tie_tolerant(dists, gt_d, K))

    base_s, res = serve(index)
    rec0, tt0 = quality(res)
    t0 = time.perf_counter()
    r = index_copy(index, dev)
    r.reorder()
    torch.cuda.synchronize()
    reorder_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r.enable_inline()
    torch.cuda.synchronize()
    if r.fused is None or r.id_map is None:
        raise AssertionError("the reordered copy has no fused table")
    log(f"[15] reordered copy of the {index.n}-point index (from_numpy + "
        f"BFS reorder): {reorder_s:.1f} s, fused table "
        f"{time.perf_counter() - t0:.2f} s")
    fused_beam_search.kernel_launches = fused_beam_search.plain_calls = 0
    re_s, res = serve(r)
    launches = fused_beam_search.kernel_launches
    plain = fused_beam_search.plain_calls
    rec, tt = quality(res)
    base_s = min(base_s, serve(index)[0])  # before and after, in turns
    log(f"[15] knns k={K} ef={EF}, sampled entry {SAMPLE}, route "
        f"{r.last_route}: reordered {re_s * 1e3:.2f} ms, recall@10 "
        f"{rec:.4f}, tie-tolerant {tt:.4f}; unreordered {base_s * 1e3:.2f} "
        f"ms, recall@10 {rec0:.4f}, tie-tolerant {tt0:.4f}; fused launches "
        f"{launches}, plain_calls {plain}")
    if r.last_route != "fused" or launches <= 0 or plain:
        raise AssertionError(f"reordered fused path: route {r.last_route}, "
                             f"launches {launches}, plain {plain}")
    if rec < RECALL_GATE or abs(tt - tt0) > 0.005:
        raise AssertionError(f"reordered recall@10 {rec:.4f}, tie-tolerant "
                             f"{tt:.4f} vs {tt0:.4f}")
    kernel = fused_at_served_shapes(r, qs, dev, smi, tag="15",
                                    max_steps=r._steps_cap(EF))
    del kernel["entry"]
    if not np.isfinite(kernel["ms"]):
        raise AssertionError("fused kernel not timed")
    return {"launches": launches, "knns_ms": re_s * 1e3,
            "unreordered_knns_ms": base_s * 1e3, "recall": rec,
            "unreordered_recall": rec0, "tie_tolerant": tt,
            "unreordered_tie_tolerant": tt0, "reorder_s": reorder_s,
            **kernel}


def phase_reorder_mini(index, qs, gt_i, dev, smi, base_ms):
    """Phase 15, mini path: the 2.2M index of phase 7 copied, its own mini
    table freed, the copy reordered and served on its mini table with the
    bit-reversed tie order (``tie_bits`` auto = the capacity's bits): knns
    at k=10, ef=32, the mini kernel launched and its plain version never
    called; then the kernel against its plain version on every query at
    those tie bits (d, ids, visited, steps), both timed with the bound.
    ``base_ms`` is the unreordered index's knns time (phase 7)."""
    import gc

    import torch

    from hnsw_itu_tpu_torch.ops.metrics import as_sketches
    from hnsw_itu_tpu_torch.ops.mini_search import (mini_beam_search,
                                                    mini_beam_search_plain)
    from hnsw_itu_tpu_torch.utils import recall_at_k

    nq = len(qs)
    W, mw = index.mini_W, index.mini_words
    r = index_copy(index, dev)
    index.mini = None  # one 18 GB table at a time: the same policy pick
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r.reorder()
    torch.cuda.synchronize()
    reorder_s = time.perf_counter() - t0
    r.query_entry_sample = SAMPLE
    r.max_steps = None
    r.query_batch = max(10240, nq)
    r.enable_inline()
    if r.mini is None or (r.mini_W, r.mini_words) != (W, mw):
        raise AssertionError(f"reordered copy's table: W={r.mini_W}, "
                             f"mw={r.mini_words}, want W={W}, mw={mw}")
    tie_bits = r._tie_bits()
    cap_bits = (r.base.capacity - 1).bit_length()
    q = as_sketches(qs, dev)
    mini_beam_search.kernel_launches = mini_beam_search.plain_calls = 0
    best, res = best_of_3(lambda: r.knns(q, K, EF))
    launches = mini_beam_search.kernel_launches
    plain = mini_beam_search.plain_calls
    ids = res.ids.cpu().numpy()
    rec = recall_at_k(ids, gt_i, K)
    log(f"[15] reordered {r.n}-point copy ({reorder_s:.1f} s), mini table "
        f"W={W} mw={mw}, tie_bits {tie_bits} (capacity bits {cap_bits}): "
        f"knns k={K} ef={EF} {best * 1e3:.2f} ms (unreordered "
        f"{base_ms:.2f} ms), recall@10 {rec:.4f}; mini launches {launches}, "
        f"plain_calls {plain}")
    if tie_bits != cap_bits or launches <= 0 or plain or \
            not ((ids >= 0) & (ids < r.n)).all():
        raise AssertionError(f"reordered mini path: tie_bits {tie_bits}, "
                             f"launches {launches}, plain {plain}")
    qs_o, d0, eps = mini_seeds(r.points, q, r.n, mw, 1)
    steps = r._steps_cap(EF)
    st = {}
    err, got = mini_vs_plain(r.mini, qs_o, d0, eps, ef=EF, max_steps=steps,
                             tie_bits=tie_bits, stats=st)
    if err:
        raise AssertionError("mini kernel != plain on the reordered index")
    kw = dict(ef=EF, mini_words=mw, max_steps=steps, tie_bits=tie_bits)
    k_ms = cuda_ms(lambda: mini_beam_search(r.mini, qs_o, d0, eps, **kw), 10)
    p_ms = cuda_ms(lambda: mini_beam_search_plain(r.mini, qs_o, d0, eps,
                                                  **kw), 2)
    b_ms = bound_ms(mini_bytes(st, got[2], nq, W, mw, EF)[1])
    log(f"[15] on {smi}: {nq} queries, ef={EF}, tie_bits {tie_bits}: mini "
        f"kernel vs plain max |diff| {err} over d, ids, visited, steps; "
        f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.3f} ms")
    del r
    return {"launches": launches, "knns_ms": best * 1e3,
            "unreordered_knns_ms": base_ms, "recall": rec,
            "tie_bits": tie_bits, "reorder_s": reorder_s, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms}


def phase_cli_card(path, qs, gt_i, want, inline_rows, dev, smi):
    """Phase 14: the CLI on the card, on phase 12's index saved to
    ``path``: ``inspect`` as a subprocess (degree percentiles of every
    layer, the host-BFS connectivity line); ``load_index`` on the card and
    the CLI's ``query_points`` at k=10, ef=96, ids and dists equal to
    phase 12's knns (``want``), then its sort and pad and the recall gate;
    then ``-S`` (the native host engine, one thread) on 1000 queries.
    The card machine has no h5py, so the HDF5 commands (query-index,
    evaluate) run in the CPU tests only."""
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.cli import finish_result, query_points
    from hnsw_itu_tpu_torch.utils import load_index, recall_at_k

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "hnsw_itu_tpu_torch.cli",
                          "inspect", path], cwd=HERE, capture_output=True,
                         text=True, timeout=900)
    inspect_s = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    shown = [ln for ln in lines if ln.endswith("connections")
             or ln.startswith(("p0 ", "p50 ", "p100 ", "query on whole"))]
    for ln in shown:
        log(f"[14] inspect: {ln}")
    if out.returncode != 0 or not any(ln.startswith("base has")
                                      for ln in lines) \
            or not any("host BFS from the entry point" in ln
                       for ln in lines) or "layer0 has" not in out.stdout:
        raise AssertionError(f"inspect failed (rc {out.returncode}): "
                             f"{out.stderr[-2000:]}")
    log(f"[14] python -m hnsw_itu_tpu_torch.cli inspect: rc 0 in "
        f"{inspect_s:.1f} s")
    t0 = time.perf_counter()
    idx, attrs = load_index(path, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dists, ids = query_points(qs, idx, attrs, K, CLI_EF)
    query_s = time.perf_counter() - t0
    same = np.array_equal(ids, want[0]) and np.array_equal(dists, want[1])
    log(f"[14] load_index on the card {load_s:.1f} s; query_points k={K} "
        f"ef={CLI_EF} (route {idx.last_route}, inline rows "
        f"{idx.inline_rows}): {query_s:.2f} s for {len(qs)} queries; ids "
        f"and dists {'equal' if same else 'DIFFERENT'} to phase 12's knns")
    if idx.inline_rows != inline_rows or not same:
        raise AssertionError("the CLI's query on the loaded index != phase 12")
    ids_s, dists_s = finish_result(ids, dists, K, sort=True)
    rec = recall_at_k(ids_s, gt_i, K)
    if rec < RECALL_GATE or not (np.diff(dists_s, axis=1) >= 0).all():
        raise AssertionError(f"CLI result recall@10 {rec:.4f}")
    n1 = min(1000, len(qs))
    t0 = time.perf_counter()
    d1, i1 = query_points(qs[:n1], idx, attrs, K, CLI_EF,
                          single_threaded=True)
    host_s = time.perf_counter() - t0
    rec_s = recall_at_k(i1, gt_i[:n1], K)
    log(f"[14] sorted, padded result: recall@10 {rec:.4f}; -S (native host "
        f"engine, one thread) on {n1} queries: {host_s:.2f} s = "
        f"{host_s / n1 * 1e6:.1f} us per query, recall@10 {rec_s:.4f} "
        f"(on {smi})")
    if rec_s < RECALL_GATE or d1.shape != (n1, K):
        raise AssertionError(f"-S recall@10 {rec_s:.4f}")
    return {"inspect_s": inspect_s, "load_s": load_s, "query_s": query_s,
            "recall": rec, "single_threaded_s": host_s,
            "single_threaded_us_per_query": host_s / n1 * 1e6,
            "single_threaded_recall": rec_s}


def make_l2_dataset(seed, n, nq, dim=L2_DIM):
    """Unit-norm float32 vectors clustered as utils/synth.py clusters the
    sketches: 64 roots -> 4096 mids -> n/128 leaves, each level a smaller
    Gaussian offset of its parent; points and queries are leaves plus
    noise. Returns (points [n, dim], queries [nq, dim])."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def normal(rows, scale):
        return (rng.standard_normal((rows, dim), dtype=np.float32)
                * np.float32(scale))

    roots = normal(64, 1.0)
    mids = roots[rng.integers(0, 64, 4096)] + normal(4096, 0.5)
    leaves = mids[rng.integers(0, 4096, max(1, n // 128))]
    leaves += normal(leaves.shape[0], 0.25)

    def draw(rows):
        x = leaves[rng.integers(0, leaves.shape[0], rows)] + normal(rows,
                                                                    0.15)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    return draw(n), draw(nq)


def phase_l2(nq, dev, smi):
    """Phase 16: the other metrics on the card. ``l2``: L2_N float32
    points of L2_DIM dimensions (make_l2_dataset), HNSWBuilder at the
    bench's options on the card (no native warmup: the engine has no
    float metric; every search on the general beam search), the oracle
    Bruteforce("l2") on the card, knns at the CLI's k=10, ef=96 through
    the greedy descent on greedy_search: recall@10 >= 0.93, the device's
    busy share on one batch, and the same call on CPU copies for
    PARITY_Q queries (dists within rtol 1e-5, ids equal where the row's
    distances are not tied). ``l2int``: the point3d example on the card,
    its golden distances."""
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.examples import point3d
    from hnsw_itu_tpu_torch.models import Bruteforce, IndexOptions
    from hnsw_itu_tpu_torch.models import _build
    from hnsw_itu_tpu_torch.models.hnsw import HNSW, HNSWBuilder
    from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
    from hnsw_itu_tpu_torch.ops.hamming import hamming_block
    from hnsw_itu_tpu_torch.utils import recall_at_k

    t0 = time.perf_counter()
    pts, qs = make_l2_dataset(0, L2_N, nq)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bf = Bruteforce("l2", device=dev)
    bf.extend(pts)
    gt_i = bf.build().knns(qs, K).ids.cpu().numpy()
    oracle_s = time.perf_counter() - t0
    log(f"[16] l2 data {pts.shape} float32 on the host {data_s:.1f} s; "
        f"oracle Bruteforce('l2') on the card {oracle_s:.2f} s")
    opts = IndexOptions(size=L2_N, **BUILD_OPTS)
    b = HNSWBuilder(opts, "l2", device=dev)
    b.timings = {}
    for f in (dma_beam_search, hamming_block):
        f.kernel_launches = f.plain_calls = 0
    t0 = time.perf_counter()
    b.extend_batched(pts)
    index = b.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    spans = _build.span_ms(b.timings)
    rec = {"data_s": data_s, "oracle_s": oracle_s, "build_s": build_s,
           "spans_ms": spans, "level_ns": index.level_ns,
           "edge_drops": b.total_edge_drops(),
           "dma_launches": dma_beam_search.kernel_launches,
           "ham_launches": hamming_block.kernel_launches}
    log(f"[16] l2 build of {L2_N} x {L2_DIM} on the card, {opts}: "
        f"{build_s:.1f} s (no host warmup), levels {index.level_ns}, edge "
        f"drops {rec['edge_drops']}; CUDA events: "
        + ", ".join(f"{k} {v:.0f} ms" for k, v in spans.items())
        + f"; #6 launches {rec['dma_launches']}, #7 launches "
        f"{rec['ham_launches']}")
    if rec["dma_launches"] or rec["ham_launches"] or index.n != L2_N:
        raise AssertionError(f"l2 build ran a Hamming kernel: {rec}")
    del b
    index.enable_inline()
    q = torch.from_numpy(qs).to(dev)
    best, res = best_of_3(lambda: index.knns(q, K, CLI_EF))
    ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
    r10 = recall_at_k(ids, gt_i, K)
    Bq = index.query_batch
    one = q[:Bq]
    t0 = time.perf_counter()
    index.knns(one, K, CLI_EF)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    dev_ms, _ = device_breakdown(lambda: index.knns(one, K, CLI_EF))
    rec.update(knns_ms=best * 1e3, recall=r10, route=index.last_route,
               inline_rows=index.inline_rows,
               visited_q=float(index.last_stats["visited_q"].mean()),
               steps_q=float(index.last_stats["steps_q"].mean()),
               batch_host_ms=host_ms, batch_device_ms=dev_ms)
    log(f"[16] knns k={K} ef={CLI_EF} (greedy descent on greedy_search, "
        f"route {index.last_route}, inline rows {index.inline_rows}): best "
        f"of 3 {best * 1e3:.1f} ms for {nq} queries = {nq / best:,.0f} QPS, "
        f"recall@10 {r10:.4f}, visited/q {rec['visited_q']:.1f}, steps/q "
        f"{rec['steps_q']:.2f}; one batch of {len(one)}: {host_ms:.1f} ms "
        f"host clock, {dev_ms:.1f} ms device time: busy "
        f"{dev_ms / host_ms:.0%} (on {smi})")
    if index.last_route != "general" or r10 < RECALL_GATE or \
            not np.isfinite(dists).all():
        raise AssertionError(f"l2 knns: route {index.last_route}, recall@10 "
                             f"{r10:.4f}")
    cpu = HNSW(index.points, index.n, index.base, index.levels,
               index.level_ns, index.ep, index.metric, index.opts,
               device="cpu")
    cpu.inline_rows = index.inline_rows
    t0 = time.perf_counter()
    rc = cpu.knns(qs[:PARITY_Q], K, CLI_EF)
    cd, ci = rc.dists.numpy(), rc.ids.numpy()
    gd = dists[:PARITY_Q]
    close = np.allclose(cd, gd, rtol=1e-5, atol=1e-6)
    sep = np.ones_like(gd, bool)  # no neighbor in the row within rtol
    near = np.abs(np.diff(gd, axis=1)) <= 1e-5 * gd[:, 1:]
    sep[:, 1:] &= ~near
    sep[:, :-1] &= ~near
    same_ids = np.array_equal(ci[sep], ids[:PARITY_Q][sep])
    log(f"[16] the same knns on CPU copies, {PARITY_Q} queries "
        f"({time.perf_counter() - t0:.1f} s): dists within rtol 1e-5 "
        f"{close}, ids equal at the {int(sep.sum())} untied of "
        f"{sep.size} places {same_ids}")
    if not (close and same_ids):
        raise AssertionError("l2 knns on CUDA != on CPU")
    t0 = time.perf_counter()
    golden = point3d.main(device=dev).tolist()
    rec["point3d_s"] = time.perf_counter() - t0
    log(f"[16] l2int: point3d example on the card: {golden} "
        f"({rec['point3d_s']:.1f} s)")
    if golden != point3d.EXPECTED:
        raise AssertionError(f"point3d {golden} != {point3d.EXPECTED}")
    return rec


def shard_mesh(dev, shards):
    """A mesh that names the one card ``shards`` times."""
    from hnsw_itu_tpu_torch.parallel import make_mesh

    return make_mesh(devices=[dev] * shards)


def phase_query_sharded(index, qs, gt_i, dev, shards):
    """Phase 17 (c), on phase 11's 1M index before it is freed:
    knns_query_sharded over ``shards`` shards of the card, with the
    sampled entry and then the greedy descent (#6 at ef=1 per level),
    held against the index's own single-device general route on every
    query; both timed (host clock, one warm run, then one)."""
    import warnings

    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches
    from hnsw_itu_tpu_torch.parallel import knns_query_sharded
    from hnsw_itu_tpu_torch.utils import recall_at_k

    q = as_sketches(qs, dev)
    mesh = shard_mesh(dev, shards)
    fused, sample = index.fused, index.query_entry_sample
    out = {}
    for entry in (SAMPLE, 0):
        index.query_entry_sample = entry
        dma_beam_search.kernel_launches = dma_beam_search.plain_calls = 0
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            sh_ms, got = timed(lambda: knns_query_sharded(index, q, K, EF,
                                                          mesh=mesh))
        descent = (dma_beam_search.kernel_launches,
                   dma_beam_search.plain_calls)
        index.fused = None  # the single-device general route
        single_ms, want = timed(lambda: index.knns(q, K, EF))
        route = index.last_route
        index.fused = fused
        same = torch.equal(got.ids, want.ids) and torch.equal(got.dists,
                                                              want.dists)
        r10 = recall_at_k(got.ids.cpu().numpy(), gt_i, K)
        name = "sampled" if entry else "descent"
        out[name] = {"sharded_ms": sh_ms, "single_general_ms": single_ms,
                     "equal": same, "recall": r10,
                     "dma_launches": descent[0],
                     "warned": len(warned)}
        log(f"[17c] knns_query_sharded k={K} ef={EF} on {shards} shards of "
            f"the card, {name} entry: {sh_ms:.1f} ms; the single-device "
            f"general route ({route}) {single_ms:.1f} ms; dists and ids "
            f"{'equal' if same else 'DIFFERENT'} on all {len(qs)} queries; "
            f"recall@10 {r10:.4f}; #6 launches {descent[0]}, plain "
            f"{descent[1]}; {len(warned)} warning(s): "
            f"{str(warned[0].message)[:60] if warned else ''}")
        if not same or route != "general" or descent[1] or (
                entry == 0 and descent[0] <= 0):
            raise AssertionError(f"query sharding, {name} entry: {out}")
    index.query_entry_sample = sample
    if not np.isfinite(out["sampled"]["recall"]):
        raise AssertionError("query sharding recall")
    return out


def phase_shard_independence(dev, shards):
    """Phase 17 (b): a ``shards``-shard build of INDEP_N points a shard on
    the one card equals, shard by shard, a 1-shard build of that shard's
    rows (adj, deg, ns, drops)."""
    import torch

    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.parallel import ShardedHNSW
    from hnsw_itu_tpu_torch.utils import make_dataset

    n = INDEP_N * shards
    pts, _ = make_dataset(1, n, 1)
    t0 = time.perf_counter()
    idx = ShardedHNSW.build(pts, IndexOptions(size=n, **SHARD_OPTS),
                            mesh=shard_mesh(dev, shards))
    sync_cards()
    multi_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for s in range(shards):
        one = ShardedHNSW.build(
            pts[s * INDEP_N : (s + 1) * INDEP_N],
            IndexOptions(size=INDEP_N, **SHARD_OPTS),
            mesh=shard_mesh(dev, 1))
        same = (torch.equal(one.adj_s[0], idx.adj_s[s])
                and torch.equal(one.deg_s[0], idx.deg_s[s])
                and one.ns.tolist() == [int(idx.ns[s])]
                and int(one.edge_drops_s[0]) == int(idx.edge_drops_s[s]))
        if not same:
            raise AssertionError(f"shard {s} of the {shards}-shard build != "
                                 "a 1-shard build of its rows")
    sync_cards()
    single_s = time.perf_counter() - t0
    log(f"[17b] {shards} x {INDEP_N} points: the {shards}-shard build on "
        f"one card ({multi_s:.1f} s) equals, shard by shard, 1-shard builds "
        f"of the same rows ({single_s:.1f} s for all {shards}): adj, deg, "
        f"ns, edge drops {[int(d) for d in idx.edge_drops_s]}")
    return {"shard_n": INDEP_N, "multi_s": multi_s, "single_s": single_s,
            "equal": True}


def phase_sharded(shards, shard_n, nq, dev, smi, mini_ref):
    """Phase 17 (a): ShardedHNSW over ``shards`` x ``shard_n`` points on
    ``shards`` shards of the one card; the oracle; one fused table a
    shard; the ef sweep on the fused route (kernel #1 once per shard per
    call) against the 0.93 gate; every shard's kernel launch against its
    plain version at the headline ef; the merge against a numpy two-key
    merge; the general route beside it."""
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
    from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
    from hnsw_itu_tpu_torch.ops.hamming import hamming_block
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches
    from hnsw_itu_tpu_torch.parallel import ShardedHNSW
    from hnsw_itu_tpu_torch.parallel.sharded import _merge
    from hnsw_itu_tpu_torch.utils import make_dataset, recall_at_k

    n = shards * shard_n
    t0 = time.perf_counter()
    pts, qs = make_dataset(0, n, nq)
    log(f"[17] make_dataset(0, {n}, {nq}): {time.perf_counter() - t0:.1f} s")
    opts = IndexOptions(size=n, **SHARD_OPTS)
    for f in (dma_beam_search, hamming_block):
        f.kernel_launches = f.plain_calls = 0
    t0 = time.perf_counter()
    idx = ShardedHNSW.build(pts, opts, mesh=shard_mesh(dev, shards))
    sync_cards()
    build_s = time.perf_counter() - t0
    rec = {"n": n, "shards": shards, "build_s": build_s,
           "ns": idx.ns.tolist(),
           "edge_drops": [int(d) for d in idx.edge_drops_s],
           "dma_launches": dma_beam_search.kernel_launches,
           "dma_plain": dma_beam_search.plain_calls,
           "ham_launches": hamming_block.kernel_launches,
           "ham_plain": hamming_block.plain_calls}
    log(f"[17] ShardedHNSW.build of {n} points on {shards} shards of one "
        f"card ({opts}): {build_s:.1f} s (host clock, synchronized); ns "
        f"{rec['ns']}, edge drops {rec['edge_drops']}; #6 launches "
        f"{rec['dma_launches']} (plain {rec['dma_plain']}), #7 launches "
        f"{rec['ham_launches']} (plain {rec['ham_plain']})")
    if min(rec["dma_launches"], rec["ham_launches"]) <= 0 or \
            rec["dma_plain"] or rec["ham_plain"]:
        raise AssertionError(f"sharded build did not run on the kernels: "
                             f"{rec}")
    gt_i = phase_oracle(pts, qs, dev, tag="17")
    del pts
    t0 = time.perf_counter()
    idx.enable_inline()
    sync_cards()
    if idx.fused_s is None or len(idx.fused_s) != shards:
        raise AssertionError("the fused tables were not built")
    rec["table_bytes"] = sum((t.ids.numel() + t.data.numel()) * 4
                             for t in idx.fused_s)
    log(f"[17] {shards} fused tables {tuple(idx.fused_s[0].data.shape)}: "
        f"{rec['table_bytes'] / 1e9:.3f} GB in all, built in "
        f"{time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated")

    # the main path: knns on the fused route, counts zeroed just before
    q = as_sketches(qs, dev)
    fused_beam_search.kernel_launches = fused_beam_search.plain_calls = 0
    for ef in SHARD_EFS:  # one warm call at every ef before any is timed
        idx.knns(q, K, ef)
    sweep, results = {}, {}
    for ef in SHARD_EFS:
        best, res = best_of_3(lambda ef=ef: idx.knns(q, K, ef))
        ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
        if ids.shape != (nq, K) or not ((ids >= 0) & (ids < n)).all() or \
                not (np.diff(dists, axis=1) >= 0).all():
            raise AssertionError(f"bad sharded result at ef={ef}")
        r10 = recall_at_k(ids, gt_i, K)
        sweep[ef] = {"knns_ms": best * 1e3, "recall": r10,
                     "route": idx.last_route}
        results[ef] = res
        log(f"[17] knns k={K} ef={ef} (max_steps "
            f"{idx.shards[0]._steps_cap(ef)}, "
            f"sampled entry {idx.query_entry_sample} a shard), route "
            f"{idx.last_route}: best of 3 {best * 1e3:.2f} ms for {nq} "
            f"queries = {nq / best:,.0f} QPS, recall@10 {r10:.4f}")
    launches = fused_beam_search.kernel_launches
    plain = fused_beam_search.plain_calls
    calls = 5 * len(SHARD_EFS)  # the warm call, best_of_3's four
    log(f"[17] fused kernel launches {launches} in {calls} knns calls "
        f"({shards} shards), plain_calls {plain}")
    if launches != shards * calls or plain:
        raise AssertionError(f"fused sharded launches {launches}, plain "
                             f"{plain}, for {calls} calls")
    passing = [ef for ef in SHARD_EFS if sweep[ef]["recall"] >= RECALL_GATE]
    if not passing:
        raise AssertionError(f"no ef <= 128 reaches recall@10 "
                             f"{RECALL_GATE}: {sweep}")
    ef_h = passing[0]
    rec.update(launches=launches, calls=calls, sweep=sweep, ef=ef_h)
    log(f"[17] headline: ef={ef_h}, the smallest ef meeting the "
        f"{RECALL_GATE} gate; beside it phase 7's single-card mini path on "
        f"2.2M: recall@10 {mini_ref['recall']:.4f}, knns "
        f"{mini_ref['knns_ms']:.2f} ms at ef={EF}")

    # every shard's launch against its plain version at the headline ef
    steps = idx.shards[0]._steps_cap(ef_h)
    rec["kernel"] = []
    for s in range(shards):
        r = fused_at_served_shapes(idx.shards[s], qs, dev, smi,
                                   max_steps=steps,
                                   tag=f"17 shard {s}", ef=ef_h)
        r["entry_ms"] = cuda_ms(r.pop("entry"), 10)
        rec["kernel"].append(r)

    # the merge: the device merge against a numpy two-key merge
    parts = [idx._shard_topk(s, q, K, ef_h, "fused") for s in range(shards)]
    d_np = np.concatenate([p[0].cpu().numpy() for p in parts], axis=1)
    i_np = np.concatenate([p[1].cpu().numpy() for p in parts], axis=1)
    o = np.lexsort((i_np, d_np), axis=1)[:, :K]
    res = results[ef_h]
    merge_equal = (
        np.array_equal(res.dists.cpu().numpy(),
                       np.take_along_axis(d_np, o, axis=1))
        and np.array_equal(res.ids.cpu().numpy(),
                           np.take_along_axis(i_np, o, axis=1)))
    merge_ms = cuda_ms(lambda: _merge(parts, K, dev), 10)
    total_ms, top = device_breakdown(lambda: idx.knns(q, K, ef_h))
    rec.update(merge_equal=merge_equal, merge_ms=merge_ms,
               device_ms=total_ms, device_top=top)
    log(f"[17] on {smi}: merge of {shards} x [{nq}, {K}] "
        f"{'equals' if merge_equal else 'DIFFERS FROM'} the numpy two-key "
        f"merge; merge {merge_ms:.3f} ms; per shard: entry "
        + ", ".join(f"{r['entry_ms']:.3f}" for r in rec["kernel"])
        + " ms, #1 " + ", ".join(f"{r['ms']:.3f}" for r in rec["kernel"])
        + " ms (bound " + ", ".join(f"{r['bound_ms']:.3f}"
                                    for r in rec["kernel"])
        + f" ms); one knns {total_ms:.3f} ms of device time: "
        + ", ".join(f"{k[:40]} {v:.3f}" for k, v in top))
    if not merge_equal:
        raise AssertionError("the sharded merge != the numpy merge")

    # the general route beside it, on GENERAL_Q queries
    fused_s = idx.fused_s
    for sh in idx.shards:
        sh.fused = None
    g_ms, g = best_of_3(lambda: idx.knns(q[:GENERAL_Q], K, ef_h))
    g_route = idx.last_route
    for sh, t in zip(idx.shards, fused_s):
        sh.fused = t
    g_ids = g.ids.cpu().numpy()
    agree = float((g_ids[:, 0] == res.ids[:GENERAL_Q, 0].cpu().numpy())
                  .mean())
    rec["general"] = {"queries": len(g_ids), "knns_ms": g_ms * 1e3,
                      "recall": recall_at_k(g_ids, gt_i[:GENERAL_Q], K),
                      "top1_agree": agree}
    log(f"[17] general route ({g_route}) on {len(g_ids)} queries at "
        f"ef={ef_h}: {g_ms * 1e3:.1f} ms, recall@10 "
        f"{rec['general']['recall']:.4f}; ids[:, 0] equal to the fused "
        f"route's on {agree:.4f} of the queries")
    if g_route != "general":
        raise AssertionError(f"general route ran {g_route}")
    del idx, fused_s, parts, results, res, g
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def log_free(tag, what, dev):
    """Log the card's free and total bytes (the driver's count) and what
    PyTorch's allocator holds."""
    import torch

    free, total = torch.cuda.mem_get_info(dev)
    log(f"[{tag}] card memory {what}: {free / 1e9:.3f} GB free of "
        f"{total / 1e9:.3f} GB, PyTorch allocated "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB, reserved "
        f"{torch.cuda.memory_reserved(dev) / 1e9:.3f} GB")
    return free, total


def flagship_build_kernels(index, pts, dev, smi):
    """#6 and #7 at one of the 10M build's chunks: the data's last
    ``batch_size * 16`` points (the build's last chunk) searched over the
    finished base layer at ef = efc from the sampled entry, and the select
    block of their beams (``chunk_kernels``)."""
    from hnsw_itu_tpu_torch.ops.entry import sampled_entry
    from hnsw_itu_tpu_torch.ops.metrics import HAMMING, as_sketches

    import torch

    B = FLAGSHIP_OPTS["batch_size"] * 16
    q = as_sketches(pts[len(pts) - B:], dev)
    eps = sampled_entry(index.points, q, index.n,
                        sample_size=FLAGSHIP_OPTS["entry_sample"],
                        metric=HAMMING)
    rec = chunk_kernels(index.base.adj, index.points, q, eps,
                        FLAGSHIP_OPTS["ef_construction"], smi, "18",
                        f"a {index.n}-point build chunk")
    # the sampled entry at the 10M cell's shape (a query batch against the
    # 1024-point sample) and at the 65,536-point sample
    rec["entry"] = {str(es): entry_vs_plain(
        index.points, q[:FLAGSHIP_QUERY_BATCH], index.n, es, smi, "18")
        for es in (FLAGSHIP_OPTS["entry_sample"], MINI_WIDE_SAMPLE)}
    torch.cuda.empty_cache()
    return rec


def chunk_kernels(adj, points, q, eps, efc, smi, tag, what):
    """#6 and #7 at one build chunk, on the current card: the rows ``q``
    searched over the finished graph ``adj`` at ef = ``efc`` from
    ``eps``, and the select block of their beams; each against its plain
    version and timed with its bound (#7 also beside the ``pairwise_mxu``
    route, its library call)."""
    import torch

    from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
    from hnsw_itu_tpu_torch.ops.metrics import popcount_sum
    from hnsw_itu_tpu_torch.ops.mini_search import IINF
    from hnsw_itu_tpu_torch.ops.search import beam_search_gather

    B = q.shape[0]
    W, words = adj.shape[1], points.shape[1]
    d0 = popcount_sum(points[eps.long()] ^ q)
    kw = dict(ef=efc, max_steps=2048)  # search_select's expansion bound
    err, (keys, vis, stp) = gather_vs_plain(adj, points, None, q, d0, eps,
                                            **kw)
    if err:
        raise AssertionError(f"gather kernel != plain at {what}")
    k6 = cuda_ms(lambda: dma_beam_search(adj, points, None, q, d0, eps, **kw),
                 5)
    p6 = cuda_ms(lambda: beam_search_gather(adj, points, None, q, d0, eps,
                                            **kw), 1)
    rows, fresh = int(stp.long().sum()), int(vis.long().sum()) - B
    b6 = bound_ms(gather_bytes(rows, fresh, B, W, words, efc))
    log(f"[{tag}] on {smi}: gather kernel at {what} ({B} searches, "
        f"ef={efc}): {k6:.3f} ms, plain {p6:.3f} ms, bound {b6:.4f} ms "
        f"({rows / B:.2f} steps/q, {(fresh + B) / B:.1f} visited/q); kernel "
        f"vs plain max |diff| {err}")
    bi = (keys & 0xFFFFFFFF).to(torch.int32)
    cand = points[torch.where(bi < IINF, bi, 0).long()].contiguous()
    ham = hamming_vs_plain(cand, f"select, {what}", smi, tag)
    return {"dma": {"max_abs_err": err, "ms": k6, "plain_ms": p6,
                    "bound_ms": b6, "searches": B, "ef": efc,
                    "steps_q": rows / B, "visited_q": (fresh + B) / B},
            "ham": ham}


def flagship_point(index, q, gt_i, gt_d, smi, point, tag):
    """One plan point on the index's mini table: knns at k=10 over every
    query (``point`` = (ef, hop, entry sample, max_steps)), best of 3 warm
    calls, recall@10 and tie-tolerant recall, the mini kernel's launches
    in those calls (plain calls must be 0); then, apart from the counted
    calls, the three parts of a call at its shapes timed by CUDA events:
    the sampled entry, the mini kernel (with its ids-first bound) and the
    rerank. Returns (record, the kernel's inputs for an exactness check)."""
    import numpy as np

    from hnsw_itu_tpu_torch.ops.entry import sampled_entry
    from hnsw_itu_tpu_torch.ops.metrics import HAMMING
    from hnsw_itu_tpu_torch.ops.mini_search import (mini_beam_search,
                                                    rerank_exact,
                                                    rerank_onehop)
    from hnsw_itu_tpu_torch.utils import recall_at_k, recall_tie_tolerant

    rerank = rerank_onehop if point[1] else rerank_exact

    ef, hop, es, cap = point
    index.query_hop, index.query_entry_sample, index.max_steps = hop, es, cap
    nq, steps = q.shape[0], index._steps_cap(ef)
    table, W, mw = index.mini, index.mini_W, index.mini_words
    # the main path: knns on the mini route, counts zeroed just before
    for f in (mini_beam_search, rerank):
        f.kernel_launches = f.plain_calls = 0
    best, res = best_of_3(lambda: index.knns(q, K, ef))
    launches = mini_beam_search.kernel_launches
    plain = mini_beam_search.plain_calls + rerank.plain_calls
    calls = 4 * -(-nq // index.query_batch)  # best_of_3: a warm call + 3
    if index.last_route != "mini" or launches != calls \
            or rerank.kernel_launches != calls or plain:
        raise AssertionError(f"[{tag}] {point}: route {index.last_route}, "
                             f"launches {launches} and "
                             f"{rerank.kernel_launches}, plain calls "
                             f"{plain}")
    ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
    if ids.shape != (nq, K) or not ((ids >= 0) & (ids < index.n)).all() \
            or not (np.diff(dists, axis=1) >= 0).all():
        raise AssertionError(f"[{tag}] bad result at {point}")
    rec = recall_at_k(ids, gt_i, K)
    rtt = recall_tie_tolerant(dists, gt_d, K)
    vis_q = index.last_stats["visited"] / nq
    steps_q = index.last_stats["steps"] / nq
    # the parts of one call at its shapes, outside the counted calls
    pts, adj = index.points, index._base().adj
    entry_ms = cuda_ms(lambda: sampled_entry(pts, q, index.n, sample_size=es,
                                             metric=HAMMING), 3)
    qs_o, d0, eps = mini_seeds(pts, q, index.n, mw, 1, sample=es)
    kw = dict(ef=max(ef, K), mini_words=mw, max_steps=steps)
    _, beam, vis, stp = mini_beam_search(table, qs_o, d0, eps, **kw)
    k_ms = cuda_ms(lambda: mini_beam_search(table, qs_o, d0, eps, **kw), 3)
    b_ms = bound_ms(mini_ids_first_bytes(
        int(stp.long().sum()), int(vis.long().sum()) - nq, nq, W, mw,
        kw["ef"]))
    r = rerank_vs_plain(pts, adj, qs_o, beam, k=K, seeds=hop, smi=smi,
                        tag=tag)
    r_ms = r["ms"]
    out = {"ef": ef, "hop": hop, "entry_sample": es, "max_steps": steps,
           "knns_ms": best * 1e3, "qps": nq / best, "recall": rec,
           "tie_tolerant": rtt, "visited_q": vis_q, "steps_q": steps_q,
           "launches": launches, "plain_calls": plain, "entry_ms": entry_ms,
           "ms": k_ms, "bound_ms": b_ms, "rerank_ms": r_ms,
           "rerank_plain_ms": r["plain_ms"],
           "rerank_bound_ms": r["bound_ms"]}
    log(f"[{tag}] on {smi}: ef={ef} hop={hop} es={es} max_steps={steps}: "
        f"route {index.last_route}, best of 3 {best * 1e3:.2f} ms for {nq} "
        f"queries = {nq / best:,.0f} QPS, recall@10 {rec:.4f} (tie-tolerant "
        f"{rtt:.4f}), visited/q {vis_q:.1f}, steps/q {steps_q:.2f}, mini "
        f"kernel launches {launches}, plain_calls {plain}; parts by CUDA "
        f"events: entry {entry_ms:.3f} ms, mini kernel {k_ms:.3f} ms (bound "
        f"{b_ms:.3f} ms), rerank {r_ms:.3f} ms")
    return out, (qs_o, d0, eps, kw)


def flagship_table(index, q, gt_i, gt_d, dev, smi, plan, *, budget, tag):
    """Build one mini table on the 10M index (the policy's pick from the
    card's free memory when ``budget`` is None, else ``_mini_config_for``
    at that byte budget), log its pick, bytes, seconds and the card's
    memory share, run every plan point, and hold the mini kernel against
    its plain version on every query at the headline point: the fastest
    with recall@10 >= the gate, else the most recall."""
    import torch

    from hnsw_itu_tpu_torch.models.nsw import _mini_config_for
    from hnsw_itu_tpu_torch.ops.mini_search import (materialize_mini,
                                                    mini_beam_search_plain)

    log_free(tag, "before the table", dev)
    t0 = time.perf_counter()
    if budget is None:
        index.enable_inline()
    else:
        adj = index._base().adj
        W, mw = _mini_config_for(index.points, adj, index.metric,
                                 budget_bytes=budget)
        index.mini = materialize_mini(index.points, adj[:, :W],
                                      mini_words=mw)
        index.mini_words, index.mini_W = mw, W
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if index.fused is not None or index.mini is None:
        raise AssertionError(f"[{tag}] no mini table")
    W, mw = index.mini_W, index.mini_words
    gb = index.mini.numel() * 4 / 1e9
    free, total = log_free(tag, "with the table", dev)
    share = (total - free) / total
    src = "the policy" if budget is None else f"budget {budget:.3e} B"
    log(f"[{tag}] mini table ({src}): W={W}, mini_words={mw}, "
        f"{tuple(index.mini.shape)} int32 = {gb:.3f} GB, built in "
        f"{secs:.2f} s; the card is {100 * share:.1f}% in use")
    runs = [flagship_point(index, q, gt_i, gt_d, smi, p, tag) for p in plan]
    recs = [r for r, _ in runs]
    met = [r for r in recs if r["recall"] >= RECALL_GATE]
    head = max(met, key=lambda r: r["qps"]) if met else \
        max(recs, key=lambda r: r["recall"])
    qs_o, d0, eps, kw = runs[recs.index(head)][1]
    st = {}
    err, got = mini_vs_plain(index.mini, qs_o, d0, eps, stats=st, **{
        k: v for k, v in kw.items() if k != "mini_words"})
    whole = mini_bytes(st, got[2], q.shape[0], W, mw, kw["ef"])[0]
    p_ms = cuda_ms(lambda: mini_beam_search_plain(index.mini, qs_o, d0, eps,
                                                  **kw), 1)
    head.update(max_abs_err=err, plain_ms=p_ms,
                bound_whole_rows_ms=bound_ms(whole))
    log(f"[{tag}] headline ef={head['ef']} hop={head['hop']} "
        f"es={head['entry_sample']}: mini kernel vs plain on all "
        f"{q.shape[0]} queries max |diff| {err} over d, ids, visited, steps; "
        f"on {smi}: kernel {head['ms']:.3f} ms, plain {p_ms:.3f} ms "
        f"(whole-row bound {bound_ms(whole):.3f} ms)")
    if err:
        raise AssertionError(f"[{tag}] mini kernel != plain at 10M")
    return {"W": W, "mini_words": mw, "table_gb": gb, "seconds": secs,
            "memory_share": share, "budget": budget, "headline": head,
            "points": recs}


def phase_flagship(n, nq, dev, smi):
    """Phase 18: the JAX 10M runner's configuration on the card."""
    import torch

    from hnsw_itu_tpu_torch.ops.metrics import as_sketches
    from hnsw_itu_tpu_torch.utils import recall_at_k, recall_tie_tolerant

    log_free("18", "before the build", dev)
    pts, qs, index, build = phase_device_build(n, nq, dev, tag="18",
                                               opts=FLAGSHIP_OPTS)
    kern = flagship_build_kernels(index, pts, dev, smi)
    t0 = time.perf_counter()
    gt_i, gt_d = phase_oracle(pts, qs, dev, tag="18", with_dists=True)
    build["oracle_s"] = time.perf_counter() - t0
    del pts
    gc.collect()
    torch.cuda.empty_cache()

    # the runner's attribution: the general route (exact distances), ef=64
    # on its 2048 queries, at two entry samples
    q = as_sketches(qs, dev)
    index.query_batch = FLAGSHIP_QUERY_BATCH
    index.query_dedup = "beam"  # run_10m.py:247: no [B, N] bitmask at 10M
    attrib = {}
    G = min(FLAGSHIP_GT_Q, nq)
    for es in (SAMPLE, MINI_WIDE_SAMPLE):
        index.query_entry_sample = es
        t0 = time.perf_counter()
        res = index.knns(q[:G], K, 64)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if index.last_route != "general":
            raise AssertionError(f"attribution ran on {index.last_route}")
        ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
        attrib[es] = {"recall": recall_at_k(ids, gt_i[:G], K),
                      "tie_tolerant": recall_tie_tolerant(dists, gt_d[:G], K),
                      "seconds": secs}
        log(f"[18] attribution, the general route (exact distances), ef=64, "
            f"es={es}, {G} queries: recall@10 {attrib[es]['recall']:.4f} "
            f"(tie-tolerant {attrib[es]['tie_tolerant']:.4f}), {secs:.2f} s")

    policy = flagship_table(index, q, gt_i, gt_d, dev, smi,
                            FLAGSHIP_PLAN + [FLAGSHIP_JAX_POINT], budget=None,
                            tag="18")
    if policy["headline"]["recall"] < RECALL_GATE:
        raise AssertionError(f"[18] no plan point reaches recall@10 "
                             f"{RECALL_GATE}")
    index.mini = None
    gc.collect()
    torch.cuda.empty_cache()
    jax_table = flagship_table(index, q, gt_i, gt_d, dev, smi,
                               [FLAGSHIP_JAX_POINT], budget=JAX_TABLE_BUDGET,
                               tag="18, JAX budget")
    r = jax_table["points"][0]
    log(f"[18] the JAX budget's table (W={jax_table['W']}, mini_words="
        f"{jax_table['mini_words']}) at the JAX record's point: recall@10 "
        f"{r['recall']:.4f} (the policy's W={policy['W']}, mini_words="
        f"{policy['mini_words']}: {policy['points'][-1]['recall']:.4f}; the "
        "JAX record, benches/results_10m.json: 0.931)")
    return {"build": build, "kernels": kern, "attribution": attrib,
            "policy": policy, "jax_budget": jax_table}


def card_mesh(cards, shards):
    """A mesh of ``shards`` entries over the first ``cards`` cards, each
    card holding ``shards / cards`` contiguous shards."""
    from hnsw_itu_tpu_torch.parallel import make_mesh

    return make_mesh(devices=[f"cuda:{s * cards // shards}"
                              for s in range(shards)])


def same_shards(a, b) -> bool:
    """Two sharded builds equal shard by shard: adj, deg, ns, drops."""
    import torch

    return (a.ns.tolist() == b.ns.tolist()
            and [int(d) for d in a.edge_drops_s]
            == [int(d) for d in b.edge_drops_s]
            and all(torch.equal(x.cpu(), y.cpu())
                    for x, y in zip(a.adj_s + a.deg_s, b.adj_s + b.deg_s)))


def caller_knns(idx, q, k, ef):
    """``idx.knns`` as a mesh of one device runs it: every shard's
    ``_shard_topk`` issued from this process in turn, then the merge (the
    loop the workers replace on a mesh of several cards)."""
    from hnsw_itu_tpu_torch.models.base import KnnResult
    from hnsw_itu_tpu_torch.parallel import replicate
    from hnsw_itu_tpu_torch.parallel.sharded import _merge

    route = idx.route(k, ef)
    qs = replicate(idx.mesh, q)
    return KnnResult(*_merge([idx._shard_topk(s, qs[s], k, ef, route)
                              for s in range(idx.mesh.size)], k,
                             idx.mesh.devices[0]))


def pool_ms_text(ms) -> str:
    """A ``CardPool.last_ms`` record as text: the call's host ms, and of
    them the caller's pickling and card syncs and each worker's unpickling,
    job and clean-up."""
    w = ms["workers"]
    return (f"the pool's call {ms['call']:.2f} ms: pickling {ms['dump']:.2f}, "
            f"the caller's card syncs {ms['sync']:.2f}; each worker's "
            "unpickling " + ", ".join(f"{x['load']:.2f}" for x in w)
            + ", job " + ", ".join(f"{x['job']:.2f}" for x in w)
            + ", clean-up " + ", ".join(f"{x['clean']:.2f}" for x in w)
            + " ms")


def card_shard_ms(idx, q, k, ef, reps=10):
    """Each card's device milliseconds for its shards' part of ``knns``
    (entry and search, ``_shard_topk``), by CUDA events on the card over
    ``reps`` back-to-back calls from this process, summed over the card's
    shards: {device: ms}."""
    import torch

    from hnsw_itu_tpu_torch.parallel import replicate

    route = idx.route(k, ef)
    qs = replicate(idx.mesh, q)
    out = {}
    for s, dev in enumerate(idx.mesh.devices):
        with torch.cuda.device(dev):
            ms = cuda_ms(lambda s=s: idx._shard_topk(s, qs[s], k, ef, route),
                         reps)
        out[str(dev)] = out.get(str(dev), 0.0) + ms
    return out


def workers_vs_caller(idx, q, k, ef, tag, smi):
    """``idx.knns`` (each card's shards in its worker) against
    ``caller_knns`` on the same mesh: ids and dists equal on every query
    (raises otherwise); both best of 3 (host clock, every card
    synchronized); the pool's timings of the last call on the workers;
    each card's device ms; the busy share, the busiest card's device ms
    over the workers' call. Returns the record."""
    import torch

    best_w, got = best_of_3(lambda: idx.knns(q, k, ef))
    last = idx._pool.last_ms
    best_c, want = best_of_3(lambda: caller_knns(idx, q, k, ef))
    dev_ms = card_shard_ms(idx, q, k, ef)
    r = {"ef": ef, "workers_ms": best_w * 1e3, "caller_ms": best_c * 1e3,
         "pool_ms": last, "card_device_ms": dev_ms,
         "busy_share": max(dev_ms.values()) / (best_w * 1e3),
         "pids": idx._pool.pids,
         "equal": torch.equal(got.ids, want.ids)
         and torch.equal(got.dists, want.dists)}
    log(f"[{tag}] on {smi}: knns k={k} ef={ef} on the workers "
        f"{r['workers_ms']:.2f} ms, the caller's loop on the same mesh "
        f"{r['caller_ms']:.2f} ms (best of 3 each); in the last call "
        + pool_ms_text(last) + "; each card's device "
        + ", ".join(f"{d} {m:.3f}" for d, m in dev_ms.items())
        + f" ms; busy share {r['busy_share']:.2f}; ids and dists "
        f"{'equal' if r['equal'] else 'DIFFERENT'} on all {q.shape[0]} "
        "queries")
    if not r["equal"]:
        raise AssertionError(f"[{tag}] knns on the workers != the caller's "
                             f"loop at ef={ef}")
    return r


def phase_overlap(shard_n, nq, cards, smi):
    """Phase 19a: ShardedHNSW.build of ``cards`` x ``shard_n`` points at
    SHARD_OPTS on a mesh naming card 0 ``cards`` times and on a mesh of
    ``cards`` cards, in the order one, four, four, one; every build equal
    shard by shard to the first; host seconds and the CUDA-event build
    spans per card; then enable_inline and knns at k=10, ef=32 on both
    meshes: ids and dists equal, both timed; the four-card index's knns
    (on its workers) against the caller's loop (``workers_vs_caller``)."""
    import torch

    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
    from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
    from hnsw_itu_tpu_torch.ops.hamming import hamming_block
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches
    from hnsw_itu_tpu_torch.parallel import ShardedHNSW, make_mesh
    from hnsw_itu_tpu_torch.utils import make_dataset

    n = cards * shard_n
    t0 = time.perf_counter()
    pts, qs = make_dataset(0, n, nq)
    log(f"[19a] make_dataset(0, {n}, {nq}): {time.perf_counter() - t0:.1f} s")
    meshes = {"one": make_mesh(devices=["cuda:0"] * cards),
              "cards": make_mesh(cards)}
    where = {"one": f"card 0 {cards} times", "cards": f"{cards} cards"}
    opts = IndexOptions(size=n, **SHARD_OPTS)
    # warmed before timing: this process's context on every card, card
    # 0's allocator, and the fork server the four-card build's workers
    # come from (started once a process; its first use timed apart)
    for d in set(meshes["cards"].devices):
        torch.zeros(1, device=d)
    warm = pts[: cards * 2048]
    first = {}
    for name, mesh in meshes.items():
        t0 = time.perf_counter()
        ShardedHNSW.build(warm, IndexOptions(size=len(warm), **SHARD_OPTS),
                          mesh=mesh)
        sync_cards()
        first[name] = time.perf_counter() - t0
    log(f"[19a] first use, {len(warm)} points: {first['one']:.2f} s on "
        f"{where['one']}, {first['cards']:.2f} s on {where['cards']} (the "
        "fork server's start included)")
    rec = {"n": n, "cards": cards, "builds": [], "first_use_s": first}
    kept = {}
    for name in ("one", "cards", "cards", "one"):
        for f in (dma_beam_search, hamming_block):
            f.kernel_launches = f.plain_calls = 0
        timings = {}
        sync_cards()
        t0 = time.perf_counter()
        idx = ShardedHNSW.build(pts, opts, mesh=meshes[name],
                                timings=timings)
        sync_cards()
        secs = time.perf_counter() - t0
        spans = {str(d): t for d, t in timings.items()}
        b = {"mesh": name, "build_s": secs, "spans_ms": spans,
             "dma_launches": dma_beam_search.kernel_launches,
             "dma_plain": dma_beam_search.plain_calls,
             "ham_launches": hamming_block.kernel_launches,
             "ham_plain": hamming_block.plain_calls}
        ref = kept.setdefault("ref", idx)
        b["equal"] = idx is ref or same_shards(idx, ref)
        kept.setdefault(name, idx)
        rec["builds"].append(b)
        log(f"[19a] ShardedHNSW.build of {n} points on {where[name]}: "
            f"{secs:.2f} s (host clock, every card synchronized); ns "
            f"{idx.ns.tolist()}, edge drops "
            f"{[int(d) for d in idx.edge_drops_s]}; #6 launches "
            f"{b['dma_launches']} (plain {b['dma_plain']}), #7 launches "
            f"{b['ham_launches']} (plain {b['ham_plain']}); "
            + ("equal to the first build shard by shard" if b["equal"]
               else "DIFFERENT from the first build"))
        for d, sp in spans.items():
            log(f"[19a]   CUDA-event spans on {d}: "
                + ", ".join(f"{k} {v:.1f} ms" for k, v in sp.items()))
        if not b["equal"] or b["dma_plain"] or b["ham_plain"] or min(
                b["dma_launches"], b["ham_launches"]) <= 0:
            raise AssertionError(f"[19a] build on mesh {name}: {b}")
        del idx
    one = [b["build_s"] for b in rec["builds"] if b["mesh"] == "one"]
    many = [b for b in rec["builds"] if b["mesh"] == "cards"]
    # the longest card's own build, inside its worker: the rest of the
    # four-card time is this process's uploads and the workers' start
    work = [max(sp["wall"] for sp in b["spans_ms"].values()) / 1e3
            for b in many]
    many = [b["build_s"] for b in many]
    rec.update(ratio=sum(one) / sum(many), workers_build_s=work,
               ratio_in_workers=sum(one) / sum(work))
    log(f"[19a] on {smi}: build {sum(one) / 2:.2f} s on one card, "
        f"{sum(many) / 2:.2f} s on {cards} cards (means of two each): "
        f"{rec['ratio']:.2f}x; inside the workers the longest card took "
        f"{sum(work) / 2:.2f} s ({rec['ratio_in_workers']:.2f}x); the "
        f"uploads and the workers' start {(sum(many) - sum(work)) / 2:.2f}"
        " s")

    q = as_sketches(qs, "cuda:0")
    res = {}
    for name in ("one", "cards"):
        idx = kept[name]
        idx.enable_inline()
        if idx.fused_s is None:
            raise AssertionError(f"[19a] no fused tables on mesh {name}")
        fused_beam_search.kernel_launches = fused_beam_search.plain_calls = 0
        best, res[name] = best_of_3(lambda: idx.knns(q, K, EF))
        rec[f"knns_ms_{name}"] = best * 1e3
        rec[f"fused_launches_{name}"] = fused_beam_search.kernel_launches
        if (fused_beam_search.plain_calls or idx.last_route != "fused"
                or fused_beam_search.kernel_launches != 4 * cards):
            raise AssertionError(f"[19a] knns on mesh {name}: route "
                                 f"{idx.last_route}, launches "
                                 f"{fused_beam_search.kernel_launches}")
    if kept["cards"]._pool.in_caller:
        raise AssertionError("[19a] the four-card index has no workers")
    rec["workers"] = workers_vs_caller(kept["cards"], q, K, EF, "19a", smi)
    rec["knns_equal"] = (torch.equal(res["one"].ids, res["cards"].ids)
                         and torch.equal(res["one"].dists,
                                         res["cards"].dists))
    log(f"[19a] on {smi}: knns k={K} ef={EF} (sampled entry {SAMPLE} a "
        f"shard, fused): best of 3 {rec['knns_ms_one']:.2f} ms on one card, "
        f"{rec['knns_ms_cards']:.2f} ms on {cards} cards; ids and dists "
        f"{'equal' if rec['knns_equal'] else 'DIFFERENT'} on all {nq} "
        "queries")
    if not rec["knns_equal"]:
        raise AssertionError("[19a] knns differs between the meshes")
    for x in kept.values():
        x.close()
    del kept, res, idx
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_query_cards(build_n, nq, cards, smi):
    """Phase 19b: knns_query_sharded at k=10, ef=32 over phase 9's
    ``build_n``-point device-built index on ``cards`` cards (each card's
    part in its worker of one ``CardPool``, kept across the calls), with
    the sampled entry and then the greedy descent: ids and dists equal to
    the same call on a mesh naming card 0 ``cards`` times (in this
    process), and to the index's own general route, on every query; all
    three timed, with the pool's timings; then the copies of the index to
    the other cards alone."""
    import torch

    from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches
    from hnsw_itu_tpu_torch.parallel import (knns_query_sharded, make_mesh,
                                             replicate)
    from hnsw_itu_tpu_torch.parallel.mesh import CardPool

    dev = torch.device("cuda", 0)
    _, qs, index, build = phase_device_build(build_n, nq, dev, tag="19b")
    q = as_sketches(qs, dev)
    meshes = {"cards": make_mesh(cards),
              "one": make_mesh(devices=[dev] * cards)}
    rec = {"n": build_n, "build": {k: build[k] for k in (
        "host_s", "device_s", "level_ns", "edge_drops")}}
    t0 = time.perf_counter()
    pool = CardPool(meshes["cards"])
    rec["pool_start_s"] = time.perf_counter() - t0
    pools = {"cards": pool, "one": None}
    for entry in (SAMPLE, 0):
        index.query_entry_sample = entry
        name = "sampled" if entry else "descent"
        r, got = {}, {}
        for m, mesh in meshes.items():
            dma_beam_search.kernel_launches = dma_beam_search.plain_calls = 0
            r[f"{m}_ms"], got[m] = timed(
                lambda mesh=mesh, p=pools[m]: knns_query_sharded(
                    index, q, K, EF, mesh=mesh, pool=p))
            r[f"{m}_dma_launches"] = dma_beam_search.kernel_launches
            if dma_beam_search.plain_calls or (
                    entry == 0 and dma_beam_search.kernel_launches <= 0):
                raise AssertionError(f"[19b] {name} descent on #6: {r}")
        r["pool_ms"] = pool.last_ms
        r["general_ms"], want = timed(lambda: index.knns(q, K, EF))
        route = index.last_route
        r["equal"] = all(torch.equal(g.ids, want.ids)
                         and torch.equal(g.dists, want.dists)
                         for g in got.values())
        rec[name] = r
        log(f"[19b] on {smi}: knns_query_sharded k={K} ef={EF}, {name} "
            f"entry: {r['cards_ms']:.1f} ms on {cards} cards, "
            f"{r['one_ms']:.1f} ms on card 0 {cards} times; the index's "
            f"general route ({route}) {r['general_ms']:.1f} ms; ids and "
            f"dists {'equal' if r['equal'] else 'DIFFERENT'} on all "
            f"{len(qs)} queries; #6 launches {r['cards_dma_launches']} / "
            f"{r['one_dma_launches']}; in the last four-card call "
            + pool_ms_text(r["pool_ms"]))
        if not r["equal"] or route != "general":
            raise AssertionError(f"[19b] query sharding, {name}: {r}")
    rec["pids"] = pool.pids
    pool.close()
    # the per-call copies of the index to the other cards, alone
    tensors = [index.points, index._base().adj] + [
        t for lv in index.levels
        for t in (lv.node_ids, lv.down, lv.graph.adj, lv.graph.deg)]
    rec["replicate_ms"], _ = timed(
        lambda: [replicate(meshes["cards"], t) for t in tensors])
    gb = sum(t.numel() * t.element_size() for t in tensors) / 1e9
    log(f"[19b] on {smi}: the copies of the index to the {cards - 1} other "
        f"cards ({gb:.3f} GB a card) take {rec['replicate_ms']:.1f} ms of "
        "each four-card call (host clock, synchronized)")
    log(f"[19b] the pool of {cards} workers started in "
        f"{rec['pool_start_s']:.2f} s and served every four-card call")
    del index, q, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_flagship_cards(n, nq, cards, smi):
    """Phase 19c: the JAX sharded runner's 16 x 632,512 points (n split in
    RUNNER_SHARDS) as one ShardedHNSW over ``cards`` cards, four
    contiguous shards a card; the build at SHARD_OPTS, the oracle,
    enable_inline, the ef sweep (each card's shards on its worker) against
    the 0.93 gate, every shard's #1 against its plain version at ef=32 on
    every query, the sweep against the caller's loop, the merge against
    numpy. Returns (record, (pts, qs, gt_i)) for 19d."""
    import numpy as np
    import torch

    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
    from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
    from hnsw_itu_tpu_torch.ops.hamming import hamming_block
    from hnsw_itu_tpu_torch.ops.metrics import as_sketches
    from hnsw_itu_tpu_torch.parallel import ShardedHNSW
    from hnsw_itu_tpu_torch.parallel.sharded import _merge
    from hnsw_itu_tpu_torch.utils import make_dataset, recall_at_k

    S = RUNNER_SHARDS
    t0 = time.perf_counter()
    pts, qs = make_dataset(0, n, nq)
    log(f"[19c] make_dataset(0, {n}, {nq}): {time.perf_counter() - t0:.1f} s")
    mesh = card_mesh(cards, S)
    opts = IndexOptions(size=n, **SHARD_OPTS)
    # the main path: counts zeroed just before the build, read after
    for f in (dma_beam_search, hamming_block):
        f.kernel_launches = f.plain_calls = 0
    timings = {}
    t0 = time.perf_counter()
    idx = ShardedHNSW.build(pts, opts, mesh=mesh, timings=timings)
    sync_cards()
    build_s = time.perf_counter() - t0
    rec = {"n": n, "shards": S, "cards": cards, "build_s": build_s,
           "ns": idx.ns.tolist(),
           "edge_drops": [int(d) for d in idx.edge_drops_s],
           "spans_ms": {str(d): t for d, t in timings.items()},
           "dma_launches": dma_beam_search.kernel_launches,
           "dma_plain": dma_beam_search.plain_calls,
           "ham_launches": hamming_block.kernel_launches,
           "ham_plain": hamming_block.plain_calls}
    log(f"[19c] ShardedHNSW.build of {n} points in {S} shards over {cards} "
        f"cards ({opts}): {build_s:.1f} s (host clock); ns {rec['ns']}; "
        f"edge drops {rec['edge_drops']}; #6 launches {rec['dma_launches']} "
        f"(plain {rec['dma_plain']}), #7 launches {rec['ham_launches']} "
        f"(plain {rec['ham_plain']})")
    for d, sp in rec["spans_ms"].items():
        log(f"[19c]   CUDA-event spans on {d}: "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in sp.items()))
    if min(rec["dma_launches"], rec["ham_launches"]) <= 0 or \
            rec["dma_plain"] or rec["ham_plain"]:
        raise AssertionError(f"[19c] build did not run on the kernels: {rec}")
    gt_i = phase_oracle(pts, qs, torch.device("cuda", 0), tag="19c")

    # #6 and #7 at one build chunk of the last card's last shard
    s = S - 1
    dev = mesh.devices[s]
    ns_last = int(idx.ns[s])
    rows = SHARD_OPTS["batch_size"]
    with torch.cuda.device(dev):
        chunk = idx.points_s[s][ns_last - rows : ns_last].contiguous()
        rec["chunk"] = chunk_kernels(
            idx.adj_s[s], idx.points_s[s], chunk,
            torch.zeros(rows, dtype=torch.int32, device=dev),
            SHARD_OPTS["ef_construction"], smi, "19c",
            f"shard {s}'s last {rows} rows on {dev}")

    t0 = time.perf_counter()
    idx.enable_inline()
    sync_cards()
    if idx.fused_s is None:
        raise AssertionError("[19c] the fused tables were not built")
    rec["table_gb_per_card"] = sum(
        (t.ids.numel() + t.data.numel()) * 4 for t in idx.fused_s) / 1e9 \
        / cards
    log(f"[19c] {S} fused tables, {rec['table_gb_per_card']:.3f} GB a card, "
        f"built in {time.perf_counter() - t0:.2f} s")
    for d in dict.fromkeys(mesh.devices):
        log_free("19c", f"of {d} with its tables", d)

    q = as_sketches(qs, "cuda:0")
    fused_beam_search.kernel_launches = fused_beam_search.plain_calls = 0
    for ef in FLAGSHIP_CARD_EFS:  # one warm call at every ef first
        idx.knns(q, K, ef)
    sweep, results = {}, {}
    for ef in FLAGSHIP_CARD_EFS:
        best, res = best_of_3(lambda ef=ef: idx.knns(q, K, ef))
        ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
        if ids.shape != (nq, K) or not ((ids >= 0) & (ids < n)).all() or \
                not (np.diff(dists, axis=1) >= 0).all():
            raise AssertionError(f"[19c] bad sharded result at ef={ef}")
        sweep[ef] = {"knns_ms": best * 1e3, "recall": recall_at_k(
            ids, gt_i, K), "route": idx.last_route}
        results[ef] = res
        log(f"[19c] on {smi}: knns k={K} ef={ef} (max_steps "
            f"{idx.shards[0]._steps_cap(ef)}, sampled entry "
            f"{idx.query_entry_sample} "
            f"a shard), route {idx.last_route}: best of 3 "
            f"{best * 1e3:.2f} ms for {nq} queries = {nq / best:,.0f} QPS, "
            f"recall@10 {sweep[ef]['recall']:.4f}")
    calls = 5 * len(FLAGSHIP_CARD_EFS)  # the warm call, best_of_3's four
    rec.update(fused_launches=fused_beam_search.kernel_launches,
               fused_plain=fused_beam_search.plain_calls, calls=calls,
               sweep=sweep)
    log(f"[19c] fused kernel launches {rec['fused_launches']} in {calls} "
        f"knns calls ({S} shards), plain_calls {rec['fused_plain']}")
    if rec["fused_launches"] != S * calls or rec["fused_plain"]:
        raise AssertionError(f"[19c] fused launches: {rec}")
    if max(v["recall"] for v in sweep.values()) < RECALL_GATE:
        raise AssertionError(f"[19c] no ef reaches recall@10 {RECALL_GATE}")
    # the workers against the caller's loop on the same mesh: every query
    # at every ef, both timed at ef=32
    if idx._pool.in_caller:
        raise AssertionError("[19c] the four-card index has no workers")
    for ef in FLAGSHIP_CARD_EFS:
        want = caller_knns(idx, q, K, ef)
        if not (torch.equal(results[ef].ids, want.ids)
                and torch.equal(results[ef].dists, want.dists)):
            raise AssertionError(f"[19c] knns on the workers != the "
                                 f"caller's loop at ef={ef}")
    log(f"[19c] knns on the workers equals the caller's loop on all {nq} "
        f"queries at ef {list(FLAGSHIP_CARD_EFS)}")
    rec["workers"] = workers_vs_caller(idx, q, K, EF, "19c", smi)

    # every shard's #1 against its plain version at ef=32, on its card
    steps = idx.shards[0]._steps_cap(EF)
    rec["kernel"] = []
    for s in range(S):
        dev = mesh.devices[s]
        with torch.cuda.device(dev):
            r = fused_at_served_shapes(idx.shards[s], qs, dev, smi,
                                       max_steps=steps,
                                       tag=f"19c shard {s} on {dev}", ef=EF)
            r["entry_ms"] = cuda_ms(r.pop("entry"), 10)
        r["device"] = str(dev)
        rec["kernel"].append(r)
    per_card = {}
    for r in rec["kernel"]:
        c = per_card.setdefault(r["device"], {"entry_ms": 0.0, "ms": 0.0})
        c["entry_ms"] += r["entry_ms"]
        c["ms"] += r["ms"]
    rec["per_card"] = per_card
    log(f"[19c] on {smi}: per card at ef={EF}, CUDA events summed over its "
        "shards: " + "; ".join(f"{d} entry {v['entry_ms']:.3f} ms, #1 "
                               f"{v['ms']:.3f} ms" for d, v in
                               per_card.items()))

    # the merge against a numpy two-key merge, at ef=32
    lead = mesh.devices[0]
    parts = [idx._shard_topk(s, as_sketches(qs, mesh.devices[s]), K, EF,
                             "fused") for s in range(S)]
    d_np = np.concatenate([p[0].cpu().numpy() for p in parts], axis=1)
    i_np = np.concatenate([p[1].cpu().numpy() for p in parts], axis=1)
    o = np.lexsort((i_np, d_np), axis=1)[:, :K]
    res = results[EF]
    rec["merge_equal"] = (
        np.array_equal(res.dists.cpu().numpy(),
                       np.take_along_axis(d_np, o, axis=1))
        and np.array_equal(res.ids.cpu().numpy(),
                           np.take_along_axis(i_np, o, axis=1)))
    rec["merge_ms"] = cuda_ms(lambda: _merge(parts, K, lead), 10)
    log(f"[19c] on {smi}: merge of {S} x [{nq}, {K}] from {cards} cards "
        f"{'equals' if rec['merge_equal'] else 'DIFFERS FROM'} the numpy "
        f"two-key merge; {rec['merge_ms']:.3f} ms on {lead} (CUDA events, "
        "the copies across cards included)")
    if not rec["merge_equal"]:
        raise AssertionError("[19c] the sharded merge != the numpy merge")
    idx.close()  # the workers release the shared shards and tables
    del idx, parts, results, res, view, chunk, want
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    # the shards' tensors, shared with the build's workers, are free again
    rec["reserved_after_gb"] = [torch.cuda.memory_reserved(d) / 1e9
                                for d in dict.fromkeys(mesh.devices)]
    log(f"[19c] index freed: PyTorch reserves "
        + ", ".join(f"{g:.3f}" for g in rec["reserved_after_gb"])
        + " GB on the cards")
    return rec, (pts, qs, gt_i)


def runner_group(device, shards, parts, *, opts, efs, q, k, query_batch,
                 sample):
    """One card's part of the JAX sharded runner's loop
    (benches/run_sharded_10m.py:136-170), run by ``CardPool.map``: each of
    its shards (``parts``: its points, a tensor on ``device``) built as
    its own HNSWBuilder index at ``opts`` on ``device``, served at the
    runner's settings (``query_batch``, ``sample``, enable_inline) and
    queried with the host queries ``q`` at every ef of ``efs`` with
    ``max_steps = ef``: a warm call, then the best of 2 timed (host clock,
    synchronized). Returns one record a shard: build seconds, level
    sizes, route, per ef its (dists, ids) as host arrays and best ms, and
    the wall-clock times its work began and ended."""
    import torch

    from hnsw_itu_tpu_torch.models import IndexOptions
    from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
    from hnsw_itu_tpu_torch.ops.metrics import as_points

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = []
    for pts in parts:
        began = time.time()
        t0 = time.perf_counter()
        b = HNSWBuilder(IndexOptions(size=len(pts), **{
            **opts, "host_warmup": min(opts["host_warmup"], len(pts))}),
            device=device)
        b.extend_batched(pts)
        index = b.build()
        sync()
        rec = {"build_s": time.perf_counter() - t0,
               "level_ns": index.level_ns, "points": {}}
        index.query_batch = query_batch
        index.query_entry_sample = sample
        index.enable_inline()
        qd = as_points(q, device)
        for ef in efs:
            index.max_steps = ef
            index.knns(qd, k, ef)
            best = float("inf")
            for _ in range(2):
                sync()
                t0 = time.perf_counter()
                res = index.knns(qd, k, ef)
                sync()
                best = min(best, time.perf_counter() - t0)
            rec["points"][ef] = (res.dists.cpu().numpy(),
                                 res.ids.cpu().numpy(), best * 1e3)
        rec.update(route=index.last_route, began=began, ended=time.time())
        out.append(rec)
        del b, index
    return out


def runner(pts, shards, mesh, q, *, opts=None, efs=None,
           query_batch=RUNNER_QUERY_BATCH, sample=SAMPLE, k=K, times=None):
    """The JAX sharded runner's recipe over ``mesh`` (one entry a shard):
    ``pts`` split into ``shards`` equal contiguous shards, each uploaded
    to its device, ``runner_group`` on every card at once
    (a ``CardPool`` for the call: one worker process a card, sharing the
    shards' tensors, each building and querying its shards in order),
    then per ef
    the ids shifted by the shard offset and the exact (distance, id)
    merge of the shards' top-k (run_sharded_10m.py:160-203). Returns (per
    ef (dists, ids) int64 [nq, k], one record a shard with its work's
    wall-clock times made relative to the call). ``times``, a dict, gets
    the call's own seconds: the uploads, the pool's start, the map, the
    pool's close and the merge."""
    import functools

    import numpy as np

    from hnsw_itu_tpu_torch.ops.metrics import as_points
    from hnsw_itu_tpu_torch.parallel.mesh import CardPool

    per = len(pts) // shards
    efs = RUNNER_EFS if efs is None else efs
    work = functools.partial(
        runner_group, opts=RUNNER_OPTS if opts is None else opts, efs=efs,
        q=np.asarray(q), k=k, query_batch=query_batch, sample=sample)
    recs = [None] * shards
    times = {} if times is None else times
    t_call = time.time()
    parts = [as_points(pts[s * per : (s + 1) * per], mesh.devices[s])
             for s in range(shards)]
    times["upload_s"] = time.time() - t_call
    t0 = time.time()
    with CardPool(mesh) as pool:
        times["pool_start_s"] = time.time() - t0
        t0 = time.time()
        out = pool.map(work, parts)
        times["map_s"] = time.time() - t0
        t0 = time.time()
    times["pool_close_s"] = time.time() - t0
    for group, res in out:
        for s, r in zip(group, res):
            r["began"] -= t_call
            r["ended"] -= t_call
            recs[s] = r
    del parts
    t0 = time.time()
    imax = np.iinfo(np.int32).max
    merged = {}
    for ef in efs:
        all_d, all_i = [], []
        for s, r in enumerate(recs):
            d, i = (x.astype(np.int64) for x in r["points"][ef][:2])
            ok = (i >= 0) & (i < imax)
            all_d.append(np.where(ok, d, imax))
            all_i.append(np.where(ok, i + s * per, -1))
        all_d, all_i = np.concatenate(all_d, 1), np.concatenate(all_i, 1)
        o = np.lexsort((all_i, all_d), axis=1)[:, :k]
        merged[ef] = (np.take_along_axis(all_d, o, axis=1),
                      np.take_along_axis(all_i, o, axis=1))
    times["merge_s"] = time.time() - t0
    return merged, recs


def phase_runner(pts, qs, gt_i, cards, smi):
    """Phase 19d: the JAX sharded runner's recipe on the 19c data: 16
    HNSWBuilder shards, one worker process a card, each card building and
    serving its four shards in order, all four cards at once; each shard on
    its fused table at ef 48 and 32 (max_steps = ef), best of 2 warm
    calls; merged; recall@10 beside the runner's record. The call's wall
    is attributed: uploads, the pool's start, each card's start, build
    and end in the map, the pool's close, the merge."""
    import torch

    from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
    from hnsw_itu_tpu_torch.utils import recall_at_k

    S = RUNNER_SHARDS
    mesh = card_mesh(cards, S)
    fused_beam_search.kernel_launches = fused_beam_search.plain_calls = 0
    times = {}
    t0 = time.perf_counter()
    merged, recs = runner(pts, S, mesh, qs, times=times)
    wall = time.perf_counter() - t0
    per_card = {}
    for s, d in enumerate(mesh.devices):
        c = per_card.setdefault(str(d), {
            "build_s": 0.0, "shards_s": 0.0, "began_s": recs[s]["began"],
            **{f"knns_ms_ef{ef}": 0.0 for ef in RUNNER_EFS}})
        c["build_s"] += recs[s]["build_s"]
        c["shards_s"] += recs[s]["ended"] - recs[s]["began"]
        c["ended_s"] = recs[s]["ended"]
        for ef in RUNNER_EFS:
            c[f"knns_ms_ef{ef}"] += recs[s]["points"][ef][2]
    routes = {r["route"] for r in recs}
    rec = {"n": len(pts), "shards": S, "opts": RUNNER_OPTS, "wall_s": wall,
           "call_s": times, "build_s": [r["build_s"] for r in recs],
           "per_card": per_card, "level_ns": [r["level_ns"] for r in recs],
           "fused_launches": fused_beam_search.kernel_launches,
           "fused_plain": fused_beam_search.plain_calls, "points": {}}
    log(f"[19d] {S} HNSWBuilder shards of {len(pts) // S} points "
        f"({RUNNER_OPTS}), one worker process a card on {cards} cards: "
        f"{wall:.1f} s wall for the builds and queries; per shard build "
        + ", ".join(f"{r['build_s']:.1f}" for r in recs) + " s")
    begun = times["upload_s"] + times["pool_start_s"]
    log(f"[19d] the wall attributed (host clock, s after the call): "
        f"uploads {times['upload_s']:.2f}, the pool's start "
        f"{times['pool_start_s']:.2f}, the map {times['map_s']:.2f} (from "
        f"{begun:.2f} to "
        f"{begun + times['map_s']:.2f}), the pool's close "
        f"{times['pool_close_s']:.2f}, the merge {times['merge_s']:.2f}; "
        "per card: "
        + "; ".join(f"{d} began {v['began_s']:.2f}, ended "
                    f"{v['ended_s']:.2f}, build {v['build_s']:.1f}, its "
                    f"{S // cards} shards' spans {v['shards_s']:.1f}"
                    for d, v in per_card.items()))
    for ef in RUNNER_EFS:
        r10 = recall_at_k(merged[ef][1], gt_i, K)
        ms = [r["points"][ef][2] for r in recs]
        rec["points"][ef] = {"recall": r10, "shard_ms": ms,
                             "jax_record": RUNNER_JAX_RECALL[ef]}
        log(f"[19d] on {smi}: ef={ef} (max_steps {ef}, sampled entry "
            f"{SAMPLE}, query batch {RUNNER_QUERY_BATCH}), routes "
            f"{sorted(routes)}: per shard best of 2 {min(ms):.2f}-"
            f"{max(ms):.2f} ms for {len(qs)} queries; merged recall@10 "
            f"{r10:.4f} (the JAX record, benches/results_sharded_10m.json, "
            f"measured on a TPU: {RUNNER_JAX_RECALL[ef]})")
    if routes != {"fused"} or rec["fused_plain"] or \
            rec["fused_launches"] <= 0:
        raise AssertionError(f"[19d] routes {routes}, fused launches "
                             f"{rec['fused_launches']}, plain "
                             f"{rec['fused_plain']}")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def lap_timer():
    """(lap, seconds, start): ``lap(name)`` logs and keeps the seconds
    since the previous lap (or the start) under ``name``."""
    t_start = time.perf_counter()
    seconds, t_last = {}, [t_start]

    def lap(name):
        now = time.perf_counter()
        seconds[name] = now - t_last[0]
        t_last[0] = now
        log(f"[{name}] phase seconds {seconds[name]:.1f}")

    return lap, seconds, t_start


def main_cards(args) -> int:
    """``--cards 4``: the card check, the kernel build and phase 19, with
    its own kernels line and the ok line; raises below ``args.cards``
    cards (no fallback to fewer)."""
    import torch

    have = torch.cuda.device_count()
    if have < args.cards:
        raise RuntimeError(f"--cards {args.cards}: {have} card(s) visible; "
                           f"phase 19 runs on {args.cards} and has no "
                           "fallback")
    lap, seconds, t_start = lap_timer()
    smi = phase_card()
    lap("1")
    overlap = phase_overlap(args.shard_n, args.nq, args.cards, smi)
    lap("19a")
    qcards = phase_query_cards(args.build_n, args.nq, args.cards, smi)
    lap("19b")
    flag, data = phase_flagship_cards(args.flagship_n, args.nq, args.cards,
                                      smi)
    lap("19c")
    runner = phase_runner(*data, args.cards, smi)
    lap("19d")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all; phase "
        "seconds " + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    log("[19] record " + json.dumps({
        "overlap": overlap, "query_sharding": qcards,
        "flagship": {k: v for k, v in flag.items() if k != "kernel"},
        "runner": runner}))
    print(json.dumps(cards_kernels(overlap, flag, runner)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def cards_kernels(overlap, flag, runner):
    """Phase 19's kernels record: #1, #6 and #7 on the four-card path,
    their launches in 19c (counts zeroed just before its build and its
    sweep), each held to its plain version on a card of the mesh."""
    ks = flag["kernel"]

    def mean(key):
        return sum(r[key] for r in ks) / len(ks)

    chunk = flag["chunk"]
    return {"kernels": [{
        "name": "fused_beam_search",
        "route": "cuda",
        "source": KERNEL_SRC,
        "replaces": KERNEL_REPLACES,
        # phase 19c's ef sweep: one launch a shard a call
        "launches": flag["fused_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in ks),
        # means over the 16 shards, each on its card at ef=32 on every query
        "ms": mean("ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call runs a beam search
        "per_shard": [{k: r[k] for k in ("device", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms", "entry_ms",
                                         "steps_q", "visited_q")}
                      for r in ks],
        "overlap_launches": {m: overlap[f"fused_launches_{m}"]
                             for m in ("one", "cards")},
        "runner_launches": runner["fused_launches"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": src,
        "replaces": replaces,
        # phase 19c's build over the cards
        "launches": flag[f"{key}_launches"],
        "max_abs_err": chunk[key]["max_abs_err"],
        "ms": chunk[key]["ms"],
        "plain_ms": chunk[key]["plain_ms"],
        "bound_ms": chunk[key]["bound_ms"],
        "bound_by": chunk[key].get("bound_by", "bytes"),
        "library_ms": chunk[key].get("library_ms"),
        "chunk": {k: v for k, v in chunk[key].items() if k not in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "overlap_launches": [b[f"{key}_launches"]
                             for b in overlap["builds"]],
    } for name, src, replaces, key in (
        ("dma_beam_search", DMA_SRC, DMA_REPLACES, "dma"),
        ("hamming_block", HAM_SRC, HAM_REPLACES, "ham"))]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000,
                    help="index points of the fused path")
    ap.add_argument("--nq", type=int, default=10_000, help="queries")
    ap.add_argument("--mini-n", type=int, default=MINI_CAP,
                    help="index points of the mini path (the index keeps "
                    f"at least {MINI_CAP} rows)")
    ap.add_argument("--build-n", type=int, default=BUILD_N,
                    help="index points of the device-build phase")
    ap.add_argument("--cli-n", type=int, default=BUILD_N,
                    help="index points of the CLI-default phase")
    ap.add_argument("--shards", type=int, default=SHARDS,
                    help="shards of the sharding phase, all on the one card")
    ap.add_argument("--shard-n", type=int, default=SHARD_N,
                    help="points a shard of the sharding phase")
    ap.add_argument("--flagship-n", type=int, default=FLAGSHIP_N,
                    help="index points of the 10M phase (above 2^21, so "
                    "that the mini table serves), and of phase 19's 16 "
                    "shards")
    ap.add_argument("--cards", type=int, choices=(1, CARDS), default=1,
                    help=f"1: phases 1-18 on one card; {CARDS}: phase 19 "
                    f"alone on {CARDS} cards (--shard-n points a card in "
                    "19a, --build-n in 19b, --flagship-n in 19c-d)")
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
    from hnsw_itu_tpu_torch.ops import _kernels
    from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
    from hnsw_itu_tpu_torch.ops.mini_search import mini_beam_search
    from hnsw_itu_tpu_torch.utils import ResultAttrs, save_index

    if args.cards > 1:
        return main_cards(args)
    dev = require_cuda(0)
    lap, seconds, t_start = lap_timer()
    smi = phase_card()
    lap("1")
    err_small = phase_small_graphs(dev)
    err_small_mini = phase_small_mini(dev)
    err_small_dma, err_small_ham = phase_small_build_kernels(dev)
    err_edge_fused, err_edge_dma, err_edge_mini = phase_small_edges(dev)
    lap("2")

    # the fused path: build, table, queries; only its launches count
    fused_beam_search.kernel_launches = 0
    fused_beam_search.plain_calls = 0
    pts, qs, index = phase_build(args.n, args.nq, dev)
    lap("3")
    gt_i = phase_oracle(pts, qs, dev)
    lap("4")
    with ReplayCheck("5"):
        knns_s, entry_5 = phase_query(index, qs, gt_i, dev)
    lap("5")
    launches = fused_beam_search.kernel_launches
    plain = fused_beam_search.plain_calls
    if launches <= 0 or plain != 0:
        raise AssertionError(
            f"fused path launches {launches}, plain calls {plain}")
    fused = phase_slice_shapes(index, qs, dev, smi, knns_s)
    lap("6")
    # phase 13 on the 100k index: the greedy descent on #6, then #1
    descent_100k = phase_descent(index, qs, gt_i, dev, smi)
    lap("13, 100k")
    del pts, qs, index, gt_i
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[6] fused-path index freed: "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB still allocated")

    # the mini path: a device build of at least 2.2M rows, the table, the
    # queries; only the queries' launches count
    pts, qs, index, mini_build = phase_device_build(
        args.mini_n, args.nq, dev, cap=max(args.mini_n, MINI_CAP), tag="7")
    gt_i = phase_oracle(pts, qs, dev, tag="7")
    del pts
    mini_beam_search.kernel_launches = 0
    mini_beam_search.plain_calls = 0
    fused_before = fused_beam_search.kernel_launches
    with ReplayCheck("7"):
        mini_q, entry_7 = phase_mini_query(index, qs, gt_i, dev)
    mini_launches = mini_beam_search.kernel_launches
    mini_plain = mini_beam_search.plain_calls
    log(f"[7] mini path: kernel_launches {mini_launches}, plain_calls "
        f"{mini_plain}, fused launches "
        f"{fused_beam_search.kernel_launches - fused_before}")
    if mini_launches <= 0 or mini_plain != 0:
        raise AssertionError(
            f"mini path launches {mini_launches}, plain calls {mini_plain}")
    lap("7")
    err_mini, mini, mini_sweep = phase_mini_slice_shapes(
        index, qs, dev, smi, mini_q[EF]["knns_ms"])
    lap("8")
    # phase 15 on the mini index: a reordered copy on its own mini table
    reorder_mini = phase_reorder_mini(index, qs, gt_i, dev, smi,
                                      mini_q[EF]["knns_ms"])
    lap("15, mini")
    del qs, index, gt_i
    gc.collect()
    torch.cuda.empty_cache()

    # the device build: its kernels' launch counts are zeroed inside, just
    # before extend_batched, and read right after build()
    pts, qs, index, build = phase_device_build(args.build_n, args.nq, dev)
    lap("9")
    bk = phase_build_kernels(index, qs, dev, smi)
    lap("10")
    with ReplayCheck("11"):
        served = phase_build_query(index, pts, qs, dev, smi)
    gt_i, gt_d = served.pop("gt_i"), served.pop("gt_d")
    lap("11")
    # phase 13 on the 1M device-built index
    descent_1m = phase_descent(index, qs, gt_i, dev, smi)
    lap("13, 1M")
    # phase 15 on the same index: a reordered copy on its own fused table
    reorder_fused = phase_reorder_fused(index, qs, gt_i, gt_d, dev, smi)
    lap("15, fused")
    # phase 17 (c) on the same index: query sharding
    with ReplayCheck("17c", replays=False):  # the general route
        qsharded = phase_query_sharded(index, qs, gt_i, dev,
                                       args.shards)
    lap("17c")
    del index
    gc.collect()
    torch.cuda.empty_cache()

    # phase 12: the CLI's default path (the same data when the sizes agree)
    if args.cli_n != args.build_n:
        from hnsw_itu_tpu_torch.utils import make_dataset

        pts, qs = make_dataset(0, args.cli_n, args.nq)
        gt_i = phase_oracle(pts, qs, dev, tag="12")
    cli, index, res12 = phase_cli_default(pts, qs, gt_i, dev, smi)
    lap("12")
    # phase 14: the CLI on the card, on phase 12's index saved to .npz
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cli_default.npz")
        t0 = time.perf_counter()
        save_index(path, index, ResultAttrs(
            data="hamming", size=index.n, algo="Hnsw",
            buildtime=cli["host_s"] + cli["device_s"] + cli["finish_s"],
            params="index=(efc={ef_construction},m={connections},"
                   "M={max_connections})".format(**CLI_OPTS)))
        log(f"[14] save_index of phase 12's index: "
            f"{os.path.getsize(path) / 1e9:.3f} GB in "
            f"{time.perf_counter() - t0:.1f} s")
        inline_rows = index.inline_rows
        del index
        gc.collect()
        torch.cuda.empty_cache()
        cli_card = phase_cli_card(path, qs, gt_i, res12, inline_rows, dev,
                                  smi)
    lap("14")
    del pts, qs, gt_i, res12
    gc.collect()
    torch.cuda.empty_cache()
    nsw = phase_nsw(args.nq, dev)
    lap("13, NSW")
    gc.collect()
    torch.cuda.empty_cache()
    l2 = phase_l2(args.nq, dev, smi)
    lap("16")
    gc.collect()
    torch.cuda.empty_cache()
    # phase 17: index sharding; each part zeroes its kernels' counts
    indep = phase_shard_independence(dev, args.shards)
    lap("17b")
    with ReplayCheck("17"):
        sharded = phase_sharded(args.shards, args.shard_n, args.nq, dev,
                                smi, mini_q[EF])
    lap("17")
    gc.collect()
    torch.cuda.empty_cache()
    # phase 18: the 10M runner's configuration, with everything else freed
    flagship = phase_flagship(args.flagship_n, args.nq, dev, smi)
    lap("18")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all; phase "
        "seconds " + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    log("[7] record " + json.dumps({"build": {k: mini_build[k] for k in (
        "host_s", "device_s", "finish_s", "level_ns", "edge_drops",
        "dma_launches", "ham_launches")}, "knns": {
        str(k): v for k, v in mini_q.items()}}))
    log("[14] record " + json.dumps(cli_card))
    log("[15] record " + json.dumps({"fused": reorder_fused,
                                     "mini": reorder_mini}))
    log("[16] record " + json.dumps(l2))
    log("[12] record " + json.dumps({k: cli[k] for k in cli if k not in (
        "ham_plain", "dma_plain")}))
    log("[13] record " + json.dumps({"nsw": nsw, "descent": [
        descent_100k, descent_1m]}))
    log("[17] record " + json.dumps({
        "index_sharding": {k: sharded[k] for k in sharded if k != "kernel"},
        "kernel_per_shard": [{k: v for k, v in r.items() if k != "sweep"}
                             for r in sharded["kernel"]],
        "shard_independence": indep, "query_sharding": qsharded}))
    log("[18] record " + json.dumps({k: flagship[k] for k in (
        "build", "attribution", "policy", "jax_budget")}))
    fl_build = flagship["build"]
    main_entry = (entry_5, entry_7, served["entry"])
    entry_checks = (bk["entry"], *flagship["kernels"]["entry"].values())
    print(json.dumps({"kernels": [{
        "name": "fused_beam_search",
        "route": "cuda",
        "source": KERNEL_SRC,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max(err_small, err_edge_fused, fused["max_abs_err"],
                           served["kernel"]["max_abs_err"],
                           *(r["max_abs_err"] for r in sharded["kernel"])),
        "ms": fused["ms"],
        "plain_ms": fused["plain_ms"],
        "bound_ms": fused["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call runs a beam search
        **{k: fused[k] for k in ("steps_q", "visited_q", "resident_warps",
                                 "sweep")},
        "also_replaces": ["hnsw_itu_tpu/ops/pallas_search.py:468 (#2, one "
                          "query per row)"],
        # the device-built index's knns (phase 11): its launches, and the
        # kernel against its plain version at those shapes
        "device_built": {"launches": served["launches"],
                         **served["kernel"]},
        # phase 13: the base kernel after the greedy descent
        "after_descent": {
            str(d["n"]): {"launches": d["fused_launches"],
                          "ms": d["fused_ms"], "recall": d["recall"],
                          "knns_ms": d["knns_ms"]}
            for d in (descent_100k, descent_1m)},
        "nsw": {"recall": nsw["fused"]["recall"],
                "knns_ms": nsw["fused"]["knns_ms"]},
        # phase 15: a reordered copy of the 1M device-built index
        "reordered": {k: reorder_fused[k] for k in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "knns_ms", "unreordered_knns_ms", "recall", "tie_tolerant",
            "unreordered_tie_tolerant")},
        # phase 17: one launch a shard per knns call on the sharded index,
        # each shard's launch against its plain version at the headline ef
        "sharded": {
            "launches": sharded["launches"], "calls": sharded["calls"],
            "ef": sharded["ef"],
            "recall": sharded["sweep"][sharded["ef"]]["recall"],
            "knns_ms": sharded["sweep"][sharded["ef"]]["knns_ms"],
            "merge_ms": sharded["merge_ms"],
            **{k: [r[k] for r in sharded["kernel"]] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "entry_ms",
                "steps_q", "visited_q")}},
    }, {
        "name": "mini_beam_search",
        "route": "cuda",
        "source": MINI_SRC,
        "replaces": MINI_REPLACES,
        "also_replaces": MINI_COVERS,
        "launches": mini_launches,
        "max_abs_err": max(err_small_mini, err_edge_mini, err_mini, *(
            flagship[t]["headline"]["max_abs_err"]
            for t in ("policy", "jax_budget"))),
        "ms": mini[EF]["ms"],
        "plain_ms": mini[EF]["plain_ms"],
        "bound_ms": mini[EF]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "ef32": mini[EF],
        "ef96": mini[MINI_EFS[1]],
        "ef32_tie_bits_ms": mini["tie_bits_ms"],  # unreordered, bitrev
        "rerank_exact_kernel": mini["rerank"],  # csrc/exact_rerank.cu
        "sweep": mini_sweep,
        "knns": {str(ef): v for ef, v in mini_q.items()},
        # phase 15: the reordered 2.2M copy at bit-reversed tie order
        "reordered": reorder_mini,
        # phase 18: the 10M index, its launches over every plan point of
        # both tables, and each table's headline point held to the plain
        # version on every query
        "flagship": {"n": args.flagship_n, "launches": sum(
            r["launches"] for t in ("policy", "jax_budget")
            for r in flagship[t]["points"]), **{
                t: {k: flagship[t][k] for k in ("W", "mini_words",
                                                "table_gb", "headline")}
                for t in ("policy", "jax_budget")}},
    }, {
        "name": "dma_beam_search",
        "route": "cuda",
        "source": DMA_SRC,
        "replaces": DMA_REPLACES,
        "launches": build["dma_launches"],
        "max_abs_err": max(err_small_dma, err_edge_dma,
                           bk["dma"]["max_abs_err"],
                           flagship["kernels"]["dma"]["max_abs_err"],
                           descent_100k["max_abs_err"],
                           descent_1m["max_abs_err"]),
        "ms": bk["dma"]["ms"],
        "plain_ms": bk["dma"]["plain_ms"],
        "bound_ms": bk["dma"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "searches": bk["dma"]["searches"],
        **{k: bk["dma"][k] for k in bk["dma"] if k not in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "searches")},
        "build": {k: build[k] for k in build if k not in (
            "dma_launches", "dma_plain", "ham_launches", "ham_plain")},
        "knns_on_built_index": {k: served[k] for k in ("recall",
                                                        "knns_ms")},
        # phase 13: the query-time greedy descent (ef=1 per level), every
        # level's launch held against the plain version
        "query_descent": {
            str(d["n"]): {k: d[k] for k in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "descent_ms", "greedy_search_ms", "levels")}
            for d in (descent_100k, descent_1m)},
        "cli_build_launches": cli["dma_launches"],  # 0: rows 256 wide
        "nsw_build_launches": nsw["dma_launches"],
        "mini_build_launches": mini_build["dma_launches"],  # phase 7
        "l2_build_launches": l2["dma_launches"],  # 0: not Hamming
        # phase 17: the sharded build's searches (every shard), and the
        # descent of knns_query_sharded
        "sharded": {"launches": sharded["dma_launches"],
                    "query_sharded_descent_launches":
                        qsharded["descent"]["dma_launches"]},
        # phase 18: the 10M build's searches, and one of its chunks
        "flagship_build": {"launches": fl_build["dma_launches"],
                           **{k: fl_build[k] for k in ("level_ns",
                                                       "edge_drops")},
                           "chunk": flagship["kernels"]["dma"]},
    }, {
        "name": "hamming_block",
        "route": "cuda",
        "source": HAM_SRC,
        "replaces": HAM_REPLACES,
        "launches": build["ham_launches"],
        "max_abs_err": max(err_small_ham, bk["ham"]["max_abs_err"],
                           flagship["kernels"]["ham"]["max_abs_err"],
                           *(v["max_abs_err"] for v in cli["ham"].values())),
        "ms": bk["ham"]["ms"],
        "plain_ms": bk["ham"]["plain_ms"],
        "bound_ms": bk["ham"]["bound_ms"],
        "bound_by": bk["ham"]["bound_by"],
        # Hamming.pairwise_mxu's route: bit unpack + one float32 matmul
        "library_ms": bk["ham"]["library_ms"],
        "popc_ms": bk["ham"]["popc_ms"],  # the earlier __popc design
        # phase 12: the select and prune blocks of the M=256 CLI build,
        # each against its plain version at the build's own shape
        "cli_build": {"launches": cli["ham_launches"], **cli["ham"]},
        "nsw_build_launches": nsw["ham_launches"],
        "mini_build_launches": mini_build["ham_launches"],  # phase 7
        "l2_build_launches": l2["ham_launches"],  # 0: not Hamming
        # phase 17: the sharded build's select and prune blocks
        "sharded": {"launches": sharded["ham_launches"]},
        # phase 18: the 10M build's blocks, and one chunk's select block
        "flagship_build": {"launches": fl_build["ham_launches"],
                           "chunk": flagship["kernels"]["ham"]},
    }, {
        "name": "sampled_entry",
        "route": "cuda",
        "source": ENTRY_SRC,
        "replaces": ENTRY_REPLACES,
        # the main path's query batches (phases 5, 7 and 11, counters
        # zeroed before each phase's knns calls): one launch a batch, no
        # plain call
        "launches": sum(e["launches"] for e in main_entry),
        "plain_calls": sum(e["plain_calls"] for e in main_entry),
        "batches": sum(e["batches"] for e in main_entry),
        "main_path": dict(zip(("5", "7", "11"), main_entry)),
        # ids that differ from the plain version's, and their largest
        # difference, over every check (phases 10 and 18)
        "ids_differing": sum(e["ids_differing"] for e in entry_checks),
        "max_abs_err": max(e["max_abs_err"] for e in entry_checks),
        **{k: bk["entry"][k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "shape",
                                       "mma")},
        # phase 18: the 10M cell's shape and the 65,536-point sample
        "flagship": flagship["kernels"]["entry"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
