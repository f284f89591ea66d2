"""Random graphs and the beam kernels' edge cases, in numpy, for the card
checks: ``tests/test_torch_kernels.py`` and ``chip_smoke.py`` phase 2 both
draw their small cases from here, so the two lists cannot drift apart.

Every case is made from a seed with ``numpy.random.default_rng``; nothing
here touches a device. ``probe_group`` and ``held_group`` are
``parallel.mesh.CardPool`` work functions for the tests: a worker process
imports them by name.
"""

from __future__ import annotations

import os

import numpy as np

# (kind, cap, W, ef, seeds) of the gather kernel's edge cases; the kinds
# are edge_graph's
GATHER_EDGES = [("full", 1024, 128, 96, 1), ("random", 256, 24, 48, 1),
                ("one_id", 256, 64, 32, 1), ("near_max", 256, 32, 16, 2),
                ("collide", 8192, 32, 64, 1), ("random", 256, 64, 1, 1),
                ("random", 256, 64, 128, 128), ("full", 256, 128, 128, 128)]
# (kind, cap, W, ef, seeds, mini_words, tie_bits) of the mini kernel's
MINI_EDGES = [("full", 1024, 128, 96, 1, 7, 0),
              ("random", 256, 24, 48, 1, 7, 0),
              ("one_id", 256, 64, 32, 1, 3, 0),
              ("near_max", 256, 32, 16, 2, 7, 0),
              ("near_max", 256, 32, 24, 2, 7, 31),
              ("collide", 8192, 32, 64, 1, 31, 0),
              ("random", 256, 64, 1, 1, 7, 0),
              ("random", 256, 64, 128, 128, 7, 8),
              ("full", 256, 128, 128, 128, 31, 0)]
# (kind, cap, W, ef, id_bits, max_steps) of the fused kernel's edge cases;
# the kinds are fused_edge_inputs'. id_bits 25 clamps distances to 62 and
# 30 to 0, so on random sketches every key of a row shares the clamped
# distance and the ids alone order them
FUSED_EDGES = [("full", 1024, 128, 96, 10, 256),
               ("full", 256, 128, 128, 8, 256),
               ("random", 256, 24, 48, 8, 256),
               ("one_id", 256, 64, 32, 8, 256),
               ("random", 256, 64, 1, 8, 256),
               ("resketch", 256, 32, 48, 8, 256),
               ("random", 256, 32, 64, 25, 256),
               ("random", 256, 64, 128, 30, 256),
               ("top_id", 256, 32, 32, 25, 256),
               ("top_id", 64, 16, 128, 30, 256),
               ("random", 256, 32, 32, 8, 0)]
# (W, ef, seeds, distinct ids among them, tie_bits of the mini kernel) of
# the repeated-seed cases: a sampled entry over fewer points than its
# sample gives a query the same seed more than once
REPEATED_SEEDS = [(64, 32, 4, 2, 0), (24, 96, 8, 3, 8), (32, 16, 16, 1, 0),
                  (64, 128, 128, 40, 9)]


def random_graph(rng, cap, w, words):
    """(points uint32[cap, words], adj int32[cap, w]): each row holds
    w/2 to w distinct random ids, then -1."""
    pts = rng.integers(0, 2**32, size=(cap, words), dtype=np.uint32)
    adj = np.full((cap, w), -1, np.int32)
    for i in range(cap):
        deg = rng.integers(w // 2, w + 1)
        adj[i, :deg] = rng.choice(cap, size=deg, replace=False)
    return pts, adj


def edge_graph(rng, kind, cap, w, words=32):
    """(points, adj, seedable ids) of a graph on the edges of the beam
    kernels: ``full`` rows of w distinct ids other than the node's own, so
    a first expansion finds every neighbor fresh (F = W); ``one_id`` rows
    that repeat one id throughout; ``near_max`` random rows where a quarter
    of the entries are ids 2^31 - 1 - k, k < 4 (2^31 - 1 itself is the
    empty slot's id field); ``collide`` rows over 64 ids that are 512
    apart in 4 residues, so every id hashes into 4 buckets of the id set
    (its size divides 512); else random rows."""
    pts = rng.integers(0, 2**32, size=(cap, words), dtype=np.uint32)
    live = np.arange(cap, dtype=np.int32)
    if kind == "full":
        adj = np.stack([rng.choice(cap - 1, size=w, replace=False)
                        for _ in range(cap)]).astype(np.int32)
        adj += adj >= np.arange(cap, dtype=np.int32)[:, None]
    elif kind == "one_id":
        adj = np.repeat(((np.arange(cap) * 7 + 1) % cap)[:, None], w,
                        axis=1).astype(np.int32)
    elif kind == "near_max":
        _, adj = random_graph(rng, cap, w, words)
        big = rng.random(adj.shape) < 0.25
        adj[big] = (2**31 - 1) - rng.integers(0, 4, size=int(big.sum()))
    elif kind == "collide":
        live = np.array([r + 512 * k for r in range(4) for k in range(16)],
                        np.int32)
        adj = np.full((cap, w), -1, np.int32)
        for i in live:
            adj[i] = rng.choice(live[live != i], size=w, replace=False)
    else:
        _, adj = random_graph(rng, cap, w, words)
    return pts, adj, live


def edge_inputs(kind, cap, w, E, salt=0, B=32, words=32):
    """numpy (points, adj, queries uint32[B, words], seeds int32[B, E]) of
    one edge case: E distinct seeds per query among edge_graph's seedable
    ids. ``salt`` (the mini cases pass mini_words) varies the draw."""
    rng = np.random.default_rng(sum(map(ord, kind)) + cap + w + E + salt)
    pts, adj, live = edge_graph(rng, kind, cap, w, words)
    qs = rng.integers(0, 2**32, size=(B, words), dtype=np.uint32)
    seeds = np.stack([rng.choice(live, size=E, replace=False)
                      for _ in range(B)]).astype(np.int32)
    return pts, adj, qs, seeds


def repeated_seed_inputs(w, E, distinct, cap=256, B=32, words=32):
    """numpy (points, adj, queries, seeds int32[B, E]) of a random graph
    whose queries each draw E seeds from ``distinct`` ids of their own,
    every one of those ids at least once: seed ids repeat."""
    rng = np.random.default_rng(1000 * w + 10 * E + distinct)
    pts, adj = random_graph(rng, cap, w, words)
    qs = rng.integers(0, 2**32, size=(B, words), dtype=np.uint32)
    seeds = np.empty((B, E), np.int32)
    for b in range(B):
        pool = rng.choice(cap, size=distinct, replace=False)
        seeds[b] = rng.permutation(np.concatenate(
            [pool, rng.choice(pool, size=E - distinct)]))
    return pts, adj, qs, seeds


def fused_table(pts, adj):
    """numpy (ids int32[cap, W], data uint32[cap, W, words]) of the fused
    table of ``adj`` as materialize_fused lays it out, at adj's own width
    W (not padded to a power of two): neighbor j's sketch at data[e, j],
    points clamped into range, zeros for absent edges."""
    ids = adj.astype(np.int32)
    data = pts[np.clip(ids, 0, len(pts) - 1)]
    return ids, np.where((ids >= 0)[..., None], data, 0).astype(np.uint32)


def fused_edge_inputs(kind, cap, w, id_bits, B=32, words=32):
    """numpy (points, ids, data, queries uint32[B, words], entry ids
    int32[B]) of one fused edge case: edge_graph's ``full``, ``one_id`` and
    random rows, or ``resketch`` rows whose column w/2 repeats column 0's id
    with another sketch (a table no builder makes: the two keys differ, and
    both stay), or ``top_id`` rows where a quarter of the entries are ids
    2^id_bits - 1 - k, k < 4, with the last point's sketch (at k = 0 and
    the clamped distance the key is key_inf - 1; the ids lie past the
    table's rows, so an expansion reads row cap - 1, as the plain search
    clamps it)."""
    rng = np.random.default_rng(sum(map(ord, kind)) + cap + w + id_bits)
    pts, adj, live = edge_graph(rng, "random" if kind in (
        "resketch", "top_id") else kind, cap, w, words)
    if kind == "top_id":
        top = rng.random(adj.shape) < 0.25
        adj[top] = (2**id_bits - 1) - rng.integers(0, 4, size=int(top.sum()))
    ids, data = fused_table(pts, adj)
    if kind == "resketch":
        h = w // 2
        ids[:, h] = ids[:, 0]
        data[:, h] = rng.integers(0, 2**32, size=(cap, words),
                                  dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(B, words), dtype=np.uint32)
    return pts, ids, data, qs, rng.choice(live, size=B).astype(np.int32)


def probe_group(device, shards, args):
    """For each shard in the order given: (process id, shard, its arg,
    device as text), after one plain Hamming block on the CPU (a launch
    count the caller should see); raises ValueError at an arg "fail" and
    ends its process at "exit"."""
    import torch

    from .ops.hamming import hamming_block

    out = []
    for s, a in zip(shards, args):
        if a == "fail":
            raise ValueError(f"shard {s} failed")
        if a == "exit":
            os._exit(3)
        hamming_block(torch.zeros((2, 1), dtype=torch.int32),
                      torch.zeros((2, 1), dtype=torch.int32))
        out.append((os.getpid(), s, a, str(device)))
    return out


class DropProbe:
    """An object that appends its process id to the file ``path`` when
    it is dropped: bound in a ``CardPool`` worker, it shows that the
    worker released what it held."""

    def __init__(self, path: str):
        self.path = path

    def __del__(self):
        with open(self.path, "a") as f:
            f.write(f"{os.getpid()}\n")


def held_group(probe, device, shards, args):
    """A ``CardPool.map`` job on a bound probe: (process id, the probe's
    path) for each of ``shards``."""
    return [(os.getpid(), probe.path) for _ in shards]
