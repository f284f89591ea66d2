"""Synthetic 1024-bit sketch generator for benchmarks and scale tests.

A numpy-only copy of hnsw_itu_tpu/utils/synth.py: the same seed gives the
same arrays in both packages.

The reference's headline benchmark runs on laion2B-en hamming sketches
(binarized CLIP embeddings; the reference's README), which are
not available in this environment. The proxy must therefore reproduce the
*navigability* of that data, not just its cluster granularity.

Round-3 finding (benches/diag_nav.py, real TPU, n=632,512 / 79,064 leaf
clusters — the per-shard density of the 16-way 10.12M run):

  * FLAT leaves (every cluster center an independent uniform sketch, all
    centers mutually ~512 bits apart): exact-path recall@10 collapses to
    0.2604 at ef=64 / 0.4830 at ef=256, with 15x the reverse-edge drops.
    With C mutually equidistant centers there is NO distance gradient for
    beam search to descend toward the query's cluster — each ~8-member
    cluster is a needle, and greedy graph navigation is structurally
    impossible (this is a property of the data, not of any index: the
    reference's Rust HNSW degrades the same way on such data).
  * HIERARCHICAL leaves (roots -> mids -> leaves, below): recall@10
    0.9990 at ef=64 at the SAME leaf density, build 1.6x faster,
    drops 15x lower.

Real CLIP sketch space is multi-scale (coarse semantic directions, then
finer distinctions), which is what makes HNSW work on LAION at all; the
hierarchical generator is the faithful proxy. Structure:

    64 roots        uniform random sketches
    4096 mids       root ^ flips(p=0.12)   (~12% of bits)
    n_leaf leaves   mid  ^ flips(p=0.06)
    points/queries  leaf ^ flips(p=0.08)   (~151-bit expected sibling
                                            distance, matching the
                                            in-cluster scale round 1-2
                                            benches used)

Generation is chunked (1M rows) so 10M x 1024 random bits never needs
>1.3GB of scratch.
"""

from __future__ import annotations

import numpy as np

WORDS = 32  # 1024-bit sketches as uint32[32]
_CHUNK = 1_000_000


def _flips(rng: np.random.Generator, n: int, p: float) -> np.ndarray:
    bits = rng.random((n, WORDS * 32), dtype=np.float32) < p
    return np.packbits(bits, axis=-1).view(np.uint32)


def make_leaves(rng: np.random.Generator, n_leaf: int) -> np.ndarray:
    """Multi-scale cluster centers (uint32[n_leaf, 32])."""
    roots = rng.integers(0, 2**32, size=(64, WORDS), dtype=np.uint32)
    mids = roots[rng.integers(0, 64, size=4096)] ^ _flips(rng, 4096, 0.12)
    out = np.empty((n_leaf, WORDS), np.uint32)
    for s in range(0, n_leaf, _CHUNK):
        e = min(s + _CHUNK, n_leaf)
        out[s:e] = mids[rng.integers(0, 4096, size=e - s)] ^ _flips(
            rng, e - s, 0.06
        )
    return out


def make_points(
    rng: np.random.Generator, leaves: np.ndarray, n: int, p: float = 0.08
) -> np.ndarray:
    """n sketches, each a leaf center with every bit flipped at p."""
    out = np.empty((n, WORDS), np.uint32)
    for s in range(0, n, _CHUNK):
        e = min(s + _CHUNK, n)
        out[s:e] = leaves[
            rng.integers(0, leaves.shape[0], size=e - s)
        ] ^ _flips(rng, e - s, p)
    return out


# Distribution profiles for the claims-robustness sweep (VERDICT round 4
# item 4): every committed recall number historically rode ONE generator
# shape; these vary cluster granularity, cluster width, and add a uniform
# heavy tail so the es/hop query recipe can be shown (or shown not) to be
# generator-tuned. "default" is the historical navigable multi-scale shape.
#   name        leaves   point flip p   extras
#   default     n/128    0.08           —
#   fine        n/32     0.05           4x more, tighter clusters
#   coarse      n/512    0.12           4x fewer, wider clusters
#   tail        n/128    0.08           20% of points uniform random
#                                       (queries still cluster-drawn —
#                                       the tail is pure distractor mass)
PROFILES = ("default", "fine", "coarse", "tail")


def make_dataset(
    seed: int, n: int, nq: int, n_leaf: int | None = None,
    profile: str = "default",
) -> tuple[np.ndarray, np.ndarray]:
    """(points[n,32], queries[nq,32]) drawn from the same leaf clusters.

    Default leaf count n//128 keeps the round-1/2 cluster granularity
    (~128 points per leaf at full scale). ``profile`` selects a
    distribution variant (see PROFILES).
    """
    rng = np.random.default_rng(seed)
    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}; known: {PROFILES}")
    p = 0.08
    if profile == "fine":
        n_leaf = n_leaf or max(16, n // 32)
        p = 0.05
    elif profile == "coarse":
        n_leaf = n_leaf or max(16, n // 512)
        p = 0.12
    if n_leaf is None:
        n_leaf = max(16, n // 128)
    leaves = make_leaves(rng, n_leaf)
    pts = make_points(rng, leaves, n, p)
    qs = make_points(rng, leaves, nq, p)
    if profile == "tail":
        # overwrite a random 20% of points with uniform sketches: mass
        # with no cluster structure that the graph must route around
        k = n // 5
        idx = rng.choice(n, size=k, replace=False)
        for s in range(0, k, _CHUNK):
            e = min(s + _CHUNK, k)
            pts[idx[s:e]] = rng.integers(
                0, 2**32, size=(e - s, WORDS), dtype=np.uint32
            )
    return pts, qs
