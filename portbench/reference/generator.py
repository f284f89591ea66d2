"""Seeded 1024-bit sketch data, made on the device in a few large calls.

A torch copy of the hierarchy that ``hnsw_itu_tpu_torch/utils/synth.py``
documents (its numpy stream takes over a minute on the host at 10M
points): 64 uniform roots; 4096 mids, each a random root with every bit
flipped at p=0.12; ``n_leaf`` leaves (default n // 128), each a random
mid flipped at p=0.06; points and queries, each a random leaf flipped at
p=0.08. Sketches are int32[rows, 32] words, bit patterns as the port
takes them. The draw is not bit-equal to the numpy stream; it is frozen
here so that every run of the benchmark sees the same data for a seed.

Three generators are seeded from the seed, one for the hierarchy, one
for the points and one for the queries, so the points do not depend on
how many queries a cell draws and the queries of a cell do not depend on
its points' count beyond the shared leaves.
"""

from __future__ import annotations

import hashlib

import torch

WORDS = 32
BITS = WORDS * 32
ROOTS, MIDS = 64, 4096
P_MID, P_LEAF, P_POINT = 0.12, 0.06, 0.08
_CHUNK = 1 << 18  # rows drawn at once: 1 GiB of float32 uniforms


def substream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(substream_seed(seed, stream))
    return g


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[rows, 1024] -> int32[rows, 32], bit j of word w = bits[32 w + j].
    The shifted bits of a word are distinct powers of two, so their int32
    sum never carries: it is the word's two's-complement value."""
    rows = bits.shape[0]
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    w = bits.view(rows, WORDS, 32).to(torch.int32) << shifts
    return w.sum(dim=2, dtype=torch.int32)


def flips(g: torch.Generator, rows: int, p: float, device) -> torch.Tensor:
    """int32[rows, 32] words with every bit set at probability ``p``."""
    u = torch.rand((rows, BITS), generator=g, device=device)
    return pack_bits(u < p)


def uniform_words(g: torch.Generator, rows: int, device) -> torch.Tensor:
    x = torch.randint(0, 1 << 32, (rows, WORDS), generator=g, device=device,
                      dtype=torch.int64)
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def children(g: torch.Generator, parents: torch.Tensor, rows: int, p: float,
             device) -> torch.Tensor:
    """``rows`` sketches, each a uniformly drawn parent with every bit
    flipped at ``p``; drawn ``_CHUNK`` rows at a time."""
    out = torch.empty((rows, WORDS), dtype=torch.int32, device=device)
    for s in range(0, rows, _CHUNK):
        e = min(rows, s + _CHUNK)
        pick = torch.randint(0, parents.shape[0], (e - s,), generator=g,
                             device=device)
        out[s:e] = parents[pick] ^ flips(g, e - s, p, device)
    return out


def leaves(seed: int, n_leaf: int, device) -> torch.Tensor:
    g = generator(seed, "hierarchy", device)
    roots = uniform_words(g, ROOTS, device)
    mids = children(g, roots, MIDS, P_MID, device)
    return children(g, mids, n_leaf, P_LEAF, device)


def make_data(seed: int, n: int, nq: int, device, n_leaf: int | None = None):
    """(points int32[n, 32], queries int32[nq, 32]) on ``device``, drawn
    from the same leaves."""
    lv = leaves(seed, n_leaf or max(16, n // 128), device)
    pts = children(generator(seed, "points", device), lv, n, P_POINT, device)
    qs = children(generator(seed, "queries", device), lv, nq, P_POINT,
                  device)
    return pts, qs
