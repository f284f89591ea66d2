"""Visited-set primitives: a packed bitmask over node ids (port of
hnsw_itu_tpu/ops/bitset.py).

One bit per node in int32 words: the JAX package's ``uint32`` words with
the same bit patterns, because PyTorch has no CPU ``uint32`` shift (as in
``ops/metrics.py``). Bit 31 of a word is the sign bit: testing it shifts
arithmetically and masks the low bit, and setting it adds ``-2**31``,
which is the same word as the OR while the bit was clear.

Every function works on a leading batch: ``mask`` int32[..., n_words] and
``ids`` [..., C] with the same leading dimensions (one visited set per
query of a batched search).
"""

from __future__ import annotations

import torch

from .metrics import popcount_sum

WORD_BITS = 32


def n_words(capacity: int) -> int:
    return -(-capacity // WORD_BITS)


def make(capacity: int, batch: tuple[int, ...] = (), *,
         device) -> torch.Tensor:
    """An empty mask int32[*batch, n_words(capacity)] on ``device``."""
    return torch.zeros((*batch, n_words(capacity)), dtype=torch.int32,
                       device=device)


def _word_bit(mask: torch.Tensor, ids: torch.Tensor):
    idx = ids.long().clamp(0, mask.shape[-1] * WORD_BITS - 1)
    return idx // WORD_BITS, (idx % WORD_BITS).to(torch.int32)


def contains(mask: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """bool[..., C]: the bits of (possibly invalid or negative) ids.
    Out-of-range ids are clamped; callers mask validity separately."""
    word, bit = _word_bit(mask, ids)
    return ((mask.gather(-1, word) >> bit) & 1) == 1


def insert(mask: torch.Tensor, ids: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """A new mask with the bits of ``ids`` set where ``valid``. The valid
    ids must be unique and not yet set (then the add equals the OR, as in
    the JAX function)."""
    word, bit = _word_bit(mask, ids)
    add = torch.where(valid, torch.ones_like(bit) << bit,
                      torch.zeros_like(bit))
    return mask.scatter_add(-1, word, add)


def count(mask: torch.Tensor) -> torch.Tensor:
    """int32[...]: the number of set bits (``BitSet::len``)."""
    return popcount_sum(mask)
