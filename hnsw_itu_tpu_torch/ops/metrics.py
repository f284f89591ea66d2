"""Hamming distance on packed sketches (port of hnsw_itu_tpu/ops/metrics.py).

Sketches are 1024-bit, held as ``int32[..., 32]``: the JAX package's
``uint32`` words with the same bit patterns (``np.uint32`` viewed as
``np.int32``), because PyTorch has no CPU ``uint32`` shift. PyTorch has no
popcount either, so ``popcount`` widens each word to int64 and counts its
bits with SWAR arithmetic (no intermediate can overflow there).

``pairwise_mxu`` keeps the JAX name for the dense-block route: the
bit-unpack identity ``ham(a, b) = pop(a) + pop(b) - 2 <bits_a, bits_b>``
as one matrix product. Exactness matters here (the entry argmin and the
oracle compare integers): the product runs on float32 operands with TF32
switched off, because every partial sum is an integer <= 1024 that float32
holds exactly. A bf16 product would round its bf16 result.

Only the Hamming metric is ported in slice 1; ``l2int`` and ``l2`` are on
the ROADMAP.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def as_sketches(x, device) -> torch.Tensor:
    """numpy ``uint32``/``int32`` sketches or an int32 tensor -> an int32
    tensor on ``device`` (bit patterns unchanged)."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            raise TypeError(f"sketch tensors are int32, got {x.dtype}")
        return x.to(device)
    a = np.ascontiguousarray(x)
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"sketch arrays are uint32 or int32, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32)).to(device)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words -> int32."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    return ((v * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def popcount_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of per-word popcounts over the trailing axis -> int32."""
    return popcount(x).sum(dim=-1, dtype=torch.int32)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """int32[..., W] -> float32[..., W*32] of 0/1, least significant bit
    of each word first (the order of the JAX ``unpack_bits_u32``)."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 32).float()


@contextlib.contextmanager
def exact_fp32_matmul():
    """Run float32 matrix products in full float32 (no TF32), restoring
    the caller's setting afterwards."""
    prev_prec = torch.get_float32_matmul_precision()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
        torch.set_float32_matmul_precision(prev_prec)


def bit_dots(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """Exact int32 [M, N] dot products of two float32 0/1 bit tables."""
    with exact_fp32_matmul():
        return (a_bits @ b_bits.T).to(torch.int32)


class Hamming:
    """XOR + popcount over packed int32 words."""

    name = "hamming"

    @staticmethod
    def one_to_many(q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        """q [..., W] against pts [..., C, W] -> int32 [..., C]."""
        return popcount_sum(pts ^ q.unsqueeze(-2))

    @staticmethod
    def pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """[M, W] x [N, W] -> int32 [M, N] by XOR + popcount."""
        return popcount_sum(a[:, None, :] ^ b[None, :, :])

    @staticmethod
    def pairwise_mxu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """[M, W] x [N, W] -> int32 [M, N] as one exact matrix product."""
        dots = bit_dots(unpack_bits(a), unpack_bits(b))
        return popcount_sum(a)[:, None] + popcount_sum(b)[None, :] - 2 * dots


HAMMING = Hamming()

_NOT_PORTED = ("l2int", "l2")


def get_metric(name: str) -> Hamming:
    if name == HAMMING.name:
        return HAMMING
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"metric {name!r} is not ported yet (ROADMAP §1, item 2)"
        )
    raise ValueError(f"unknown metric {name!r}; known: ['hamming']")
