"""Dense Hamming blocks (port of hnsw_itu_tpu/ops/pallas_hamming.py).

``hamming_block(a, b)`` is popcount(a ^ b) summed over the packed words of
every pair of rows: ``[M, words] x [N, words] -> int32[M, N]``, or, batched
over a leading axis, ``[P, M, words] x [P, N, words] -> int32[P, M, N]``
(one block per leading index: the build computes one per candidate list).
Any M and N: the TPU kernel's 128x128 tiling and its ``_padded`` wrapper
are TPU layout and are not carried over.

For CUDA tensors the wrapper launches ``csrc/hamming_block.cu``; for CPU
tensors it runs ``hamming_block_plain``, the SWAR popcount of
``ops/metrics.py``; any other device raises. There is no fallback between
the two. ``hamming_block.kernel_launches`` and ``hamming_block.plain_calls``
count the two routes.
"""

from __future__ import annotations

import torch

from . import _kernels
from .metrics import popcount_sum

MAX_WORDS = 64  # widest sketch the kernel stages in shared memory
# rows and blocks the C entry's int arguments carry (its persistent grid
# walks any number of tiles)
_MAX_ROWS = 2**31 - 1
_PLAIN_ELEMS = 1 << 23  # word pairs per pass of the plain version


def _check_inputs(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"sketches must be int32, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError("a and b must both be [M, words] or [P, M, words]")
    if a.shape[-1] != b.shape[-1] or (a.dim() == 3 and
                                      a.shape[0] != b.shape[0]):
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} "
                         "differ in words or batch")


def _check_launch(a: torch.Tensor, b: torch.Tensor) -> None:
    """What the kernel takes beyond ``_check_inputs``: contiguous rows of
    1 to ``MAX_WORDS`` words, and at most ``_MAX_ROWS`` rows in a, in b
    and blocks in the batch."""
    _check_inputs(a, b)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    words = a.shape[-1]
    if not 1 <= words <= MAX_WORDS:
        raise ValueError(f"words={words} outside [1, {MAX_WORDS}]")
    for what, size in (("rows of a", a.shape[-2]), ("rows of b", b.shape[-2]),
                       ("blocks", a.shape[0] if a.dim() == 3 else 1)):
        if size > _MAX_ROWS:
            raise ValueError(f"{size} {what} > {_MAX_ROWS}")


def hamming_block_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch route on any device: XOR + SWAR popcount, in
    passes of at most ``_PLAIN_ELEMS`` word pairs so the int64
    temporaries stay small."""
    _check_inputs(a, b)
    flat = a.dim() == 2
    if flat:
        a, b = a[None], b[None]
    P, M, words = a.shape
    N = b.shape[1]
    out = torch.empty((P, M, N), dtype=torch.int32, device=a.device)
    rows = max(1, _PLAIN_ELEMS // max(1, N * words))  # (p, i) rows a pass
    if rows >= M:
        step = rows // M
        for p in range(0, P, step):
            out[p : p + step] = popcount_sum(
                a[p : p + step, :, None, :] ^ b[p : p + step, None, :, :])
    else:
        for p in range(P):
            for i in range(0, M, rows):
                out[p, i : i + rows] = popcount_sum(
                    a[p, i : i + rows, None, :] ^ b[p, None, :, :])
    return out[0] if flat else out


def hamming_block(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distances of every row of ``a`` to every row of ``b``:
    ``[M, words] x [N, words] -> int32[M, N]`` or ``[P, M, words] x
    [P, N, words] -> int32[P, M, N]``."""
    if a.device.type == "cpu":
        _kernels.count(hamming_block, "plain_calls")
        return hamming_block_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no hamming block for {a.device}")
    _check_launch(a, b)
    out = torch.empty((*a.shape[:-1], b.shape[-2]), dtype=torch.int32,
                      device=a.device)
    if out.numel() == 0:
        return out
    _kernels.launch_hamming_block(a, b, out)
    _kernels.count(hamming_block, "kernel_launches")
    return out


hamming_block.kernel_launches = 0
hamming_block.plain_calls = 0
