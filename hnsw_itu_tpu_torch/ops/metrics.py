"""Distance metrics (port of hnsw_itu_tpu/ops/metrics.py).

A metric is a ``Metric`` object with the JAX interface: ``name``,
``dist_dtype``, ``inf`` (the +infinity sentinel of ``dist_dtype``),
``max_distance``, and batched distance functions in torch idiom:

* ``one_to_many(q, pts)``: q [..., D] against pts [..., C, D] -> [..., C]
  (the JAX function is written for one query and ``vmap``-ed; here the
  leading axes broadcast);
* ``pairwise(a, b)``: [..., M, D] x [..., N, D] -> [..., M, N];
* ``pairwise_mxu(a, b)``: the same block as a matrix product where one
  exists (the JAX name of the dense-block route);
* ``pairwise_block(a, b)``: the build's select and prune blocks, which is
  ``pairwise_mxu`` except for Hamming (the dense Hamming kernel).

Sketches are 1024-bit, held as ``int32[..., 32]``: the JAX package's
``uint32`` words with the same bit patterns (``np.uint32`` viewed as
``np.int32``), because PyTorch has no CPU ``uint32`` shift. PyTorch has no
popcount either, so ``popcount`` counts each word's bits with SWAR
arithmetic in int32.

Hamming's ``pairwise_mxu`` is the bit-unpack identity ``ham(a, b) = pop(a)
+ pop(b) - 2 <bits_a, bits_b>`` as one matrix product. Exactness matters
here (the entry argmin and the oracle compare integers): the product runs
on float32 operands with TF32 switched off, because every partial sum is
an integer <= 1024 that float32 holds exactly. A bf16 product would round
its bf16 result. ``SquaredL2.pairwise_mxu`` is the norm expansion in the
same full float32.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..utils.instrument import to_device

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def as_sketches(x, device) -> torch.Tensor:
    """numpy ``uint32``/``int32`` sketches or an int32 tensor -> an int32
    tensor on ``device`` (bit patterns unchanged)."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            raise TypeError(f"sketch tensors are int32, got {x.dtype}")
        return to_device(x, device)
    a = np.ascontiguousarray(x)
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"sketch arrays are uint32 or int32, got {a.dtype}")
    return to_device(torch.from_numpy(a.view(np.int32)), device)


def as_points(x, device) -> torch.Tensor:
    """Points of any metric as a tensor on ``device``: a tensor keeps its
    dtype; numpy ``uint32`` words become int32 with the same bits, other
    integers int32 and floats float32 (the dtypes the JAX package holds
    with 64-bit types off)."""
    if isinstance(x, torch.Tensor):
        return to_device(x, device)
    a = np.ascontiguousarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
        a = a.astype(np.int32)
    elif np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    else:
        raise TypeError(f"points of dtype {a.dtype} are not supported")
    return to_device(torch.from_numpy(a), device)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words -> int32. The sign bit is
    counted apart, so the SWAR steps run on values below 2^31; the byte
    counts are folded by shifts and adds (no multiply), so no intermediate
    overflows int32."""
    v = x & 0x7FFFFFFF
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    v = v + (v >> 8)
    v = v + (v >> 16)
    return (v & 0x3F) + (x < 0).to(torch.int32)


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
    """Exact int32 [..., M, N] dot products of two float32 0/1 bit
    tables."""
    with exact_fp32_matmul():
        return torch.matmul(a_bits, b_bits.transpose(-1, -2)).to(torch.int32)


INT32_INF = np.iinfo(np.int32).max

# elements of one [..., m, N, D] difference block of a direct pairwise
_BLOCK_ELEMS = 1 << 26


def _row_blocks(fn, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``fn(a, b)`` -> [..., M, N] over blocks of a's M rows, so a direct
    [..., m, N, D] difference stays under ``_BLOCK_ELEMS`` elements."""
    per_row = math.prod(a.shape[:-2]) * b.shape[-2] * a.shape[-1]
    step = max(1, _BLOCK_ELEMS // max(1, per_row))
    M = a.shape[-2]
    if step >= M:
        return fn(a, b)
    return torch.cat([fn(a[..., s : s + step, :], b)
                      for s in range(0, M, step)], dim=-2)


class Metric:
    """A batched distance family (the JAX ``Metric``). Subclasses give at
    least ``one_to_many``; ``pairwise``, ``pairwise_mxu`` and
    ``pairwise_block`` have working defaults, and ``max_distance`` may
    return a static bound, which enables packed (distance, id) sort keys
    in the general beam search. Distances are int32 unless
    ``dist_dtype`` says otherwise."""

    dist_dtype = torch.int32
    inf = INT32_INF  # the +infinity sentinel of dist_dtype

    def __init__(self, name: str):
        self.name = name

    def max_distance(self, q: torch.Tensor) -> int | None:
        """Static upper bound on distances for this query shape, or None
        when unbounded."""
        return None

    def one_to_many(self, q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        """q [..., D] against pts [..., C, D] -> [..., C]."""
        raise NotImplementedError

    def pairwise(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """[..., M, D] x [..., N, D] -> [..., M, N]: ``one_to_many`` of
        every row of ``a`` against all of ``b``."""
        def block(x, y):
            return self.one_to_many(x, y.unsqueeze(-3).expand(
                *x.shape[:-1], *y.shape[-2:]))
        return _row_blocks(block, a, b)

    def pairwise_mxu(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Dense blocks as a matrix product where the metric has one;
        ``pairwise`` otherwise."""
        return self.pairwise(a, b)

    def pairwise_block(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The build's select-neighbors and prune blocks, [..., M, N]."""
        return self.pairwise_mxu(a, b)


class Hamming(Metric):
    """XOR + popcount over packed int32 words."""

    dist_dtype = torch.int32
    inf = INT32_INF

    def __init__(self):
        super().__init__(name="hamming")

    def max_distance(self, q: torch.Tensor) -> int:
        """All bits of the query's words."""
        return int(q.shape[-1]) * 32

    def one_to_many(self, q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        return popcount_sum(pts ^ q.unsqueeze(-2))

    def pairwise(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """[..., M, W] x [..., N, W] -> int32 [..., M, N] by XOR +
        popcount."""
        return popcount_sum(a.unsqueeze(-2) ^ b.unsqueeze(-3))

    def pairwise_mxu(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """[..., M, W] x [..., N, W] -> int32 [..., M, N] as one exact
        matrix product."""
        dots = bit_dots(unpack_bits(a), unpack_bits(b))
        return (popcount_sum(a).unsqueeze(-1) + popcount_sum(b).unsqueeze(-2)
                - 2 * dots)

    def pairwise_block(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """[M, W] x [N, W] -> int32 [M, N], or batched [P, M, W] x
        [P, N, W] -> [P, M, N], through ``ops/hamming.py`` (the dense
        Hamming kernel on the card). The oracle and ``sampled_entry_topk``
        keep ``pairwise_mxu``; the sampled entry has its own kernel
        (``ops/entry.py``)."""
        from .hamming import hamming_block

        return hamming_block(a, b)


class SquaredL2Int(Metric):
    """Integer squared L2 in int32 (the Point3D metric of the reference's
    generic path); products and sums wrap as the JAX int32 ones do."""

    def __init__(self):
        super().__init__(name="l2int")

    def one_to_many(self, q, pts):
        d = pts.to(torch.int32) - q.to(torch.int32).unsqueeze(-2)
        return (d * d).sum(dim=-1, dtype=torch.int32)

    def pairwise(self, a, b):
        def block(x, y):
            d = x.to(torch.int32).unsqueeze(-2) - y.to(torch.int32).unsqueeze(-3)
            return (d * d).sum(dim=-1, dtype=torch.int32)
        return _row_blocks(block, a, b)


class SquaredL2(Metric):
    """float32 squared L2; dense blocks by the norm expansion."""

    dist_dtype = torch.float32
    inf = float("inf")

    def __init__(self):
        super().__init__(name="l2")

    def one_to_many(self, q, pts):
        d = pts - q.unsqueeze(-2)
        return (d * d).sum(dim=-1)

    def pairwise(self, a, b):
        def block(x, y):
            d = x.unsqueeze(-2) - y.unsqueeze(-3)
            return (d * d).sum(dim=-1)
        return _row_blocks(block, a, b)

    def pairwise_mxu(self, a, b):
        """|a|^2 + |b|^2 - 2 a.b as one full-float32 matrix product,
        clamped at 0."""
        na = (a * a).sum(dim=-1)
        nb = (b * b).sum(dim=-1)
        with exact_fp32_matmul():
            ab = torch.matmul(a, b.transpose(-1, -2))
        return (na.unsqueeze(-1) + nb.unsqueeze(-2) - 2.0 * ab).clamp(min=0.0)


HAMMING = Hamming()
L2INT = SquaredL2Int()
L2 = SquaredL2()

_REGISTRY = {m.name: m for m in (HAMMING, L2INT, L2)}


def get_metric(name: str) -> Metric:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown metric {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def register_metric(metric: Metric, *, overwrite: bool = False) -> Metric:
    """Register a user metric under ``metric.name``: the extension point of
    the reference's generic ``Point`` trait. A metric is a ``Metric``
    subclass giving at least ``one_to_many`` in the batched form above.
    After registration the name works everywhere a built-in does:
    builders (``NSWBuilder(opts, metric="myname", device=...)``),
    ``Bruteforce`` and ``.npz`` round trips (the file stores the name).

    ``overwrite=True`` replaces a registered metric. The JAX package then
    clears its compiled executables, which bake a metric in by name; the
    port compiles nothing per metric, so replacing just rebinds the name.
    Objects made afterwards resolve the new metric; an index made before
    keeps the metric object it holds. Returns the metric for chaining.
    See ``hnsw_itu_tpu_torch/examples/custom_metric.py``."""
    if not isinstance(metric, Metric):
        raise TypeError("register_metric expects a Metric instance")
    if not metric.name or not isinstance(metric.name, str):
        raise ValueError("metric.name must be a non-empty string")
    if metric.name in _REGISTRY and not overwrite:
        raise ValueError(
            f"metric {metric.name!r} already registered "
            "(pass overwrite=True to replace)"
        )
    _REGISTRY[metric.name] = metric
    return metric


SKETCH_WORDS = 32  # 1024-bit sketches in 32-bit words


def sketches_from_u64(rows) -> np.ndarray:
    """[N, 16] uint64 HDF5 rows -> [N, 32] int32 sketches: the JAX
    package's uint32 words (low half first) viewed as int32, so popcounts
    and Hamming distances equal the reference's."""
    rows = np.asarray(rows, dtype=np.uint64)
    out = np.empty((*rows.shape[:-1], rows.shape[-1] * 2), dtype=np.uint32)
    out[..., 0::2] = (rows & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[..., 1::2] = (rows >> np.uint64(32)).astype(np.uint32)
    if out.shape[-1] != SKETCH_WORDS:
        raise ValueError(f"sketches must have {SKETCH_WORDS} uint32 words, "
                         f"got {out.shape[-1]}")
    return out.view(np.int32)


def sketches_to_u64(packed) -> np.ndarray:
    """Inverse of ``sketches_from_u64``: int32 or uint32 words -> uint64
    rows."""
    packed = np.ascontiguousarray(packed)
    if packed.dtype == np.int32:
        packed = packed.view(np.uint32)
    packed = packed.astype(np.uint32, copy=False)
    lo = packed[..., 0::2].astype(np.uint64)
    hi = packed[..., 1::2].astype(np.uint64)
    return lo | (hi << np.uint64(32))
