"""Build and bind the CUDA kernels of ``csrc/`` (nvcc + ctypes).

Nothing is compiled at import. The first launch of a kernel runs

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

into ``hnsw_itu_tpu_torch/build/`` and loads the library with ctypes. The
file name carries a hash of the source and of every local header it
includes (``#include "..."``, followed through ``csrc/``), so an edited
kernel or header is rebuilt and a stale library is never loaded. Every
pointer and the stream pass as ``ctypes.c_void_p``; the C entry returns
``cudaGetLastError()`` after its launch, and a nonzero code raises here.
``build_kernels`` builds every source at once, one nvcc process each.
``count`` adds to a wrapper's launch counters under a lock, so that
callers on several threads, and the counts a ``parallel.mesh.CardPool``
brings back from its worker processes, lose none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
FUSED_WORDS = (8, 16, 32, 64)  # sketch widths the kernel is built for

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time, "log": nvcc's output incl. ptxas -v}
BUILD_INFO: dict[str, dict] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


def count(fn, counter: str, n: int = 1) -> None:
    """Add ``n`` to ``fn.<counter>`` (``kernel_launches`` or
    ``plain_calls`` of a wrapper) atomically: ``+=`` on an attribute is a
    read, an add and a write, and two threads between them lose a
    count."""
    with _COUNT_LOCK:
        setattr(fn, counter, getattr(fn, counter) + n)


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda, or PATH; raises if none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or add it to PATH")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_digest(src: str) -> str:
    """sha256 (12 hex digits) over ``src`` and every local header it
    includes, directly or through another header, looked up beside the
    file that includes it; each file is hashed once, in include order."""
    h = hashlib.sha256()
    todo, seen = [os.path.abspath(src)], set()
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        h.update(os.path.basename(path).encode() + b"\0" + text + b"\0")
        here = os.path.dirname(path)
        todo += [os.path.join(here, m.decode())
                 for m in _INCLUDE.findall(text)
                 if os.path.exists(os.path.join(here, m.decode()))]
    return h.hexdigest()[:12]


def library_path(name: str, csrc: str = CSRC,
                 build_dir: str = BUILD_DIR) -> str:
    """Where the library of ``csrc/<name>.cu`` is built: its file name
    carries ``source_digest`` of the source."""
    digest = source_digest(os.path.join(csrc, f"{name}.cu"))
    return os.path.join(build_dir, f"{name}-{digest}.so")


def _build(name: str, rebuild: bool) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    out = library_path(name)
    if os.path.exists(out) and not rebuild:
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "cached",
                                     "path": out})
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        r = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{r.stderr}")
        os.replace(tmp, out)  # concurrent builders each publish a whole file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "log": r.stdout + r.stderr, "path": out}
    return out


# C entry points of each library: name -> (function, argtypes)
_ENTRIES = {
    "fused_beam_search": ("hnsw_fused_beam_search",
                          [_P] * 7 + [_I] * 8 + [_P]),
    "mini_beam_search": ("hnsw_mini_beam_search",
                         [_P, _I, _P, _I, _P, _P, _P, _P] + [_I] * 7 + [_P]),
    "dma_beam_search": ("hnsw_dma_beam_search",
                        [_P, _I, _P, _I, _P, _I, _I, _P, _I, _P, _P, _P, _P]
                        + [_I] * 3 + [_P]),
    "hamming_block": ("hnsw_hamming_block", [_P] * 3 + [_I] * 4 + [_P]),
    "exact_rerank": ("hnsw_exact_rerank",
                     [_P, _I, _I, _P, _P, _I, _I, _P] + [_I] * 4
                     + [_P] * 3),
    "sampled_entry": ("hnsw_sampled_entry", [_P, _I, _I, _P] + [_I] * 3
                      + [_P] * 2),
}
KERNELS = tuple(_ENTRIES)
# the beam kernels also export hnsw_<name>_warps(ef, W): the resident warps
# per SM of the instance that serves (ef, W)
_BEAM = ("fused_beam_search", "mini_beam_search", "dma_beam_search")


def _load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(_build(name, rebuild=False))
            fn, argtypes = _ENTRIES[name]
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
            if name in _BEAM:
                warps = getattr(lib, f"hnsw_{name}_warps")
                warps.argtypes, warps.restype = [_I, _I], _I
            lib.hnsw_cuda_error_string.argtypes = [_I]
            lib.hnsw_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def build_kernels(rebuild: bool = False) -> None:
    """Build every kernel of ``csrc/`` at once, one nvcc process per
    source, all started together, then load them. ``rebuild`` compiles
    anew even where a build of the same source exists (before the first
    load only)."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(lambda n: _build(n, rebuild), KERNELS))
    for name in KERNELS:
        _load(name)


def resident_warps(name: str, ef: int, W: int) -> int:
    """Resident warps per SM of the beam kernel ``name``'s instance for
    (ef, W), as the CUDA occupancy calculator gives them."""
    return getattr(_load(name), f"hnsw_{name}_warps")(ef, W)


def _check_rc(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.hnsw_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {rc} ({msg})")


def launch_fused_beam_search(queries, init_keys, ids, data, out_keys,
                             out_visited, out_steps, *, ef: int,
                             id_bits: int, key_inf: int,
                             max_steps: int) -> None:
    """Launch the kernel on the current stream of the queries' device.
    The caller has checked dtypes, shapes and contiguity."""
    words = queries.shape[1]
    if words not in FUSED_WORDS:
        raise ValueError(f"fused kernel built for words in {FUSED_WORDS}, "
                         f"got {words}")
    if data.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("fused kernel needs 16-byte aligned data/queries")
    lib = _load("fused_beam_search")
    dev = queries.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        cap, W = ids.shape
        rc = lib.hnsw_fused_beam_search(
            queries.data_ptr(), init_keys.data_ptr(), ids.data_ptr(),
            data.data_ptr(), out_keys.data_ptr(), out_visited.data_ptr(),
            out_steps.data_ptr(), queries.shape[0], cap, W, words, ef,
            id_bits, key_inf, max_steps, stream,
        )
    _check_rc(lib, rc, "fused_beam_search")


def launch_mini_beam_search(queries, init_keys, table, out_keys,
                            out_visited, out_steps, *, ef: int,
                            tie_bits: int, max_steps: int) -> None:
    """Launch the mini kernel on the current stream of the queries'
    device: ``init_keys`` int64[B, E] ascending, ``out_keys`` int64[B, ef].
    The caller has checked dtypes, shapes and contiguity."""
    if table.data_ptr() % 16:
        raise ValueError("mini kernel needs a 16-byte aligned table")
    lib = _load("mini_beam_search")
    dev = queries.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        cap, W, mv = table.shape
        rc = lib.hnsw_mini_beam_search(
            queries.data_ptr(), queries.shape[1], init_keys.data_ptr(),
            init_keys.shape[1], table.data_ptr(), out_keys.data_ptr(),
            out_visited.data_ptr(), out_steps.data_ptr(), queries.shape[0],
            cap, W, mv, ef, tie_bits, max_steps, stream,
        )
    _check_rc(lib, rc, "mini_beam_search")


def launch_dma_beam_search(queries, init_keys, adj, points, node_map,
                           out_keys, out_visited, out_steps, *, ef: int,
                           max_steps: int) -> None:
    """Launch the gather beam-search kernel on the current stream of the
    queries' device: ``init_keys`` int64[B, E] ascending, ``out_keys``
    int64[B, ef], ``node_map`` an int32 tensor or None (identity). The
    caller has checked dtypes, shapes and contiguity."""
    if points.data_ptr() % 16:
        raise ValueError("gather kernel needs 16-byte aligned points")
    lib = _load("dma_beam_search")
    dev = queries.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        cap, W = adj.shape
        rc = lib.hnsw_dma_beam_search(
            queries.data_ptr(), queries.shape[1], init_keys.data_ptr(),
            init_keys.shape[1], adj.data_ptr(), cap, W, points.data_ptr(),
            points.shape[0], None if node_map is None else node_map.data_ptr(),
            out_keys.data_ptr(), out_visited.data_ptr(), out_steps.data_ptr(),
            queries.shape[0], ef, max_steps, stream,
        )
    _check_rc(lib, rc, "dma_beam_search")


def launch_hamming_block(a, b, out) -> None:
    """Launch the Hamming block kernel on the current stream of ``a``'s
    device: ``a`` int32[(P,) M, words], ``b`` int32[(P,) N, words],
    ``out`` int32[(P,) M, N]. The caller has checked dtypes, shapes and
    contiguity."""
    lib = _load("hamming_block")
    dev = a.device
    P = a.shape[0] if a.dim() == 3 else 1
    M, words = a.shape[-2:]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hnsw_hamming_block(a.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), P, M, b.shape[-2], words,
                                    stream)
    _check_rc(lib, rc, "hamming_block")


def launch_exact_rerank(points, queries, cand_ids, adj, out_d, out_i, *,
                        seeds: int, dedup: bool) -> None:
    """Launch the exact rerank kernel on the current stream of the
    queries' device: ``out_d`` / ``out_i`` int32[B, kout]; ``adj`` is read
    only when ``seeds`` > 0 (then <= H). The caller has checked dtypes,
    shapes and contiguity."""
    lib = _load("exact_rerank")
    dev = queries.device
    B, H = cand_ids.shape
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hnsw_exact_rerank(
            points.data_ptr(), points.shape[0], points.shape[1],
            queries.data_ptr(), cand_ids.data_ptr(), B, H,
            None if adj is None else adj.data_ptr(),
            0 if adj is None else adj.shape[1], seeds, int(dedup),
            out_d.shape[1], out_d.data_ptr(), out_i.data_ptr(), stream,
        )
    _check_rc(lib, rc, "exact_rerank")


def launch_sampled_entry(points, queries, out, *, n: int,
                         sample_size: int) -> None:
    """Launch the sampled entry kernel on the current stream of the
    queries' device: ``out`` int32[B], the id of each query's nearest
    point among the ``sample_size`` strided sample of ``points[:n]``. The
    caller has checked dtypes, shapes and contiguity."""
    lib = _load("sampled_entry")
    dev = queries.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hnsw_sampled_entry(
            points.data_ptr(), points.shape[0], points.shape[1],
            queries.data_ptr(), queries.shape[0], n, sample_size,
            out.data_ptr(), stream,
        )
    _check_rc(lib, rc, "sampled_entry")
