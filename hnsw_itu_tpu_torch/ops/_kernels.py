"""Build and bind the CUDA kernels of ``csrc/`` (nvcc + ctypes).

Nothing is compiled at import. The first launch runs

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

into ``hnsw_itu_tpu_torch/build/`` and loads the library with ctypes. The
file name carries a hash of the source, so an edited kernel is rebuilt and
a stale library is never loaded. Every pointer and the stream pass as
``ctypes.c_void_p``; the C entry returns ``cudaGetLastError()`` after its
launch, and a nonzero code raises here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
FUSED_WORDS = (8, 16, 32, 64)  # sketch widths the kernel is built for

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time, "log": nvcc's output incl. ptxas -v}
BUILD_INFO: dict[str, dict] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda, or PATH; raises if none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or add it to PATH")
    return found


def _build(name: str, rebuild: bool) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    if os.path.exists(out) and not rebuild:
        BUILD_INFO[name] = {"seconds": 0.0, "log": "cached", "path": out}
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


def load_fused_beam_search(rebuild: bool = False) -> ctypes.CDLL:
    """The kernel library, built on first use; ``rebuild`` compiles it
    anew even when a build of the same source exists (before the first
    load only)."""
    with _LOCK:
        lib = _LIBS.get("fused_beam_search")
        if lib is None:
            lib = ctypes.CDLL(_build("fused_beam_search", rebuild))
            lib.hnsw_fused_beam_search.argtypes = [
                _P, _P, _P, _P, _P, _P, _P,
                _I, _I, _I, _I, _I, _I, _I, _I, _P,
            ]
            lib.hnsw_fused_beam_search.restype = _I
            lib.hnsw_cuda_error_string.argtypes = [_I]
            lib.hnsw_cuda_error_string.restype = ctypes.c_char_p
            _LIBS["fused_beam_search"] = lib
        return lib


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
    lib = load_fused_beam_search()
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
    if rc != 0:
        msg = lib.hnsw_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_beam_search launch failed: {rc} ({msg})")
