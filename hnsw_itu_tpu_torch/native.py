"""ctypes bindings for the native host runtime (native/hnsw_host.cpp).

A copy of hnsw_itu_tpu/native.py, reduced to what the port calls and with
every ``argtypes`` declared. It loads the same ``native/libhnsw_host.so``:
``make -C native`` builds it (a no-op when it is fresh); where ``make`` is
missing, ``g++`` is called with the Makefile's flags. With neither, ``load``
raises. Exposes:

* ``host_build``      — exact-reference-semantics sequential inserts into
                        one flat graph (the NSW host warmup)
* ``host_build_hnsw`` — the same with the full hierarchy (the HNSW host
                        warmup, and the whole build with ``host_warmup >=
                        size``)
* ``host_knns``       — multithreaded batch search, one entry per query
                        (the CLI's ``-S`` query route)
* ``host_bruteforce`` — exact scan oracle
* ``hamming``         — scalar distance golden hook
* ``available``       — whether the library loads here
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
_SRC = os.path.join(_NATIVE_DIR, "hnsw_host.cpp")
_SO = os.environ.get(
    "HNSW_TPU_NATIVE_SO", os.path.join(_NATIVE_DIR, "libhnsw_host.so")
)
# native/Makefile's CXXFLAGS and link line
_GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
              "-shared"]

METRIC_CODE = {"hamming": 0, "l2int": 1}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64


def _build_lib() -> None:
    if shutil.which("make"):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, text=True)
        return
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "cannot build native/libhnsw_host.so: neither make nor g++ found"
        )
    fresh = (os.path.exists(_SO)
             and os.path.getmtime(_SO) >= os.path.getmtime(_SRC))
    if fresh:
        return
    # compile beside the target and rename: a concurrent loader sees either
    # no library or a whole one
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_NATIVE_DIR)
    os.close(fd)
    try:
        subprocess.run([gxx, *_GXX_FLAGS, "-o", tmp, _SRC, "-lpthread"],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        _build_lib()
        lib = ctypes.CDLL(_SO)
        lib.hnsw_host_abi_version.argtypes = []
        lib.hnsw_host_abi_version.restype = _I32
        if lib.hnsw_host_abi_version() != 3:
            raise RuntimeError("hnsw_host ABI mismatch")
        lib.hnsw_host_hamming.argtypes = [_P, _P, _I32]
        lib.hnsw_host_hamming.restype = _I32
        lib.hnsw_host_build.argtypes = [
            _P, _I32, _I32, _P, _P, _I64, _I32, _I64, _I64, _I32, _I32, _I32,
        ]
        lib.hnsw_host_build.restype = _I64
        lib.hnsw_host_build_hnsw.argtypes = [
            _P, _I32, _I32, _P, _P, _I64, _I32, _I64, _I64, _I32, _I32, _P,
            _I32, _P, _P, _P, _P, _P, _P, _P,
        ]
        lib.hnsw_host_build_hnsw.restype = _I64
        lib.hnsw_host_knns_eps.argtypes = [
            _P, _I32, _I32, _P, _P, _I64, _I32, _I64, _P, _I64, _I32, _I32,
            _P, _I32, _I32, _P, _P,
        ]
        lib.hnsw_host_knns_eps.restype = _I64
        lib.hnsw_host_bruteforce.argtypes = [
            _P, _I32, _I32, _I64, _P, _I64, _I32, _I32, _P, _P,
        ]
        lib.hnsw_host_bruteforce.restype = _I64
        _LIB = lib
        return lib


def available() -> bool:
    """Whether the native library builds and loads on this machine."""
    try:
        return load() is not None
    except Exception:
        return False


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _check(a: np.ndarray, dtype, name: str) -> None:
    if a.dtype != dtype or not a.flags.c_contiguous:
        raise ValueError(f"{name} must be C-contiguous {np.dtype(dtype)}")


def hamming(a: np.ndarray, b: np.ndarray) -> int:
    lib = load()
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.uint32)
    if a.size != b.size:
        raise ValueError("hamming: operands differ in length")
    return int(lib.hnsw_host_hamming(_ptr(a), _ptr(b), a.size))


def host_build(points: np.ndarray, metric: str, adj: np.ndarray,
               deg: np.ndarray, n0: int, n1: int, m: int, efc: int,
               ep: int) -> int:
    """Insert points [n0, n1) sequentially into one flat graph; mutates
    ``adj``/``deg`` in place. Returns the number inserted."""
    lib = load()
    _check(adj, np.int32, "adj")
    _check(deg, np.int32, "deg")
    points = np.ascontiguousarray(points)
    if adj.shape[0] < n1 or points.shape[0] < n1:
        raise ValueError("host_build: arrays shorter than n1")
    r = lib.hnsw_host_build(
        _ptr(points), points.shape[1], METRIC_CODE[metric], _ptr(adj),
        _ptr(deg), adj.shape[0], adj.shape[1], n0, n1, m, efc, ep,
    )
    if r < 0:
        raise ValueError("hnsw_host_build: bad arguments")
    return int(r)


def host_build_hnsw(points: np.ndarray, metric: str, adj: np.ndarray,
                    deg: np.ndarray, n0: int, n1: int, m: int, efc: int,
                    draws: np.ndarray, level_caps: list[int],
                    lvl_node_ids: np.ndarray, lvl_down: np.ndarray,
                    lvl_adj: np.ndarray, lvl_deg: np.ndarray,
                    level_ns: np.ndarray, ep: int) -> tuple[int, int]:
    """Full-hierarchy sequential inserts of [n0, n1) (hnsw.rs:183-244).
    ``draws`` int32[n1] are pre-drawn per-point levels; level arrays are
    concatenated per-level buffers sized by ``level_caps`` (adj rows have
    the base width). Mutates everything in place; returns (inserted,
    new_ep)."""
    lib = load()
    for name, a in (("adj", adj), ("deg", deg), ("draws", draws),
                    ("lvl_node_ids", lvl_node_ids), ("lvl_down", lvl_down),
                    ("lvl_adj", lvl_adj), ("lvl_deg", lvl_deg)):
        _check(a, np.int32, name)
    _check(level_ns, np.int64, "level_ns")
    points = np.ascontiguousarray(points)
    if adj.shape[0] < n1 or points.shape[0] < n1 or draws.shape[0] < n1:
        raise ValueError("host_build_hnsw: arrays shorter than n1")
    caps = np.asarray(level_caps, np.int64)
    if lvl_adj.shape != (int(caps.sum()), adj.shape[1]):
        raise ValueError("host_build_hnsw: level buffers do not match caps")
    ep_io = np.asarray([ep], np.int64)
    r = lib.hnsw_host_build_hnsw(
        _ptr(points), points.shape[1], METRIC_CODE[metric],
        _ptr(adj), _ptr(deg), adj.shape[0], adj.shape[1], n0, n1, m, efc,
        _ptr(draws), len(level_caps), _ptr(caps),
        _ptr(lvl_node_ids), _ptr(lvl_down), _ptr(lvl_adj), _ptr(lvl_deg),
        _ptr(level_ns), _ptr(ep_io),
    )
    if r < 0:
        raise ValueError("hnsw_host_build_hnsw: bad arguments")
    return int(r), int(ep_io[0])


def host_knns(points: np.ndarray, metric: str, adj: np.ndarray,
              deg: np.ndarray, n: int, queries: np.ndarray, k: int, ef: int,
              ep: int = 0, threads: int = 0, eps: np.ndarray | None = None):
    """Batch k-NN on the host engine: (dists, ids) int32[nq, k].
    ``eps`` (int32[nq]) gives each query its entry (the HNSW level
    descent's hook); else ``ep`` seeds every query."""
    lib = load()
    points = np.ascontiguousarray(points)
    queries = np.ascontiguousarray(queries, points.dtype)
    adj = np.ascontiguousarray(adj, np.int32)
    deg = np.ascontiguousarray(deg, np.int32)
    nq = queries.shape[0]
    out_ids = np.empty((nq, k), np.int32)
    out_dists = np.empty((nq, k), np.int32)
    eps_ptr = None
    if eps is not None:
        eps = np.ascontiguousarray(eps, np.int32)
        if eps.shape != (nq,):
            raise ValueError(f"host_knns: eps of shape {eps.shape} for {nq} "
                             "queries")
        eps_ptr = _ptr(eps)
    r = lib.hnsw_host_knns_eps(
        _ptr(points), points.shape[1], METRIC_CODE[metric], _ptr(adj),
        _ptr(deg), adj.shape[0], adj.shape[1], n, _ptr(queries), nq, k, ef,
        eps_ptr, ep, threads, _ptr(out_ids), _ptr(out_dists),
    )
    if r < 0:
        raise ValueError("hnsw_host_knns: bad arguments")
    return out_dists, out_ids


def host_bruteforce(points: np.ndarray, metric: str, queries: np.ndarray,
                    k: int, threads: int = 0):
    """Exact (dists, ids) int32[nq, k] on the host."""
    lib = load()
    points = np.ascontiguousarray(points)
    queries = np.ascontiguousarray(queries, points.dtype)
    if queries.shape[1] != points.shape[1]:
        raise ValueError("host_bruteforce: query and point widths differ")
    nq = queries.shape[0]
    out_ids = np.empty((nq, k), np.int32)
    out_dists = np.empty((nq, k), np.int32)
    r = lib.hnsw_host_bruteforce(
        _ptr(points), points.shape[1], METRIC_CODE[metric], points.shape[0],
        _ptr(queries), nq, k, threads, _ptr(out_ids), _ptr(out_dists),
    )
    if r < 0:
        raise ValueError("hnsw_host_bruteforce: bad arguments")
    return out_dists, out_ids
