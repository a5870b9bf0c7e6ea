"""ctypes loader for the native host sampler (csrc/hostkernels.cpp), as
dualmessagepassing_tpu/native.py:31-61 has it.

The library is compiled with g++ -O3 on first use into build/torch_kernels/
(ops/build.py), never into the JAX package. Only the two sampler entry
points of the export path are bound. Every call site in unc/data.py keeps
its numpy fallback, exactly as the JAX package does, so a machine without
a compiler samples in numpy with the same semantics (`available()` says
which one runs).
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from typing import Optional

import numpy as np

from .ops.build import REPO_ROOT, build_shared_library

_SRC = REPO_ROOT / "csrc" / "hostkernels.cpp"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _build() -> Optional[ctypes.CDLL]:
    if not _SRC.exists():
        return None
    try:
        path, _, _ = build_shared_library(
            ["g++", "-O3", "-shared", "-fPIC"], _SRC, "_hostkernels.so")
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    lib = ctypes.CDLL(str(path))
    i64, u64 = ctypes.c_int64, ctypes.c_uint64
    lib.sample_in_edges.restype = i64
    lib.sample_in_edges.argtypes = [_i64p, _i64p, i64, _i64p, i64, u64, _i64p]
    lib.random_walks.restype = None
    lib.random_walks.argtypes = [_i64p, _i64p, i64, _i64p, i64, i64, u64,
                                 _i64p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _build()
            _TRIED = True
    return _LIB


def available() -> bool:
    return get_lib() is not None


def sample_in_edges_native(in_ptr, in_order, nodes, width: int, seed: int):
    lib = get_lib()
    if lib is None:
        return None
    in_ptr = np.ascontiguousarray(in_ptr, np.int64)
    in_order = np.ascontiguousarray(in_order, np.int64)
    nodes = np.ascontiguousarray(nodes, np.int64)
    out = np.zeros(len(nodes) * width, np.int64)
    n = lib.sample_in_edges(in_ptr, in_order, len(nodes), nodes, width,
                            seed, out)
    return out[:n]


def random_walks_native(out_ptr, out_order_dst, seeds, depth: int,
                        reps: int, seed: int):
    lib = get_lib()
    if lib is None:
        return None
    out_ptr = np.ascontiguousarray(out_ptr, np.int64)
    out_order_dst = np.ascontiguousarray(out_order_dst, np.int64)
    seeds = np.ascontiguousarray(seeds, np.int64)
    out = np.full((reps, len(seeds), depth + 1), -1, np.int64)
    lib.random_walks(out_ptr, out_order_dst, len(seeds), seeds, depth,
                     reps, seed, out.reshape(-1))
    return out
