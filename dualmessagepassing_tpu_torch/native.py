"""ctypes loader for the native host kernels (csrc/hostkernels.cpp), as
dualmessagepassing_tpu/native.py:31-121 has it.

The library is compiled with g++ -O3 on first use into build/torch_kernels/
(ops/build.py), never into the JAX package. Four entry points are bound:
the two samplers of the UNC export path, and the subgraph-isomorphism
enumerator and edge-weight counter of the SCM data (data/subiso.py).
Every call site keeps its numpy fallback, exactly as the JAX package
does, so a machine without a compiler runs numpy with the same
semantics (`available()` says which one runs).
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
    lib.enumerate_subiso.restype = i64
    lib.enumerate_subiso.argtypes = [
        i64, i64, i64, _i64p, _i64p, _i64p,
        i64, _i64p, _i64p, _i64p, _i64p, _i64p,
        i64, ctypes.c_void_p]
    lib.edge_subiso_weights.restype = None
    lib.edge_subiso_weights.argtypes = [
        i64, _i64p, _i64p, _i64p,
        i64, _i64p, _i64p, _i64p, i64,
        i64, i64, _i64p, _i64p]
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


def enumerate_subiso_native(p_src, p_dst, p_el, p_vl,
                            g_src, g_dst, g_el, g_vl,
                            max_count: int = 1_000_000):
    """All injective label-preserving node mappings [n_iso, n_p] (int64),
    found by the C++ backtracking search; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    n_p, n_g = len(p_vl), len(g_vl)
    p_src, p_dst, p_el, g_src, g_dst, g_el, p_vl, g_vl = [
        np.ascontiguousarray(x, np.int64)
        for x in (p_src, p_dst, p_el, g_src, g_dst, g_el, p_vl, g_vl)]
    args = (n_p, n_g, len(p_src), p_src, p_dst, p_el, len(g_src), g_src,
            g_dst, g_el, p_vl, g_vl)
    n = lib.enumerate_subiso(*args, max_count, None)     # count first
    out = np.zeros((n, n_p), np.int64)
    if n:
        lib.enumerate_subiso(*args, n, out.ctypes.data_as(ctypes.c_void_p))
    return out


def edge_subiso_weights_native(p_src, p_dst, p_el, g_src, g_dst, g_el,
                               num_g_nodes: int, mappings):
    """Per graph edge, how many (mapping, pattern edge) pairs land on it;
    None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    p_src, p_dst, p_el, g_src, g_dst, g_el = [
        np.ascontiguousarray(x, np.int64)
        for x in (p_src, p_dst, p_el, g_src, g_dst, g_el)]
    mappings = np.ascontiguousarray(mappings, np.int64)
    out = np.zeros(len(g_src), np.int64)
    if mappings.size and len(p_src):
        lib.edge_subiso_weights(
            len(p_src), p_src, p_dst, p_el,
            len(g_src), g_src, g_dst, g_el, num_g_nodes,
            mappings.shape[0], mappings.shape[1], mappings, out)
    return out


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
