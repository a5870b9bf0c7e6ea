"""Builds the port's native libraries into build/torch_kernels/ at the
root of the checkout (listed in .gitignore), at first use.

Two libraries, both with a plain C interface loaded through ctypes:
  * the CUDA kernels, csrc/segment_kernels.cu of this package, compiled
    by nvcc for sm_90a (Hopper) — a few seconds, since no PyTorch header
    is included;
  * the host sampler, csrc/hostkernels.cpp at the repository root (the
    JAX package's source, read and not edited), compiled by g++.

A library is rebuilt when its source is newer. Each build writes to a
private temporary name and renames it into place, so processes that
build at the same time (pytest-xdist workers) never load a half-written
file.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = PACKAGE_DIR.parent
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"
CUDA_SRC = PACKAGE_DIR / "csrc" / "segment_kernels.cu"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build_shared_library(compiler: List[str], src: Path,
                         name: str) -> Tuple[Path, float, str]:
    """Compile `src` into BUILD_DIR/name unless an up-to-date copy exists.

    Returns (path, seconds spent compiling, compiler output). Raises
    FileNotFoundError or subprocess.CalledProcessError when the compiler
    is missing or fails."""
    out = BUILD_DIR / name
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{name}.{os.getpid()}.{threading.get_ident()}"
    t0 = time.perf_counter()
    proc = subprocess.run([*compiler, "-o", str(tmp), str(src)],
                          check=True, capture_output=True, text=True)
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise FileNotFoundError("nvcc not found on PATH or in /usr/local/cuda/bin")


class _CudaKernels:
    """The loaded segment-kernel library, built once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_seconds = 0.0
        self.build_log = ""

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path, self.build_seconds, self.build_log = \
                    build_shared_library([_nvcc(), *NVCC_FLAGS], CUDA_SRC,
                                         "libsegment_kernels.so")
                lib = ctypes.CDLL(str(path))
                p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
                lib.dmp_segment_sum_sorted.restype = i32
                lib.dmp_segment_sum_sorted.argtypes = [
                    p, p, p, i64, i64, i64, i32, i32, p]
                lib.dmp_gather_rows_sorted.restype = i32
                lib.dmp_gather_rows_sorted.argtypes = [
                    p, p, p, i64, i64, i64, i64, i32, i32, p]
                self._lib = lib
            return self._lib


CUDA_KERNELS = _CudaKernels()
