"""Builds the port's native libraries into build/torch_kernels/ at the
root of the checkout (listed in .gitignore), at first use.

Three libraries, each with a plain C interface loaded through ctypes:
  * the CUDA kernels of this package, one library per source, compiled
    by nvcc for sm_90a (Hopper) — a few seconds each, since no PyTorch
    header is included:
      csrc/segment_kernels.cu  K1, K2 and K4's entry (CUDA_KERNELS),
      csrc/scatter_kernels.cu  K3 (SCATTER_KERNELS);
    build_cuda_kernels() starts every nvcc at once;
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = PACKAGE_DIR.parent
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"

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
    """One nvcc-built kernel library, built once per process.

    `signatures` maps each C entry point to (restype, argtypes)."""

    def __init__(self, source: str, signatures: Dict[str, tuple]):
        self.src = PACKAGE_DIR / "csrc" / source
        self.lib_name = f"lib{self.src.stem}.so"
        self.signatures = signatures
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_seconds = 0.0
        self.build_log = ""

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path, self.build_seconds, self.build_log = \
                    build_shared_library([_nvcc(), *NVCC_FLAGS], self.src,
                                         self.lib_name)
                lib = ctypes.CDLL(str(path))
                for name, (restype, argtypes) in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                self._lib = lib
            return self._lib


_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# msg, rows, row_ptr, out, scratch, n_rows, width, n_msg_rows, n_edges,
# n_shares, dtype, device, stream
_SEGMENT_SUM = (_I32, [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                       _I32, _I32, _P])
# msg, row_ptr, out, scratch, n_rows, width, n_edges, n_shares, device,
# stream
_CSR_SEGMENT_SUM = (_I32, [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I32,
                           _P])
# table, idx, out, n_table_rows, width, n_edges, n_real, elem_bytes,
# device, stream
_GATHER_ROWS = (_I32, [_P, _P, _P, _I64, _I64, _I64, _I64, _I32, _I32, _P])

CUDA_KERNELS = _CudaKernels("segment_kernels.cu", {
    "dmp_segment_sum_sorted": _SEGMENT_SUM,
    "dmp_gather_rows_sorted": _GATHER_ROWS,
    "dmp_csr_segment_sum": _CSR_SEGMENT_SUM,
})
# msg, recv, out, n_rows, width, n_edges, dtype, device, stream
SCATTER_KERNELS = _CudaKernels("scatter_kernels.cu", {
    "dmp_segment_sum_unsorted": (_I32, [_P, _P, _P, _I64, _I64, _I64, _I32,
                                        _I32, _P]),
})
ALL_CUDA_KERNELS = (CUDA_KERNELS, SCATTER_KERNELS)


def build_cuda_kernels() -> float:
    """Build and load every CUDA library, all nvcc processes at once.
    Returns the wall seconds; raises what the first failed build raised."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(ALL_CUDA_KERNELS)) as pool:
        for fut in [pool.submit(k.load) for k in ALL_CUDA_KERNELS]:
            fut.result()
    return time.perf_counter() - t0
