"""Segment kernels over a receiver-sorted edge stream, for Hopper
(dualmessagepassing_tpu/ops/segment_kernel.py).

Two operations carry the UNC DMPNN layer (unc/model.DualGraphConv):

  K1  segment_sum_sorted(msg [E, H], row_ptr [V+1]) -> [V, H]
      out[v] = sum of msg[e] over the edges e with receiver v, summed in
      float32 and cast back to msg.dtype — the node aggregation. Replaces
      the Pallas windowed segment-sum (_v5_kernel / _v5_impl,
      segment_kernel.py:158-266 of the JAX package).
  K2  gather_rows_sorted(table [Vt, W], idx [E], n_real) -> [E, W]
      out[e] = table[idx[e]] for e < n_real, zero on the pad tail — the
      receiver-endpoint gather. Replaces the Pallas windowed
      row-broadcast (_bcast_kernel / windowed_row_broadcast,
      segment_kernel.py:489-576).

The TPU kernels take a host "pass plan" shaped for 128-lane windows
(build_pass_plan / build_bcast_plan). Hopper needs none of that: the
host attaches a CSR row pointer over the real prefix of the sorted
stream instead (attach_csr_plan), so pad slots are never read.

Dispatch: a tensor on the CPU takes the plain PyTorch version of each
kernel (segment_sum_sorted_plain / gather_rows_sorted_plain); a CUDA
tensor launches the CUDA kernel (csrc/segment_kernels.cu, built by
ops/build.py at first use) or raises — there is no fallback. Until the
kernels get their backward (the training slice), both entry points
raise on inputs that require grad while autograd is recording, so it
cannot silently produce a wrong gradient. LAUNCHES counts kernel
launches per entry point.
"""

from __future__ import annotations

import collections
from typing import Dict

import numpy as np
import torch

from .build import CUDA_KERNELS

# kernel launches per entry point; plain-version calls do not count
LAUNCHES: collections.Counter = collections.Counter()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def attach_csr_plan(padded: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Add the kernels' CSR plan to a pad_subgraph dict (host side).

    The padded edge arrays are receiver-sorted with the pad rows at the
    tail, and the pads carry the last real receiver id, not a dump id.
    So the plan is built over the REAL prefix only:
      sk_rowptr int32 [V+1]: searchsorted of arange(V+1) into the real
                receivers — row v's edges are sk_rowptr[v]..sk_rowptr[v+1]
                and sk_rowptr[V] == n_real;
      n_real    int: the number of real edges (K2 zeroes rows >= n_real).
    """
    v_max = len(padded["node_mask"])
    n_real = int(np.asarray(padded["edge_mask"]).sum())
    recv = np.asarray(padded["receivers"])[:n_real]
    if n_real and ((np.diff(recv) < 0).any() or recv[0] < 0
                   or recv[-1] >= v_max):
        raise ValueError("receivers must be sorted (pad_subgraph order) "
                         f"and lie in [0, {v_max})")
    out = dict(padded)
    out["sk_rowptr"] = np.searchsorted(
        recv, np.arange(v_max + 1), side="left").astype(np.int32)
    out["n_real"] = n_real
    return out


def _check_inference(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward yet: call it under torch.no_grad() "
            "or torch.inference_mode()")


def _check_cuda(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# -----------------------------------------------------------------------------
# K1: segment sum
# -----------------------------------------------------------------------------

def segment_sum_sorted_plain(msg: torch.Tensor,
                             row_ptr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1: float32 index_add_ over the rows the row pointer
    names, cast back to msg.dtype. Edges past row_ptr[-1] are not read."""
    v = row_ptr.numel() - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    recv = torch.repeat_interleave(
        torch.arange(v, device=msg.device), counts)
    out = torch.zeros(v, msg.shape[1], dtype=torch.float32, device=msg.device)
    out.index_add_(0, recv, msg[: recv.numel()].float())
    return out.to(msg.dtype)


def segment_sum_sorted(msg: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """msg [E, H] f32|bf16 (receiver-sorted), row_ptr int32 [V+1] ->
    [V, H] in msg.dtype, accumulated in float32."""
    _check_inference("segment_sum_sorted", msg)
    if msg.device.type == "cpu":
        return segment_sum_sorted_plain(msg, row_ptr)
    _check_cuda("segment_sum_sorted msg", msg, tuple(_DTYPE_CODE), 2)
    _check_cuda("segment_sum_sorted row_ptr", row_ptr, (torch.int32,), 1)
    if row_ptr.device != msg.device:
        raise ValueError("segment_sum_sorted: msg and row_ptr on different "
                         "devices")
    e, h = msg.shape
    v = row_ptr.numel() - 1
    out = torch.empty((v, h), dtype=msg.dtype, device=msg.device)
    if v == 0 or h == 0:
        return out
    rc = CUDA_KERNELS.load().dmp_segment_sum_sorted(
        msg.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), v, h, e,
        _DTYPE_CODE[msg.dtype], msg.device.index, _stream(msg.device))
    if rc != 0:
        raise RuntimeError(f"segment_sum_sorted: CUDA error {rc} at launch")
    LAUNCHES["segment_sum_sorted"] += 1
    return out


# -----------------------------------------------------------------------------
# K2: row gather
# -----------------------------------------------------------------------------

def gather_rows_sorted_plain(table: torch.Tensor, idx: torch.Tensor,
                             n_real: int) -> torch.Tensor:
    """Plain PyTorch K2: table[idx] with the pad tail (rows >= n_real)
    zeroed by position."""
    out = table[idx]
    out[n_real:] = 0
    return out


def gather_rows_sorted(table: torch.Tensor, idx: torch.Tensor,
                       n_real: int) -> torch.Tensor:
    """table [Vt, W] f32|bf16, idx int64 [E] receiver-sorted on its first
    n_real entries -> [E, W]: table rows, zero rows from n_real on."""
    _check_inference("gather_rows_sorted", table)
    n_real = int(n_real)
    if not 0 <= n_real <= idx.numel():
        raise ValueError(f"n_real={n_real} outside [0, {idx.numel()}]")
    if table.device.type == "cpu":
        return gather_rows_sorted_plain(table, idx, n_real)
    _check_cuda("gather_rows_sorted table", table, tuple(_DTYPE_CODE), 2)
    _check_cuda("gather_rows_sorted idx", idx, (torch.int64,), 1)
    if idx.device != table.device:
        raise ValueError("gather_rows_sorted: table and idx on different "
                         "devices")
    vt, w = table.shape
    e = idx.numel()
    out = torch.empty((e, w), dtype=table.dtype, device=table.device)
    if e == 0 or w == 0:
        return out
    rc = CUDA_KERNELS.load().dmp_gather_rows_sorted(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), vt, w, e, n_real,
        table.element_size(), table.device.index, _stream(table.device))
    if rc != 0:
        raise RuntimeError(f"gather_rows_sorted: CUDA error {rc} at launch")
    LAUNCHES["gather_rows_sorted"] += 1
    return out
