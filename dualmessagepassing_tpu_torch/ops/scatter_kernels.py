"""Segment-sums over a whole edge stream, for Hopper
(dualmessagepassing_tpu/ops/pallas_scatter.py).

The JAX module holds two experimental Pallas kernels that lie on no
training or serving path; their one entry point is the kernel bench
(scripts/kernel_bench.py, here bench/kernel_bench.py):

  K3  segment_sum_unsorted(msg [E, H] f32|bf16, receivers int64 [E],
                           num_nodes) -> [V, H] float32
      out[v] = sum of msg[e] over the edges with receivers[e] == v, for
      an UNSORTED stream; receivers outside [0, V) are dropped. Replaces
      pallas_segment_sum (pallas_scatter.py:94-121), the full-V
      accumulator kernel. A CUDA kernel (csrc/scatter_kernels.cu): a
      grid-stride walk over the edges, lanes across 4-column items, one
      float4 atomic per item into the output, which the launcher zeroes
      on the stream. The order of the atomic additions changes from run
      to run.
  K4  csr_segment_sum(messages_sorted [E', H] f32, row_ptr int32 [V+1])
      -> [V, H] float32
      Replaces pallas_csr_segment_sum (pallas_scatter.py:178-229), the
      CSR row-tiled kernel at HIGHEST precision. It computes exactly
      what K1 computes in float32, so it launches K1's CUDA kernel (the
      merge path, or one block per row for a short stream) through an
      entry of its own (dmp_csr_segment_sum in csrc/segment_kernels.cu)
      and counts its own launches. Rows past row_ptr[V] are not read.
      The TPU tiling arguments (tile_v, tile_e, the 128-lane pack with
      its H <= 127 limit, the padded row pointer) have no counterpart.

csr_sort_host is the JAX module's host helper, copied as numpy.

Dispatch as in ops/segment_kernel.py: a CPU tensor takes the plain
PyTorch version; a CUDA tensor launches the kernel or raises. LAUNCHES
(shared with ops/segment_kernel.py) counts "segment_sum_unsorted" and
"csr_segment_sum" launches. Neither entry point is differentiable.
"""

from __future__ import annotations

import numpy as np
import torch

from .build import CUDA_KERNELS, SCATTER_KERNELS
from .segment_kernel import (LAUNCHES, _DTYPE_CODE, _check_cuda,
                             _refuse_autograd, _stream, k1_scratch,
                             segment_sum_sorted_plain)


def csr_sort_host(receivers, num_nodes: int, tile_e: int = 512):
    """-> (order, row_ptr int32 [V+1]): a stable receiver sort and the
    CSR row pointer of the sorted stream (pallas_scatter.py:232-241;
    tile_e is kept for the signature and not used, as there)."""
    recv = np.asarray(receivers)
    order = np.argsort(recv, kind="stable")
    counts = np.bincount(recv, minlength=num_nodes)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return order, row_ptr


# -----------------------------------------------------------------------------
# K3: unsorted segment sum
# -----------------------------------------------------------------------------

def segment_sum_unsorted_plain(msg: torch.Tensor, receivers: torch.Tensor,
                               num_nodes: int) -> torch.Tensor:
    """Plain PyTorch K3: float32 index_add_ of the rows whose receiver
    lies in [0, num_nodes)."""
    keep = (receivers >= 0) & (receivers < num_nodes)
    out = torch.zeros(num_nodes, msg.shape[1], dtype=torch.float32,
                      device=msg.device)
    return out.index_add_(0, receivers[keep], msg[keep].float())


def segment_sum_unsorted(msg: torch.Tensor, receivers: torch.Tensor,
                         num_nodes: int) -> torch.Tensor:
    """msg [E, H] f32|bf16, receivers int64 [E] in any order ->
    [num_nodes, H] float32; out-of-range receivers are dropped."""
    _refuse_autograd("segment_sum_unsorted", None, msg)
    num_nodes = int(num_nodes)
    if msg.device.type == "cpu":
        return segment_sum_unsorted_plain(msg, receivers, num_nodes)
    _check_cuda("segment_sum_unsorted msg", msg, tuple(_DTYPE_CODE), 2)
    _check_cuda("segment_sum_unsorted receivers", receivers,
                (torch.int64,), 1)
    if receivers.device != msg.device or receivers.numel() != msg.shape[0]:
        raise ValueError("segment_sum_unsorted: receivers must hold one "
                         "entry per message row, on the same device")
    e, h = msg.shape
    # zeroed by the launcher, on the stream
    out = torch.empty((num_nodes, h), dtype=torch.float32, device=msg.device)
    if num_nodes == 0 or h == 0 or e == 0:
        return out.zero_()
    rc = SCATTER_KERNELS.load().dmp_segment_sum_unsorted(
        msg.data_ptr(), receivers.data_ptr(), out.data_ptr(), num_nodes, h,
        e, _DTYPE_CODE[msg.dtype], msg.device.index, _stream(msg.device))
    if rc != 0:
        raise RuntimeError(f"segment_sum_unsorted: CUDA error {rc} at launch")
    LAUNCHES["segment_sum_unsorted"] += 1
    return out


# -----------------------------------------------------------------------------
# K4: CSR segment sum (K1's kernel in float32)
# -----------------------------------------------------------------------------

def csr_segment_sum_plain(messages_sorted: torch.Tensor,
                          row_ptr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K4: K1's plain version in float32."""
    return segment_sum_sorted_plain(messages_sorted.float(), row_ptr)


def csr_segment_sum(messages_sorted: torch.Tensor,
                    row_ptr: torch.Tensor) -> torch.Tensor:
    """messages_sorted [E', H] f32 (receiver-sorted), row_ptr int32 [V+1]
    -> [V, H] float32; row v sums rows row_ptr[v]..row_ptr[v+1]."""
    _refuse_autograd("csr_segment_sum", None, messages_sorted)
    if messages_sorted.device.type == "cpu":
        return csr_segment_sum_plain(messages_sorted, row_ptr)
    _check_cuda("csr_segment_sum messages_sorted", messages_sorted,
                (torch.float32,), 2)
    _check_cuda("csr_segment_sum row_ptr", row_ptr, (torch.int32,), 1)
    if row_ptr.device != messages_sorted.device:
        raise ValueError("csr_segment_sum: messages and row_ptr on "
                         "different devices")
    e, h = messages_sorted.shape
    v = row_ptr.numel() - 1
    out = torch.empty((v, h), dtype=torch.float32,
                      device=messages_sorted.device)
    if v == 0 or h == 0:
        return out
    shares, scratch = k1_scratch(v, e, h, messages_sorted.device)
    rc = CUDA_KERNELS.load().dmp_csr_segment_sum(
        messages_sorted.data_ptr(), row_ptr.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), v, h, e, shares, messages_sorted.device.index,
        _stream(messages_sorted.device))
    if rc != 0:
        raise RuntimeError(f"csr_segment_sum: CUDA error {rc} at launch")
    LAUNCHES["csr_segment_sum"] += 1
    return out
