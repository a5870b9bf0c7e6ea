"""Segment kernels over a receiver-sorted edge stream, for Hopper
(dualmessagepassing_tpu/ops/segment_kernel.py).

Two operations carry the UNC DMPNN layer (unc/model.DualGraphConv):

  K1  segment_sum_sorted(msg [E, H], row_ptr [V+1], rows=None) -> [V, H]
      out[v] = sum of msg[e] (or msg[rows[e]]) over the edges e of row v,
      summed in float32 and cast back to msg.dtype — the node aggregation
      and the gathers' backward. The kernel splits the work by edges, not
      rows (merge path; a short stream takes one block per row), and is
      deterministic. Replaces
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

Training pairs the two kernels as each other's backward, as the JAX
package does (_v5_call_b; _take_rows_bcast; _take_rows_win_perm, in
unc/model.py:178-276):

  SegmentSumSorted  forward K1 on sk_rowptr; backward K2, g[recv] with
                    the pad tail zero;
  GatherRowsSorted  forward K2; backward K1 over the same sk_rowptr
                    (the real prefix only), cast to the table's dtype;
  GatherRowsPerm    the sender gather: forward a plain index_select;
                    backward K1 over the sender row pointer sk2_rowptr,
                    reading the real edges' cotangent rows in sender order
                    through sk2_order (no permuted copy).

Every backward sums in float32 (K1's accumulator), also under amp: a
plain index_select's autograd backward would index_add_ into an
accumulator of the cotangent's dtype, bf16 under amp.

Dispatch: a tensor on the CPU takes the plain PyTorch version of each
kernel (segment_sum_sorted_plain / gather_rows_sorted_plain), in the
forward and in the backward; a CUDA tensor launches the CUDA kernel
(csrc/segment_kernels.cu, built by ops/build.py at first use) or
raises — there is no fallback. The two kernel entry points are not
differentiable themselves: they raise on inputs that require grad while
autograd records, and differentiable calls go through the Functions.
LAUNCHES counts kernel launches per entry point and direction
("segment_sum_sorted:fwd", "segment_sum_sorted:bwd", ...).
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

import numpy as np
import torch

from .build import CUDA_KERNELS

# kernel launches per entry point; plain-version calls do not count
LAUNCHES: collections.Counter = collections.Counter()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def row_pointer(keys: np.ndarray, v_max: int, what: str) -> np.ndarray:
    if len(keys) and ((np.diff(keys) < 0).any() or keys[0] < 0
                      or keys[-1] >= v_max):
        raise ValueError(f"{what} must be sorted (pad_subgraph order) "
                         f"and lie in [0, {v_max})")
    return np.searchsorted(keys, np.arange(v_max + 1),
                           side="left").astype(np.int32)


def attach_csr_plan(padded: Dict[str, np.ndarray],
                    sender_plan: bool = False) -> Dict[str, np.ndarray]:
    """Add the kernels' CSR plan to a pad_subgraph dict (host side).

    The padded edge arrays are receiver-sorted with the pad rows at the
    tail, and the pads carry the last real receiver id, not a dump id.
    So the receiver plan is built over the REAL prefix only:
      sk_rowptr  int32 [V+1]: searchsorted of arange(V+1) into the real
                 receivers — row v's edges are sk_rowptr[v]..sk_rowptr[v+1]
                 and sk_rowptr[V] == n_real;
      n_real     int: the number of real edges (K2 zeroes rows >= n_real).
    sender_plan=True (training; needs pad_subgraph(send_keys=True)) adds
    the sender plan, over the real edges too:
      sk2_order  int64 [n_real]: send_order without the pad slots — the
                 real edges in (stable) sender order;
      sk2_rowptr int32 [V+1]: the row pointer of senders[sk2_order], so
                 sk2_rowptr[V] == n_real.
    The JAX package sums its sender cotangent over the WHOLE sorted
    stream, where the pads sort as sender 0 (unc/data.py:416-419). Their
    cotangents are exactly zero (every pad edge is masked out of every
    real output; tests/test_torch_unc_train.py checks it), so leaving
    them out changes no sum — and keeps K1 from walking all E - n_real
    pad slots with the one warp of row 0.
    """
    v_max = len(padded["node_mask"])
    edge_mask = np.asarray(padded["edge_mask"])
    n_real = int(edge_mask.sum())
    if not edge_mask[:n_real].all():
        raise ValueError("edge_mask must mark a prefix (pad_subgraph order)")
    out = dict(padded)
    out["sk_rowptr"] = row_pointer(
        np.asarray(padded["receivers"])[:n_real], v_max, "receivers")
    out["n_real"] = n_real
    if sender_plan:
        order = np.asarray(padded["send_order"])
        order = order[order < n_real]
        out["sk2_order"] = order
        out["sk2_rowptr"] = row_pointer(
            np.asarray(padded["senders"])[order], v_max, "senders")
    return out


def _refuse_autograd(name: str, function: Optional[str],
                     *tensors: torch.Tensor) -> None:
    """The kernel entry points build no graph: a call that autograd
    records would silently lose its gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        where = (f"call {function}.apply for a gradient, or "
                 if function else "")
        raise RuntimeError(f"{name} is not differentiable: {where}call it "
                           "under torch.no_grad()")


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

# K1's kernel cuts the V + row_ptr[V] items (row ends and edges) into
# equal shares, one warp each (csrc/segment_kernels.cu): as many as the
# card holds warps of it at once, but no more than one per K1_MIN_ITEMS
# of the V + E items the row pointer may name. The wrapper sizes the
# scratch for the most the launcher may choose: 64 warps per SM.
K1_MIN_ITEMS = 16
K1_MAX_WARPS_PER_SM = 64


def k1_scratch(n_rows: int, n_edges: int, width: int,
               device: torch.device):
    """-> (max_shares, scratch): the most shares K1's launcher may cut
    on this device, and their scratch, float32 [2 * max_shares * width]:
    per share the partial sums of the two rows it may leave cut."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shares = max(1, min(-(-(n_rows + n_edges) // K1_MIN_ITEMS),
                        sms * K1_MAX_WARPS_PER_SM))
    return shares, torch.empty(2 * shares * width, dtype=torch.float32,
                               device=device)


def segment_sum_sorted_plain(msg: torch.Tensor, row_ptr: torch.Tensor,
                             rows: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch K1: float32 index_add_ over the rows the row pointer
    names, cast back to msg.dtype. Edge e is msg[e], or msg[rows[e]]
    where rows is given; edges past row_ptr[-1] are not read."""
    v = row_ptr.numel() - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    recv = torch.repeat_interleave(
        torch.arange(v, device=msg.device), counts)
    n = recv.numel()
    src = msg[:n] if rows is None else msg.index_select(0, rows[:n])
    out = torch.zeros(v, msg.shape[1], dtype=torch.float32, device=msg.device)
    out.index_add_(0, recv, src.float())
    return out.to(msg.dtype)


def segment_sum_sorted(msg: torch.Tensor, row_ptr: torch.Tensor, *,
                       rows: Optional[torch.Tensor] = None,
                       backward: bool = False) -> torch.Tensor:
    """msg [E, H] f32|bf16, row_ptr int32 [V+1] (row_ptr[0] = 0) -> [V, H]
    in msg.dtype, accumulated in float32. Row v sums edges row_ptr[v] ..
    row_ptr[v+1] - 1, edge e being msg[e] (a receiver-sorted stream) or,
    with rows (int64, at least row_ptr[V] entries), msg[rows[e]].
    `backward` only picks the launch count a kernel launch adds to."""
    _refuse_autograd("segment_sum_sorted", "SegmentSumSorted", msg)
    if msg.device.type == "cpu":
        return segment_sum_sorted_plain(msg, row_ptr, rows)
    _check_cuda("segment_sum_sorted msg", msg, tuple(_DTYPE_CODE), 2)
    _check_cuda("segment_sum_sorted row_ptr", row_ptr, (torch.int32,), 1)
    if row_ptr.device != msg.device:
        raise ValueError("segment_sum_sorted: msg and row_ptr on different "
                         "devices")
    e, h = msg.shape
    n_edges = e
    if rows is not None:
        _check_cuda("segment_sum_sorted rows", rows, (torch.int64,), 1)
        if rows.device != msg.device:
            raise ValueError("segment_sum_sorted: msg and rows on different "
                             "devices")
        n_edges = rows.numel()
        if not n_edges:
            # an empty index has no storage to point at; the kernel reads
            # none of it (row_ptr names no edge), but takes a null one for
            # "no index"
            rows = torch.zeros(1, dtype=torch.int64, device=msg.device)
    v = row_ptr.numel() - 1
    out = torch.empty((v, h), dtype=msg.dtype, device=msg.device)
    if v == 0 or h == 0:
        return out
    shares, scratch = k1_scratch(v, n_edges, h, msg.device)
    rc = CUDA_KERNELS.load().dmp_segment_sum_sorted(
        msg.data_ptr(), None if rows is None else rows.data_ptr(),
        row_ptr.data_ptr(), out.data_ptr(), scratch.data_ptr(), v, h, e,
        n_edges, shares, _DTYPE_CODE[msg.dtype], msg.device.index,
        _stream(msg.device))
    if rc != 0:
        raise RuntimeError(f"segment_sum_sorted: CUDA error {rc} at launch")
    LAUNCHES["segment_sum_sorted:" + ("bwd" if backward else "fwd")] += 1
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
                       n_real: int, *, backward: bool = False,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """table [Vt, W] f32|bf16, idx int64 [E] receiver-sorted on its first
    n_real entries -> [E, W]: table rows, zero rows from n_real on.
    `out`, if given, is a contiguous [E, W] tensor of the table's dtype
    and device that receives the rows (at any storage offset); `backward`
    only picks the launch count a kernel launch adds to."""
    _refuse_autograd("gather_rows_sorted", "GatherRowsSorted", table)
    n_real = int(n_real)
    if not 0 <= n_real <= idx.numel():
        raise ValueError(f"n_real={n_real} outside [0, {idx.numel()}]")
    shape = (idx.numel(), table.shape[-1])
    if out is not None and (out.shape != shape or out.dtype != table.dtype
                            or out.device != table.device
                            or not out.is_contiguous()):
        raise ValueError(f"gather_rows_sorted: out must be a contiguous "
                         f"{shape} {table.dtype} tensor on {table.device}")
    if table.device.type == "cpu":
        rows = gather_rows_sorted_plain(table, idx, n_real)
        return rows if out is None else out.copy_(rows)
    _check_cuda("gather_rows_sorted table", table, tuple(_DTYPE_CODE), 2)
    _check_cuda("gather_rows_sorted idx", idx, (torch.int64,), 1)
    if idx.device != table.device:
        raise ValueError("gather_rows_sorted: table and idx on different "
                         "devices")
    vt, w = table.shape
    e = idx.numel()
    if out is None:
        out = torch.empty((e, w), dtype=table.dtype, device=table.device)
    if e == 0 or w == 0:
        return out
    rc = CUDA_KERNELS.load().dmp_gather_rows_sorted(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), vt, w, e, n_real,
        table.element_size(), table.device.index, _stream(table.device))
    if rc != 0:
        raise RuntimeError(f"gather_rows_sorted: CUDA error {rc} at launch")
    LAUNCHES["gather_rows_sorted:" + ("bwd" if backward else "fwd")] += 1
    return out


# -----------------------------------------------------------------------------
# the backward pairings
# -----------------------------------------------------------------------------

class SegmentSumSorted(torch.autograd.Function):
    """agg = K1(msg) over sk_rowptr; d msg = K2(g) at the receivers, zero
    on the pad tail (the JAX package's _v5_call_b)."""

    @staticmethod
    def forward(ctx, msg, row_ptr, receivers, n_real: int):
        ctx.save_for_backward(receivers)
        ctx.n_real = int(n_real)
        return segment_sum_sorted(msg, row_ptr)

    @staticmethod
    def backward(ctx, g):
        (receivers,) = ctx.saved_tensors
        grad = gather_rows_sorted(g.contiguous(), receivers, ctx.n_real,
                                  backward=True)
        return grad, None, None, None


class GatherRowsSorted(torch.autograd.Function):
    """rows = K2(table) at the receiver-sorted idx, pads zero; d table =
    K1(g) over the same sk_rowptr, which reads the real prefix only,
    cast to the table's dtype (_take_rows_bcast)."""

    @staticmethod
    def forward(ctx, table, idx, n_real: int, row_ptr):
        if row_ptr.numel() != table.shape[0] + 1:
            raise ValueError(f"row_ptr has {row_ptr.numel()} entries for a "
                             f"table of {table.shape[0]} rows")
        ctx.save_for_backward(row_ptr)
        ctx.dtype = table.dtype
        return gather_rows_sorted(table, idx, n_real)

    @staticmethod
    def backward(ctx, g):
        (row_ptr,) = ctx.saved_tensors
        grad = segment_sum_sorted(g.contiguous(), row_ptr, backward=True)
        return grad.to(ctx.dtype), None, None, None


class GatherRowsPerm(torch.autograd.Function):
    """rows = table[idx] for an unsorted idx (the senders); d table = K1
    over the sender row pointer, reading the cotangent rows in sender
    order through `order` (sk2_order: the real edges only, and
    row_ptr[V] == len(order)) — the JAX package's segment-sum of
    g[order] (_take_rows_win_perm) without the permuted copy."""

    @staticmethod
    def forward(ctx, table, idx, order, row_ptr):
        if row_ptr.numel() != table.shape[0] + 1:
            raise ValueError(f"row_ptr has {row_ptr.numel()} entries for a "
                             f"table of {table.shape[0]} rows")
        ctx.save_for_backward(order, row_ptr)
        ctx.dtype = table.dtype
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        order, row_ptr = ctx.saved_tensors
        grad = segment_sum_sorted(g.contiguous(), row_ptr, rows=order,
                                  backward=True)
        return grad.to(ctx.dtype), None, None, None


def gather_rows_perm(table: torch.Tensor, idx: torch.Tensor,
                     order: Optional[torch.Tensor] = None,
                     row_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sender gather: GatherRowsPerm where the sender plan is given;
    without it a plain index_select, which only a call autograd does not
    record may take."""
    if order is not None and row_ptr is not None:
        return GatherRowsPerm.apply(table, idx, order, row_ptr)
    if torch.is_grad_enabled() and table.requires_grad:
        raise ValueError(
            "the sender gather's backward needs sk2_order and sk2_rowptr "
            "(pad_subgraph(send_keys=True), attach_csr_plan(sender_plan="
            "True))")
    return table.index_select(0, idx)
