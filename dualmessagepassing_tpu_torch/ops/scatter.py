"""Message-passing primitives of the SCM model over a padded batch
(dualmessagepassing_tpu/ops/scatter.py: gather_nodes 38, gather_scalars
73, scatter_sum_edges 92, _masked_onehot 190), and the JAX module's
three helpers that no model calls (scatter_sum_flat 124,
scatter_max_edges 149, segment_softmax_edges 166).

The JAX package writes each primitive as a one-hot einsum, a TPU idiom
(its matrix unit does a [E, V] x [V, H] product faster than a scatter).
Here every one of them is an index over the batch flattened to B*V rows,
flat index b*V + idx:

  gather_nodes      rows of node_feat [B, V, H] per edge -> [B, E, H]: an
                    index_select; its backward sums the cotangent rows
                    into the table with K3 (GatherRows); with valid=, the
                    rows it marks False are zero and drop from the sum;
  scatter_sum_edges masked segment-sum of per-edge messages into node
                    slots -> [B, V, H]: K3 (SegmentSumRows); its backward
                    is a row gather;
  gather_scalars    gather_nodes of a [B, V] table, one column wide;
  bincount_batched  the degrees: K3 of the edge mask, float32 counts.

K3 is csrc/scatter_kernels.cu (ops/scatter_kernels.segment_sum_unsorted):
an unsorted segment-sum that sums float32 or bf16 rows in float32 and
drops receivers outside [0, rows). So:
  * pad edges (edge_mask False) get the index B*V and are dropped; their
    messages are zeroed as well, as scatter.py:109 does, so no result
    depends on the index a pad slot holds;
  * a receiver outside [0, V) drops too, as the one-hot of an
    out-of-range index is a zero row;
  * every sum is float32 and is cast to the message's dtype after, so a
    bf16 stream (amp) is never summed in bf16 — torch's own index_add_
    under autocast would sum in bf16;
  * gather indices are clamped into [0, V), as XLA's gather clamps.
The `method` argument of the JAX functions ("onehot", "segment", "take",
None) picks a lowering; every choice computes the same sum, so here it is
checked and has no other effect.

The three helpers index as JAX's .at[...] and take_along_axis do, not
as the one-hot lowering (jax_index): an index in [-V, 0) wraps to
idx + V; an update at any other index outside [0, V) is dropped, and a
gather there reads NaN. So a receiver of -1 lands in the last row.
  scatter_sum_flat      masked flat segment-sum [E, H] -> [V, H] on K3
                        (SegmentSumRows); indices_sorted is a lowering
                        hint that changes no number (scatter.py:131-139);
  scatter_max_edges     masked per-receiver max -> [B, V, H], an empty
                        row 0: torch's scatter_reduce "amax" with the
                        initial neg_inf rows included, whose gradient, as
                        JAX's, splits evenly among tied maxima;
  segment_softmax_edges the softmax within each receiver's segment: that
                        max, then the sum of the exponentials on K3 (one
                        column into B*V rows) gathered back through
                        GatherRows, so its backward runs K3 twice (the
                        two gathers) and the max's tie rule.

Dispatch: a CPU tensor takes K3's plain version (segment_sum_unsorted_
plain); a CUDA tensor launches K3 or raises. Every launch, forward or
backward, adds one to LAUNCHES["segment_sum_unsorted"].
"""

from __future__ import annotations

from typing import Optional

import torch

from .scatter_kernels import segment_sum_unsorted

_METHODS = (None, "onehot", "segment", "take")


def _check_method(method: Optional[str]) -> None:
    if method not in _METHODS:
        raise ValueError(f"unknown scatter method: {method}")


def flat_index(idx: torch.Tensor, n: int,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, E] per-graph indices -> [B*E] int64 flat indices b*n + idx;
    entries outside [0, n), or where `valid` is False, become B*n (the
    index K3 drops)."""
    b = idx.shape[0]
    offs = torch.arange(b, device=idx.device)[:, None] * n
    ok = (idx >= 0) & (idx < n)
    if valid is not None:
        ok = ok & valid
    return torch.where(ok, idx + offs, b * n).reshape(-1)


class SegmentSumRows(torch.autograd.Function):
    """out [n_rows, H] = K3(msg [N, H]) at the flat receivers, summed in
    float32 and cast to msg's dtype; receivers >= n_rows are dropped.
    d msg = g[receivers], zero for the dropped rows."""

    @staticmethod
    def forward(ctx, msg, receivers, n_rows: int):
        ctx.save_for_backward(receivers)
        ctx.n_rows = int(n_rows)
        return segment_sum_unsorted(msg, receivers, n_rows).to(msg.dtype)

    @staticmethod
    def backward(ctx, g):
        (receivers,) = ctx.saved_tensors
        keep = receivers < ctx.n_rows
        rows = g.index_select(0, torch.where(keep, receivers, 0))
        return torch.where(keep[:, None], rows, 0), None, None


class GatherRows(torch.autograd.Function):
    """rows [N, H] = table[idx]; d table = K3(g) at idx, summed in
    float32 and cast to the table's dtype. masked=True lets idx hold the
    index table.shape[0], which gives a zero row and is dropped from the
    backward's sum."""

    @staticmethod
    def forward(ctx, table, idx, masked: bool = False):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        ctx.dtype = table.dtype
        if not masked:
            return table.index_select(0, idx)
        # one pass: the dropped index reads an appended zero row
        return torch.cat([table, table.new_zeros(1, table.shape[1])]
                         ).index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        grad = segment_sum_unsorted(g.contiguous(), idx, ctx.n_rows)
        return grad.to(ctx.dtype), None, None


def gather_nodes(node_feat: torch.Tensor, idx: torch.Tensor,
                 method: Optional[str] = None,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """node_feat [B, V, H], idx [B, E] -> [B, E, H]. Where `valid` [B, E]
    is False the row is zero and takes no gradient (the JAX package's
    gather times the mask, models/lrp.py:62-69), as pad edges drop from
    scatter_sum_edges."""
    _check_method(method)
    b, v, h = node_feat.shape
    flat = flat_index(idx.clamp(0, v - 1), v, valid)
    rows = GatherRows.apply(node_feat.reshape(b * v, h), flat,
                            valid is not None)
    return rows.reshape(b, idx.shape[1], h)


def gather_scalars(table: torch.Tensor, idx: torch.Tensor,
                   method: Optional[str] = None) -> torch.Tensor:
    """table [B, V], idx [B, E] -> [B, E]."""
    return gather_nodes(table[..., None], idx, method)[..., 0]


def scatter_sum_edges(messages: torch.Tensor, receivers: torch.Tensor,
                      edge_mask: torch.Tensor, num_nodes: int,
                      method: Optional[str] = None) -> torch.Tensor:
    """messages [B, E, H], receivers [B, E], edge_mask [B, E] bool ->
    [B, V, H] in messages' dtype (summed in float32): DGL's fn.sum over
    a padded batch (reference dmpnn.py:92)."""
    _check_method(method)
    b, e, h = messages.shape
    msg = torch.where(edge_mask[..., None], messages, 0)
    flat = flat_index(receivers, num_nodes, edge_mask)
    out = SegmentSumRows.apply(msg.reshape(b * e, h), flat, b * num_nodes)
    return out.reshape(b, num_nodes, h)


def bincount_batched(idx: torch.Tensor, mask: torch.Tensor,
                     n: int) -> torch.Tensor:
    """[B, E] indices + mask -> [B, n] float32 counts (K3 of the mask)."""
    b = idx.shape[0]
    ones = mask.float().reshape(-1, 1)
    with torch.no_grad():
        out = segment_sum_unsorted(ones, flat_index(idx, n, mask), b * n)
    return out.reshape(b, n)


# -----------------------------------------------------------------------------
# the helpers, indexed as JAX indexes
# -----------------------------------------------------------------------------

def jax_index(idx: torch.Tensor, n: int) -> tuple:
    """JAX's index into an axis of length n -> (int64 index, inside): an
    index in [-n, 0) wraps to idx + n; `inside` marks the indices that
    then lie in [0, n). .at[...] drops the others' updates and
    take_along_axis reads NaN there."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


def batch_index(receivers: torch.Tensor, n: int) -> tuple:
    """[B, E] receivers -> ([B*E] flat indices b*n + idx, with B*n where
    jax_index drops; inside [B, E])."""
    idx, inside = jax_index(receivers, n)
    offs = torch.arange(receivers.shape[0], device=idx.device)[:, None] * n
    flat = torch.where(inside, idx + offs, receivers.shape[0] * n)
    return flat.reshape(-1), inside


def _take(table: torch.Tensor, flat: torch.Tensor,
          inside: torch.Tensor) -> torch.Tensor:
    """take_along_axis of a [N, 1] table at the flat indices -> inside's
    shape, NaN outside; the backward sums on K3 (GatherRows)."""
    rows = GatherRows.apply(table, flat, True).reshape(inside.shape)
    return torch.where(inside, rows, float("nan"))


def _segment_max(msg: torch.Tensor, flat: torch.Tensor, n_rows: int,
                 neg_inf: float) -> torch.Tensor:
    """[N, H] rows -> [n_rows, H]: the max of neg_inf and the rows at each
    flat index (n_rows: dropped), as .at[...].max over a neg_inf fill."""
    h = msg.shape[1]
    out = msg.new_full((n_rows + 1, h), neg_inf)
    out = out.scatter_reduce(0, flat[:, None].expand(-1, h), msg, "amax",
                             include_self=True)
    return out[:-1]


def scatter_sum_flat(messages: torch.Tensor, receivers: torch.Tensor,
                     edge_mask: torch.Tensor, num_nodes: int,
                     indices_sorted: bool = False) -> torch.Tensor:
    """Flat-graph segment-sum: messages [E, H], receivers [E], edge_mask
    [E] bool -> [V, H] in messages' dtype (summed in float32 on K3)."""
    del indices_sorted  # a lowering hint: the same sum
    msg = torch.where(edge_mask[:, None], messages, 0)
    idx, inside = jax_index(receivers, num_nodes)
    flat = torch.where(inside & edge_mask, idx, num_nodes)
    return SegmentSumRows.apply(msg, flat, num_nodes)


def scatter_max_edges(messages: torch.Tensor, receivers: torch.Tensor,
                      edge_mask: torch.Tensor, num_nodes: int,
                      neg_inf: float = -1e30) -> torch.Tensor:
    """Masked segment-max: messages [B, E, H], receivers [B, E], edge_mask
    [B, E] bool -> [B, V, H]; a row that no real message reaches is 0."""
    b, e, h = messages.shape
    msg = torch.where(edge_mask[..., None], messages, neg_inf)
    flat, _ = batch_index(receivers, num_nodes)
    out = _segment_max(msg.reshape(b * e, h), flat, b * num_nodes, neg_inf)
    out = out.reshape(b, num_nodes, h)
    return torch.where(out <= neg_inf / 2, 0.0, out)


def segment_softmax_edges(scores: torch.Tensor, receivers: torch.Tensor,
                          edge_mask: torch.Tensor,
                          num_nodes: int) -> torch.Tensor:
    """Per-receiver softmax over incident edges: scores [B, E] -> [B, E];
    masked edges 0, the denominator clamped to 1e-30."""
    neg_inf = -1e30
    b, e = scores.shape
    rows = b * num_nodes
    s = torch.where(edge_mask, scores, neg_inf)
    flat, inside = batch_index(receivers, num_nodes)
    seg_max = _segment_max(s.reshape(b * e, 1), flat, rows, neg_inf)
    s = s - _take(seg_max, flat, inside)
    ex = torch.where(edge_mask, torch.exp(s), 0.0)
    seg_sum = SegmentSumRows.apply(ex.reshape(b * e, 1), flat, rows)
    return ex / torch.clamp_min(_take(seg_sum, flat, inside), 1e-30)
