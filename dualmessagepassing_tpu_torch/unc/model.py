"""UNC models in PyTorch (dualmessagepassing_tpu/unc/model.py:
_onehot_rows 329, UpdateMLP2 407, DualGraphConv 429, UNCDMPNN 667,
CompGraphConv 731, _flat_relation_agg 802, RelGraphConvFlat 831, Dense_
876, UNCCompGCN 887, UNCRGNN 919, _input_embeddings 955, UNCTrainModel
998 with its DistMult and supervised losses and regularisers,
apply_unc_forward 1176, _masked_mean_sq 1239, optax_sigmoid_bce 1248).

Reference: HKUST-KnowComp/DualMessagePassing,
UnsupervisedNodeClassification/Model/{DMPNN,CompGCN,R-GCN,R-GIN}/src/
model.py (DMPNN: DualGraphConv 117-280, DMPNN 283-328, TrainModel
632-737).

Reference quirks preserved, as in the JAX package:
  * DualGraphConv's dropout calls discard their result (model.py:245,260)
    — the `dropout` argument is kept for config parity and does nothing;
    CompGraphConv and RelGraphConvFlat drop for real (in train mode,
    from the torch.Generator the forward is given);
  * unused nfc/efc Linear layers are not reproduced;
  * update MLP is Linear-[BN]-LeakyReLU(1/5.5)-Linear with xavier-uniform
    weights and zero biases (model.py:146-168);
  * tanh between hidden layers, no activation after the last
    (model.py:299-308);
  * r-bar = per-relation mean of final edge outputs (model.py:319-325);
  * R-GIN drops the edge norm and adds a Dense (gain sqrt 2) before its
    activation (R-GIN/src/model.py:150-157).

Port notes:
  * Parameters keep JAX's names and [in, out] layout (x @ W), so
    params_from_flax is a copy of the flax tree, for every backbone.
  * The compute dtype is an argument of forward: float32 master
    parameters are cast to it at use (utils/amp.py). Node and relation
    rows are gathered from the float32 tables and cast afterwards — the
    same values as casting first, and it keeps a later backward in f32.
  * Each layer has one composition. Every lowering choice of the JAX
    layers (scatter_backend, pad_cols, recv_bcast, sender_windowed,
    sorted_edges, the fused endpoint gather) computes the same numbers
    and is tested equal to its plain path, so none exists here. (The
    JAX package's UNCCompGCN and UNCRGNN do not pass scatter_backend to
    their layers, so they always take its XLA scatter; the numbers are
    the same.) The layers run through the autograd pairings of
    ops/segment_kernel.py: every node aggregation is K1 (backward K2) —
    R-GCN/R-GIN run it once per relation type, 2R launches per layer;
    DualGraphConv's receiver gather of the [V, 2H+1] endpoint table is
    K2 (backward K1); every sender gather is an index_select whose
    backward is K1 over the sender row pointer. They need the host CSR
    plan (sk_rowptr, n_real; for a backward also sk2_order and
    sk2_rowptr: ops/segment_kernel.attach_csr_plan).
  * K2 returns zero rows for pad edges where a plain gather returns
    table[last receiver]; pad edges are masked everywhere they could
    reach a real output, so compare valid rows only. For the same
    reason every pad edge's cotangent is exactly zero.
  * Relation rows (the edge-type embedding, w_relation in the score and
    the regulariser) are looked up as one_hot @ table in float32
    (_onehot_rows), as the JAX package does: the backward is then a
    matmul instead of E atomics into 2R rows.
  * Owner sharding (the JAX model's node_sharding="owner"; parallel/
    halo_unc.py builds the rank's arrays, parallel/dist.split_rows(...,
    owner=True) sets owner_rows): node rows are this rank's owned rows
    [Vp], every edge lives on the rank that owns its receiver, and the
    senders address the composite table [owned; halo; zero dump]
    (parallel/dist.halo_table: one exchange of [n, B, H] a layer). The
    aggregation is then complete on the rank, with no sum over the
    ranks; the sender gathers run on the sender plan over that table's
    Vt rows (sk2_*), DualGraphConv's receiver gather of its [Vt, 2H+1] table on
    a receiver plan over Vt rows (skt_rowptr), the aggregation on one
    over Vp (sk_rowptr). The DistMult score reads the all-gathered
    [n * Vp, H] table by packed ids (UNCTrainModel._full_rows).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..constants import LEAKY_RELU_A
from ..models.compgcn import comp_func
from ..models.layers import Dense, MaskedBatchNorm
from ..models.layers import dropout as _dropout
from ..ops.encoding import get_enc_len, multihot_table
from ..ops.segment_kernel import (GatherRowsSorted, SegmentSumSorted,
                                  gather_rows_perm)
from ..parallel.dist import all_gather_rows, all_reduce_sum, halo_table
from ..utils.amp import cast_floats
from ..utils.init import embedding_uniform, scaled, xavier_uniform

Sub = Dict[str, object]


def _param(init, shape, generator) -> nn.Parameter:
    return nn.Parameter(init(shape, generator))


def _zeros(n: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n))


def _onehot_rows(table: torch.Tensor, idx: torch.Tensor,
                 clip: bool = False) -> torch.Tensor:
    """Small-table row lookup as one_hot(idx) @ table, in the table's
    dtype (unc/model.py:329-350): exact, since each output row has one
    non-zero product, and its backward is the matmul one_hot.T @ g.
    `clip` clamps idx into [0, n) on both sides, which XLA's gather does
    by itself and torch's one_hot refuses to."""
    n = table.shape[0]
    if clip:
        idx = idx.clamp(0, n - 1)
    return F.one_hot(idx, n).to(table.dtype) @ table


def _out_degrees(sub: Sub, world=None) -> torch.Tensor:
    """Global out-degrees over real edges (pad_subgraph ships them as
    sub["out_deg"]; this is the in-model fallback), summed over the
    ranks that hold the other edges (unc/model.py:513-514, 694-695)."""
    senders = sub["senders"]
    v = sub["node_mask"].shape[0]
    return all_reduce_sum(torch.zeros(v, device=senders.device).index_add_(
        0, senders, sub["edge_mask"].float()), world)


class UpdateMLP2(nn.Module):
    """Linear-[BN]-LeakyReLU(1/5.5)-Linear (model.py:146-168)."""

    def __init__(self, in_dim: int, hidden_dim: int, batch_norm: bool = True,
                 generator=None):
        super().__init__()
        h = hidden_dim
        self.fc0_kernel = _param(xavier_uniform(1.0), (in_dim, h), generator)
        self.fc0_bias = _zeros(h)
        self.fc1_kernel = _param(xavier_uniform(1.0), (h, h), generator)
        self.fc1_bias = _zeros(h)
        self.bn = MaskedBatchNorm(h) if batch_norm else None

    def forward(self, x, mask=None, train: bool = False):
        dt = x.dtype
        y = x @ self.fc0_kernel.to(dt) + self.fc0_bias.to(dt)
        if self.bn is not None:
            y = self.bn(y, mask=mask, train=train)
        y = F.leaky_relu(y, LEAKY_RELU_A)
        return y @ self.fc1_kernel.to(dt) + self.fc1_bias.to(dt)


class DualGraphConv(nn.Module):
    """UNC flavor of the dual message passing layer (model.py:117-280)."""

    def __init__(self, in_dim: int, hidden_dim: int,
                 init_neigenv: float = 4.0, init_eeigenv: float = 4.0,
                 use_bias: bool = True, batch_norm: bool = True,
                 activation: Optional[str] = None, dropout: float = 0.0,
                 generator=None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.activation = activation
        self.dropout = dropout   # config parity only; see module docstring
        n_init = scaled(xavier_uniform(1.0), 1.0 / init_neigenv)
        e_init = scaled(xavier_uniform(1.0), 1.0 / init_eeigenv)
        shape = (in_dim, hidden_dim)
        self.in_weight = _param(n_init, shape, generator)
        self.out_weight = _param(n_init, shape, generator)
        self.nloop_weight = _param(n_init, shape, generator)
        self.src_weight = _param(e_init, shape, generator)
        self.dst_weight = _param(e_init, shape, generator)
        self.eloop_weight = _param(e_init, shape, generator)
        self.use_bias = use_bias
        if use_bias:
            self.nbias = _zeros(hidden_dim)
            self.ebias = _zeros(hidden_dim)
        self.nmlp = UpdateMLP2(hidden_dim, hidden_dim, batch_norm, generator)
        self.emlp = UpdateMLP2(hidden_dim, hidden_dim, batch_norm, generator)
        self.row_world = None        # the ranks holding the other edges
        self.owner_rows = False      # node rows owner-sharded over them

    def forward(self, sub: Sub, node_feat: torch.Tensor,
                edge_feat: torch.Tensor, edge_norm=None,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.hidden_dim
        dt = node_feat.dtype
        w_src = self.src_weight.to(dt)
        w_dst = self.dst_weight.to(dt)
        senders = sub["senders"]
        receivers = sub["receivers"]
        e_mask = sub["edge_mask"]
        rev = sub["rev_flag"][:, None]
        owner = self.owner_rows
        if owner and "out_deg" not in sub:
            # a sum over this rank's edges would miss the out-edges of its
            # rows that live on other ranks (unc/model.py:503-510)
            raise ValueError("owner-sharded subs must carry host-precomputed "
                             "'out_deg' (parallel/halo_unc.build_halo_sub)")
        out_deg = (sub["out_deg"] if "out_deg" in sub
                   else _out_degrees(sub, self.row_world))
        table = (halo_table(node_feat, sub, self.row_world) if owner
                 else node_feat)

        # ONE [V, 2H+1] endpoint table ([Vt, 2H+1] owner-sharded, the
        # halo and dump rows' degree zero): src/dst products plus the
        # log-degree column, cast to the compute dtype BEFORE the concat
        # (unc/model.py:525 order, for bf16 parity)
        d_col = torch.log2(1.0 + out_deg).to(dt)[:, None]
        if owner:
            d_col = torch.cat([d_col, d_col.new_zeros(
                table.shape[0] - d_col.shape[0], 1)])
        cols = torch.cat([table @ w_src, table @ w_dst, d_col], dim=1)
        at_send = gather_rows_perm(cols, senders, sub.get("sk2_order"),
                                   sub.get("sk2_rowptr"))        # bwd K1
        at_recv = GatherRowsSorted.apply(                        # K2, bwd K1
            cols, receivers, sub["n_real"],
            sub["skt_rowptr"] if owner else sub["sk_rowptr"])
        edge_msg = torch.where(
            rev,
            at_send[:, h: 2 * h] - at_recv[:, :h],
            at_recv[:, h: 2 * h] - at_send[:, :h],
        )
        node_msg = torch.where(rev, edge_feat @ self.out_weight.to(dt),
                               -(edge_feat @ self.in_weight.to(dt)))
        if edge_norm is not None:
            # edge_norm stays a float32 input; follow the compute dtype
            node_msg = node_msg * edge_norm.to(dt)
        node_msg = torch.where(e_mask[:, None], node_msg, 0.0)
        agg = SegmentSumSorted.apply(                            # K1, bwd K2
            node_msg, sub["sk_rowptr"], receivers, sub["n_real"])
        if not owner:                                   # unc/model.py:637
            agg = all_reduce_sum(agg, self.row_world)

        n_out = node_feat @ self.nloop_weight.to(dt) + agg
        if self.use_bias:
            n_out = n_out + self.nbias.to(dt)
        n_out = self.nmlp(n_out, mask=sub["node_mask"], train=train)

        # log-degree at the receiver, gathered with the endpoint table
        d = at_recv[:, 2 * h: 2 * h + 1].to(edge_feat.dtype)
        add = 2.0 * (1.0 + d) * (edge_feat @ (w_src - w_dst))
        e_out = edge_feat @ self.eloop_weight.to(dt) + edge_msg + add
        if self.use_bias:
            e_out = e_out + self.ebias.to(dt)
        e_out = self.emlp(e_out, mask=e_mask, train=train)

        if self.activation == "tanh":
            n_out = torch.tanh(n_out)
            e_out = torch.tanh(e_out)
        return n_out, e_out


class _Backbone(nn.Module):
    """The input layer every UNC backbone shares (unc/model.py:955-995):
    node rows from a frozen attribute table (EmbeddingLayerAttri), from
    a frozen multi-hot encoding of the node id times a learned
    projection (MultiHotEmbeddingLayer), or from a learned table
    (EmbeddingLayer); relation rows from a learned table where the
    backbone has a relation stream (DMPNN, CompGCN).

    node_attri (numpy or tensor [N, A]) and the multi-hot table are
    buffers that state_dict leaves out: they are inputs, not weights."""

    def __init__(self, num_nodes: int, num_rels: int, h_dim: int,
                 rel_stream: bool, node_attri=None,
                 multihot_input: bool = False, generator=None):
        super().__init__()
        self.num_nodes = num_nodes
        self.num_rels = num_rels          # already doubled by the caller
        self.node_emb = self.node_emb_proj = self.rel_emb = None
        attri = multihot = None
        emb_init = embedding_uniform(h_dim)
        if node_attri is not None:
            attri = torch.as_tensor(np.asarray(node_attri, np.float32))
        elif multihot_input:
            enc_len = get_enc_len(num_nodes - 1, 2)
            multihot = torch.from_numpy(multihot_table(num_nodes, 2))
            scale = 1.0 / math.sqrt(float(h_dim * enc_len))
            self.node_emb_proj = _param(
                lambda shape, g: (torch.rand(shape, generator=g) * 2 - 1)
                * scale, (enc_len * 2, h_dim), generator)
        else:
            self.node_emb = _param(emb_init, (num_nodes, h_dim), generator)
        if rel_stream:
            self.rel_emb = _param(emb_init, (num_rels, h_dim), generator)
        self.register_buffer("node_attri", attri, persistent=False)
        self.register_buffer("multihot", multihot, persistent=False)

    def input_embeddings(self, sub: Sub, dtype: torch.dtype):
        """-> (node rows [V, h] in `dtype`, relation rows [E, h] or None).
        The attribute and multi-hot rows are gathered, then cast (the same
        values as the JAX package's cast-then-gather); learned node rows
        come from the float32 table (nid holds distinct ids, so the
        backward sums nothing), relation rows through _onehot_rows."""
        nid = sub["nid"]
        if self.node_attri is not None:
            h = self.node_attri[nid].to(dtype)
        elif self.multihot is not None:
            h = self.multihot[nid].to(dtype) @ self.node_emb_proj.to(dtype)
        else:
            h = self.node_emb[nid].to(dtype)
        z = None
        if self.rel_emb is not None:
            z = _onehot_rows(self.rel_emb, sub["edge_type"]).to(dtype)
        return h, z


class UNCDMPNN(_Backbone):
    """DMPNN UNC model: the shared input layer + DualGraphConv stack
    (model.py:283-328). Returns (h, z, r_bar)."""

    def __init__(self, num_nodes: int, num_rels: int, h_dim: int,
                 out_dim: int, num_hidden_layers: int = 1,
                 dropout: float = 0.0, node_attri=None,
                 multihot_input: bool = False, generator=None):
        super().__init__(num_nodes, num_rels, h_dim, True, node_attri,
                         multihot_input, generator)
        self.layers = nn.ModuleList([
            DualGraphConv(
                h_dim if i == 0 else out_dim, out_dim,
                activation="tanh" if i < num_hidden_layers - 1 else None,
                dropout=dropout, generator=generator)
            for i in range(num_hidden_layers)])
        self.row_world = None
        self.owner_rows = False

    def forward(self, sub: Sub, train: bool = False,
                dtype: torch.dtype = torch.float32, generator=None):
        h, z = self.input_embeddings(sub, dtype)
        # the (layer-invariant) global out-degree, hoisted out of the layers
        # (owner-sharded, the host's; DualGraphConv refuses a sub without)
        if "out_deg" not in sub and not self.owner_rows:
            sub = dict(sub, out_deg=_out_degrees(sub, self.row_world))
        norm = sub.get("edge_norm")
        for layer in self.layers:
            h, z = layer(sub, h, z, edge_norm=norm, train=train)

        # per-relation mean of final edge outputs, as one_hot.T @ z in
        # float32 like the JAX package (an index_add_ of E rows into 2R
        # rows serialises on atomics: 2.0 of the 8.3 ms of device time
        # of an f32 forward at the PubMed envelope, H100 80GB HBM3, 700 W)
        onehot = F.one_hot(sub["edge_type"], self.num_rels).float() \
            * sub["edge_mask"].float()[:, None]
        sums = onehot.T @ z.float()
        cnts = onehot.sum(0)[:, None]
        if self.row_world is not None:                  # unc/model.py:717
            both = all_reduce_sum(torch.cat([sums, cnts], 1),
                                  self.row_world)
            sums, cnts = both[:, :-1], both[:, -1:]
        r_bar = sums / (cnts + 1e-8)
        return h, z, r_bar


class CompGraphConv(nn.Module):
    """UNC CompGCN layer (Model/CompGCN/src/model.py:117-264): the sender
    rows composed with the edge rows by circular correlation, in/out
    weights by rev_flag, the edge norm, aggregation at the receivers,
    the 1/3 self-loop average (comp(h, loop_rel) @ W_loop; 1/2 without
    a self loop), bias, activation, dropout; the edge stream is
    z @ W_rel. (The JAX layer's batch_norm option, off in every UNC
    backbone, is not ported.)"""

    def __init__(self, in_dim: int, hidden_dim: int, comp_opt: str = "corr",
                 self_loop: bool = True, use_bias: bool = True,
                 activation: Optional[str] = None, dropout: float = 0.0,
                 generator=None):
        super().__init__()
        self.comp_opt = comp_opt
        self.activation = activation
        self.dropout = dropout
        shape = (in_dim, hidden_dim)
        init = xavier_uniform(1.0)
        self.in_weight = _param(init, shape, generator)
        self.out_weight = _param(init, shape, generator)
        self.rel_weight = _param(init, shape, generator)
        self.self_loop = self_loop
        if self_loop:
            self.loop_weight = _param(init, shape, generator)
            self.loop_rel = _param(init, (1, in_dim), generator)
        self.use_bias = use_bias
        if use_bias:
            self.bias = _zeros(hidden_dim)
        self.row_world = None
        self.owner_rows = False

    def forward(self, sub: Sub, node_feat: torch.Tensor,
                edge_feat: torch.Tensor, edge_norm=None, train: bool = False,
                generator=None) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = node_feat.dtype
        table = (halo_table(node_feat, sub, self.row_world)
                 if self.owner_rows else node_feat)
        at_send = gather_rows_perm(table, sub["senders"],        # bwd K1
                                   sub.get("sk2_order"), sub.get("sk2_rowptr"))
        comp = comp_func(at_send, edge_feat, self.comp_opt)
        msg = torch.where(sub["rev_flag"][:, None],
                          comp @ self.out_weight.to(dt),
                          comp @ self.in_weight.to(dt))
        if edge_norm is not None:
            msg = msg * edge_norm.to(msg.dtype)
        msg = torch.where(sub["edge_mask"][:, None], msg, 0.0)
        agg = SegmentSumSorted.apply(                            # K1, bwd K2
            msg, sub["sk_rowptr"], sub["receivers"], sub["n_real"])
        if not self.owner_rows:                         # unc/model.py:782
            agg = all_reduce_sum(agg, self.row_world)
        if self.self_loop:
            loop = comp_func(node_feat, self.loop_rel.to(dt), self.comp_opt)
            out = (agg + loop @ self.loop_weight.to(dt)) * 0.3333333
        else:
            out = agg * 0.5
        if self.use_bias:
            out = out + self.bias.to(dt)
        if self.activation == "tanh":
            out = torch.tanh(out)
        out = _dropout(out, self.dropout, train, generator)
        return out, edge_feat @ self.rel_weight.to(dt)


class UNCCompGCN(_Backbone):
    """CompGCN UNC backbone (Model/CompGCN/src/model.py:267-305).
    Returns (h, z): the relation stream is transformed per layer."""

    def __init__(self, num_nodes: int, num_rels: int, h_dim: int,
                 out_dim: int, num_hidden_layers: int = 1,
                 dropout: float = 0.0, node_attri=None,
                 multihot_input: bool = False, generator=None):
        super().__init__(num_nodes, num_rels, h_dim, True, node_attri,
                         multihot_input, generator)
        self.layers = nn.ModuleList([
            CompGraphConv(
                h_dim if i == 0 else out_dim, out_dim, comp_opt="corr",
                activation="tanh" if i < num_hidden_layers - 1 else None,
                dropout=dropout, generator=generator)
            for i in range(num_hidden_layers)])

    def forward(self, sub: Sub, train: bool = False,
                dtype: torch.dtype = torch.float32, generator=None):
        h, z = self.input_embeddings(sub, dtype)
        norm = sub.get("edge_norm")
        for layer in self.layers:
            h, z = layer(sub, h, z, edge_norm=norm, train=train,
                         generator=generator)
        return h, z


def _flat_relation_agg(sub: Sub, src: torch.Tensor,
                       weights: torch.Tensor, world=None) -> torch.Tensor:
    """agg[v] = sum over the edges e -> v of src[e] @ W[rel(e)], relation
    by relation as the JAX package's scan (unc/model.py:802-828): mask
    the stream to relation r, K1 over the masked [E, din] stream, then
    partial @ W_r into a carry held in src's dtype (bf16 under amp, as
    the JAX package's). 2R K1 launches forward, 2R K2 backward. With
    `world` the carry holds this rank's edges, and one sum over the
    ranks after the loop completes it (unc/model.py:826-827); owner-
    sharded callers pass no world, as their edges complete their rows
    on the rank (local_complete)."""
    carry = torch.zeros(sub["node_mask"].shape[0], weights.shape[2],
                        dtype=src.dtype, device=src.device)
    valid = sub["edge_mask"]
    for r in range(weights.shape[0]):
        sel = valid & (sub["edge_type"] == r)
        masked = torch.where(sel[:, None], src, 0.0)
        partial = SegmentSumSorted.apply(                        # K1, bwd K2
            masked, sub["sk_rowptr"], sub["receivers"], sub["n_real"])
        carry = carry + partial @ weights[r]
    return all_reduce_sum(carry, world)


class RelGraphConvFlat(nn.Module):
    """dgl RelGraphConv (basis, num_bases = num_rels) on the flat
    subgraph: msg = src @ W_rel(e) [* norm]; out = act(agg + h @ W_loop +
    b), then dropout. R-GCN applies the edge norm; R-GIN (iso_layer)
    drops it and adds out_layer, a Dense of gain sqrt(2), before the
    activation (R-GIN/src/model.py:150-157)."""

    def __init__(self, in_dim: int, hidden_dim: int, num_rels: int,
                 self_loop: bool = True, use_bias: bool = True,
                 activation: Optional[str] = None, use_norm: bool = True,
                 iso_layer: bool = False, dropout: float = 0.0,
                 generator=None):
        super().__init__()
        self.activation = activation
        self.use_norm = use_norm
        self.dropout = dropout
        init = xavier_uniform(1.0)
        self.weight = _param(init, (num_rels, in_dim, hidden_dim), generator)
        self.self_loop = self_loop
        if self_loop:
            self.loop_weight = _param(init, (in_dim, hidden_dim), generator)
        self.use_bias = use_bias
        if use_bias:
            self.bias = _zeros(hidden_dim)
        self.out_layer = (Dense(hidden_dim, hidden_dim, activation="relu",
                                generator=generator) if iso_layer else None)
        self.row_world = None
        self.owner_rows = False

    def forward(self, sub: Sub, node_feat: torch.Tensor, edge_norm=None,
                train: bool = False, generator=None) -> torch.Tensor:
        dt = node_feat.dtype
        table = (halo_table(node_feat, sub, self.row_world)
                 if self.owner_rows else node_feat)
        src = gather_rows_perm(table, sub["senders"],            # bwd K1
                               sub.get("sk2_order"), sub.get("sk2_rowptr"))
        if self.use_norm and edge_norm is not None:
            src = src * edge_norm.to(dt)
        out = _flat_relation_agg(sub, src, self.weight.to(dt),
                                 None if self.owner_rows else self.row_world)
        if self.self_loop:
            out = out + node_feat @ self.loop_weight.to(dt)
        if self.use_bias:
            out = out + self.bias.to(dt)
        if self.out_layer is not None:
            out = self.out_layer(out)
        if self.activation == "tanh":
            out = torch.tanh(out)
        return _dropout(out, self.dropout, train, generator)


class UNCRGNN(_Backbone):
    """R-GCN / R-GIN UNC backbones (Model/R-GCN,R-GIN/src/model.py), kind
    "rgcn" or "rgin". Returns (h,)."""

    def __init__(self, kind: str, num_nodes: int, num_rels: int, h_dim: int,
                 out_dim: int, num_hidden_layers: int = 1,
                 dropout: float = 0.0, node_attri=None,
                 multihot_input: bool = False, generator=None):
        super().__init__(num_nodes, num_rels, h_dim, False, node_attri,
                         multihot_input, generator)
        self.kind = kind
        self.layers = nn.ModuleList([
            RelGraphConvFlat(
                h_dim if i == 0 else out_dim, out_dim, num_rels,
                activation="tanh" if i < num_hidden_layers - 1 else None,
                use_norm=kind == "rgcn", iso_layer=kind == "rgin",
                dropout=dropout, generator=generator)
            for i in range(num_hidden_layers)])

    def forward(self, sub: Sub, train: bool = False,
                dtype: torch.dtype = torch.float32, generator=None):
        h, _ = self.input_embeddings(sub, dtype)
        norm = sub.get("edge_norm")
        for layer in self.layers:
            h = layer(sub, h, edge_norm=norm, train=train,
                      generator=generator)
        return (h,)


BACKBONES = ("DMPNN", "CompGCN", "RGCN", "RGIN")


class UNCTrainModel(nn.Module):
    """DistMult link prediction and the supervised head around a UNC
    backbone (model.py:632-737): the losses and their regularisers."""

    def __init__(self, num_nodes: int, num_rels: int, h_dim: int,
                 num_hidden_layers: int = 1, dropout: float = 0.0,
                 reg_param: float = 0.0, generator=None, *,
                 nlabel: int = 0, node_attri=None, backbone: str = "DMPNN",
                 multi: bool = False, multihot_input: bool = False):
        """num_rels is the ORIGINAL relation count; the backbone embeds
        both directions (2 * num_rels edge types). node_attri [N, A]
        (frozen inputs, i_dim = A) or multihot_input replace the learned
        node table; nlabel > 0 adds the supervised head node_fc."""
        super().__init__()
        if backbone not in BACKBONES:
            raise NotImplementedError(backbone)
        self.num_rels = num_rels
        self.h_dim = h_dim
        self.reg_param = reg_param
        self.nlabel = nlabel
        self.multi = multi
        self.backbone = backbone
        i_dim = h_dim if node_attri is None else np.shape(node_attri)[1]
        args = (num_nodes, num_rels * 2, i_dim, h_dim, num_hidden_layers,
                dropout)
        kw = dict(node_attri=node_attri, multihot_input=multihot_input,
                  generator=generator)
        if backbone == "DMPNN":
            self.model = UNCDMPNN(*args, **kw)
        elif backbone == "CompGCN":
            self.model = UNCCompGCN(*args, **kw)
        else:
            self.model = UNCRGNN(backbone.lower(), *args, **kw)
        # created in both modes, as the JAX package does (its note at
        # unc/model.py:1079-1082)
        self.w_relation = _param(xavier_uniform(math.sqrt(2.0)),
                                 (num_rels, h_dim), generator)
        self.node_fc = (Dense(h_dim, nlabel, generator=generator)
                        if nlabel > 0 else None)
        # the edge-stream regulariser's Dense; R-GCN/R-GIN have no edge
        # stream, and the JAX package's lazy init creates none for them
        self.edge_fc = (Dense(h_dim, h_dim, generator=generator)
                        if backbone in ("DMPNN", "CompGCN") else None)
        # the ranks holding the other edges, and whether they own the
        # node rows (parallel/dist.split_rows)
        self.row_world = None
        self.owner_rows = False

    def forward(self, sub: Sub, train: bool = False,
                dtype: torch.dtype = torch.float32, generator=None):
        """-> the backbone's output tuple in `dtype` (DMPNN (h, z, r_bar),
        r_bar float32; CompGCN (h, z); R-GCN/R-GIN (h,)). `generator`
        draws the dropout masks of a train-mode forward."""
        if self.owner_rows and self.node_fc is not None:
            # the supervised loss would index the all-gathered table by
            # matched_index, which nothing remaps to packed ids (only the
            # samples are: build_halo_sub; unc/model.py:1051-1059)
            raise NotImplementedError(
                "a supervised head under owner sharding needs "
                "matched_index remapped to packed ids; train supervised "
                "runs on one device or edge-partitioned (ep_mode psum)")
        return self.model(sub, train=train, dtype=dtype, generator=generator)

    def _full_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Owner-sharded: every rank's [Vp, ...] rows gathered into the
        [n * Vp, ...] table that packed ids (owner * Vp + rank) address
        (unc/model.py:1100-1106); x itself otherwise."""
        if self.owner_rows:
            return all_gather_rows(x, self.row_world)
        return x

    def calc_score(self, node_emb: torch.Tensor,
                   triplets: torch.Tensor) -> torch.Tensor:
        """DistMult score sum(s * r * o) per (src, rel, dst) row."""
        s = node_emb[triplets[:, 0]]
        r = _onehot_rows(self.w_relation, triplets[:, 1])
        o = node_emb[triplets[:, 2]]
        return (s * r * o).sum(1)

    def regularization(self, embedding, edge_type=None, edge_mask=None,
                       node_mask=None) -> torch.Tensor:
        """mean(w_rel^2) + the masked mean square of each backbone output
        + the edge_fc alignment of the edge stream (model.py:691-715).
        Masks go by position: 0 node rows (node_mask), 1 edge rows
        (edge_mask), 2 per-relation means (none). Each mean is a sum over
        a count; with row_world both are summed over the ranks in one
        all-reduce (unc/model.py:1124-1145), which leaves the means of
        the rows every rank holds alike as they are, and completes those
        of the rows the ranks split (edges; owner-sharded node rows)."""
        reg = (self.w_relation ** 2).mean()   # replicated: no sum over ranks
        if not isinstance(embedding, (tuple, list)):
            embedding = (embedding,)
        terms = [_masked_sq_sum(emb, mask) for emb, mask in
                 zip(embedding, (node_mask, edge_mask, None))]
        aligned = edge_type is not None and len(embedding) > 1
        if aligned:
            mask = edge_type < self.num_rels
            if edge_mask is not None:
                mask = mask & edge_mask
            diff = self.edge_fc(embedding[1]) - _onehot_rows(
                self.w_relation, edge_type, clip=True)
            sq = (diff ** 2).sum(1)
            terms.append((torch.where(mask, sq, 0.0).sum(), mask.sum()))
        sums = [t[0] for t in terms]
        cnts = [t[1] for t in terms]
        if self.row_world is not None:
            dev = sums[0].device
            both = all_reduce_sum(torch.stack(sums + [
                torch.as_tensor(c, dtype=torch.float32, device=dev)
                for c in cnts]), self.row_world)
            sums, cnts = list(both[: len(sums)]), list(both[len(sums):])
        for i, (s, c) in enumerate(zip(sums, cnts)):
            c = c.clamp(min=1) if torch.is_tensor(c) else max(c, 1.0)
            if aligned and i == len(sums) - 1:
                c = c * self.h_dim
            reg = reg + s / c
        return reg

    def unsupervised_loss(self, embedding, edge_type, edge_mask, samples,
                          labels, sample_mask, node_mask=None
                          ) -> torch.Tensor:
        """Masked mean sigmoid BCE of the DistMult scores plus reg_param
        times the regulariser (model.py:1149-1156)."""
        score = self.calc_score(self._full_rows(embedding[0]), samples)
        bce = optax_sigmoid_bce(score, labels)
        cnt = sample_mask.sum().clamp(min=1)
        predict_loss = torch.where(sample_mask, bce, 0.0).sum() / cnt
        reg = self.regularization(embedding, edge_type, edge_mask, node_mask)
        return predict_loss + self.reg_param * reg

    def supervised_loss(self, embedding, edge_type, edge_mask, pred,
                        matched_labels, matched_index, matched_mask,
                        multi: bool) -> torch.Tensor:
        """Masked mean over the matched rows of pred (node_fc's logits at
        matched_index): multi-label, the mean over labels of the BCE
        through log_sigmoid; single-label, -log_softmax at the label.
        Plus reg_param times the regulariser, which, as the JAX package's
        (model.py:1158-1173), is given no node mask."""
        p = pred[matched_index]
        if multi:
            ml = matched_labels.to(p.dtype)
            bce = -(ml * F.logsigmoid(p) + (1 - ml) * F.logsigmoid(-p))
            per = bce.mean(1)
        else:
            logits = F.log_softmax(p, dim=-1)
            per = -logits.gather(1, matched_labels.long()[:, None])[:, 0]
        cnt = matched_mask.sum().clamp(min=1)
        predict_loss = torch.where(matched_mask, per, 0.0).sum() / cnt
        reg = self.regularization(embedding, edge_type, edge_mask)
        return predict_loss + self.reg_param * reg


def _masked_sq_sum(x: torch.Tensor, mask=None):
    """(sum of x^2 over the mask's rows, their element count): the two
    parts of the JAX package's _masked_mean_sq (unc/model.py:1239-1245)."""
    if mask is None:
        return (x ** 2).sum(), float(x.numel())
    m = mask.to(x.dtype)[:, None]
    return ((x ** 2) * m).sum(), m.sum() * x.shape[-1]


def optax_sigmoid_bce(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """binary_cross_entropy_with_logits, elementwise, in optax's form."""
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def apply_unc_forward(model: UNCTrainModel, sub: Sub, amp: bool = False,
                      train: bool = False, generator=None):
    """Forward with optional bf16 mixed precision
    (unc/model.py:1176-1208). amp=True runs the backbone with float32
    master parameters cast to bf16 at use, and casts the outputs back to
    float32. In train mode the BatchNorm running statistics are updated
    in place (they stay float32) and dropout draws from `generator`.
    Returns the output tuple."""
    return apply_unc_supervised_forward(model, sub, amp, train,
                                        generator)[0]


def apply_unc_supervised_forward(model: UNCTrainModel, sub: Sub,
                                 amp: bool = False, train: bool = False,
                                 generator=None):
    """apply_unc_forward and the supervised head -> (output tuple, pred):
    pred = node_fc(h) in the compute dtype, as the JAX package's
    __call__ runs it inside the bf16 apply, then float32 (None without
    a head)."""
    dtype = torch.bfloat16 if amp else torch.float32
    out = model(sub, train=train, dtype=dtype, generator=generator)
    pred = model.node_fc(out[0]) if model.node_fc is not None else None
    if amp:
        return cast_floats(out, torch.float32), cast_floats(pred,
                                                            torch.float32)
    return out, pred


# -----------------------------------------------------------------------------
# weights from the JAX package
# -----------------------------------------------------------------------------

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _flax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_name(path, stats: bool) -> str:
    parts = []
    for p in path:
        if p.startswith("layer_") and p[6:].isdigit():
            parts += ["layers", p[6:]]
        else:
            parts.append(p)
    if parts[-2:] == ["bn", "scale"]:
        parts[-1] = "weight"
    if stats:
        parts[-1] = _STAT_NAMES[parts[-1]]
    return ".".join(parts)


def params_from_flax(params: Mapping,
                     batch_stats: Optional[Mapping] = None
                     ) -> Dict[str, torch.Tensor]:
    """Map a JAX UNCTrainModel variable tree (any backbone, any input
    layer, with or without node_fc) onto this module's state_dict. `params` and `batch_stats` are the nested dicts
    of the flax variables (numpy arrays, or anything np.asarray takes);
    kernels keep their [in, out] layout, so every leaf is a copy.
    BatchNorm scale -> weight, mean/var -> running_mean/running_var."""
    sd = {}
    for path, leaf in _flax_leaves(params):
        sd[_torch_name(path, stats=False)] = torch.from_numpy(
            np.array(leaf, np.float32))
    for path, leaf in _flax_leaves(batch_stats or {}):
        sd[_torch_name(path, stats=True)] = torch.from_numpy(
            np.array(leaf, np.float32))
    return sd
