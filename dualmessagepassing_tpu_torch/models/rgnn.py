"""Relational GNNs: R-GCN and R-GIN with basis / block-diagonal relation
weights (dualmessagepassing_tpu/models/rgnn.py: RelWeights 75-113,
RGCNLayer 116-179, RGINLayer 182-216, RGNNStack 219-270, RGCN 273-287,
RGIN 290-304; reference SubgraphCountingMatching/models/rgcn.py:16-300,
rgin.py:16-172). Per edge (u --e--> v) with relation r = edge label:

    R-GCN: out = act(sum_r (sum_{e->v, rel=r} src_e * norm) @ W_r
                     + H @ W_loop * norm_loop + b)
    R-GIN: out = act(mlp(sum_r (sum_{e->v, rel=r} src_e) @ W_r
                         + H @ W_loop + b))
           then act once more (the reference's second activation after
           its MLP, rgin.py:147-152)

Weights (rgcn.py:59-78): "none" one [D, H] per relation; "basis" W_r =
sum_b w_comp[r, b] B_b (num_bases < R); "bdd" W_r block-diagonal with
num_bases blocks of [D/nb, H/nb].

The relation fold. The JAX package scans the R relations with one masked
segment-sum and one product each. Here the per-relation sums are ONE K3
call into B*V*R rows, at row (b*V + receiver)*R + label, the masked-off
edges and the labels outside [0, R) dropped, then ONE product:
[B*V, R*D] @ [R*D, H] (none, basis), or an einsum over (relation,
block) (bdd). That is the same sum_r (...) @ W_r; only the order of the
float32 sum differs. The sender gather is ops/scatter.gather_nodes
(backward K3). So a layer launches K3 once forward and once backward,
and the stack once more forward for each degree table its norms need
(float32, so an amp stream is promoted to float32 by the norm, as in the
JAX package). Under amp the fold sums in float32 where the JAX scan
carries bf16.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..graph import GraphBatch
from ..ops.scatter import gather_nodes, scatter_sum_edges
from ..utils.act import map_activation_str_to_fn
from ..utils.init import calculate_gain, xavier_uniform
from .basemodel import GraphAdjModel
from .compgcn import EDGE_NORMS, degree_norms
from .layers import MaskedBatchNorm, UpdateMLP, dropout, remat


def relation_sums(graph: GraphBatch, src: torch.Tensor,
                  num_rels: int) -> torch.Tensor:
    """src [B, E, D] per-edge rows -> [B, V, R, D] in src's dtype (summed
    in float32): entry [b, v, r] sums the rows of the real edges into v
    whose label is r; one K3 call over B*V*R rows."""
    b, e, d = src.shape
    v = graph.max_nodes
    rel, recv = graph.edge_label, graph.receivers
    ok = (graph.edge_mask & (rel >= 0) & (rel < num_rels)
          & (recv >= 0) & (recv < v))
    out = scatter_sum_edges(src, recv * num_rels + rel, ok, v * num_rels)
    return out.reshape(b, v, num_rels, d)


class RelWeights(nn.Module):
    """The relation weight bank (rgcn.py:59-78); forward() -> (weights,
    bdd): [R, D, H] for none/basis, [R, nb, D/nb, H/nb] for bdd."""

    def __init__(self, num_rels: int, input_dim: int, hidden_dim: int,
                 regularizer: str = "bdd", num_bases: Optional[int] = 4,
                 act: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_rels = num_rels
        self.regularizer = regularizer
        init = xavier_uniform(calculate_gain(act))
        if (regularizer == "none" or num_bases is None
                or num_bases > num_rels or num_bases <= 0):
            nb = num_rels
        else:
            nb = num_bases
        self.w_comp = None
        if regularizer in ("none", "basis"):
            self.weight = nn.Parameter(
                init((nb, input_dim, hidden_dim), generator))
            if nb < num_rels:
                self.w_comp = nn.Parameter(init((num_rels, nb), generator))
        elif regularizer == "bdd":
            if input_dim % nb or hidden_dim % nb:
                raise ValueError(
                    f"dims must be divisible by num_bases ({nb})")
            self.block = (nb, input_dim // nb, hidden_dim // nb)
            self.weight = nn.Parameter(init(
                (num_rels, input_dim * hidden_dim // nb), generator))
        else:
            raise ValueError(f"regularizer {regularizer}")

    def forward(self) -> Tuple[torch.Tensor, bool]:
        if self.regularizer == "bdd":
            return self.weight.reshape(self.num_rels, *self.block), True
        if self.w_comp is not None:
            return torch.einsum("rb,bdh->rdh", self.w_comp, self.weight), \
                False
        return self.weight, False


def relation_agg(graph: GraphBatch, node_feat: torch.Tensor,
                 rel_weights: RelWeights) -> torch.Tensor:
    """sum_r (sum over the edges of relation r into v of the sender rows)
    @ W_r -> [B, V, H] in node_feat's dtype (rgnn.py:45-74, as one K3
    call and one product)."""
    b, v, d = node_feat.shape
    weights, bdd = rel_weights()
    weights = weights.to(node_feat.dtype)
    r = weights.shape[0]
    per_rel = relation_sums(graph, gather_nodes(node_feat, graph.senders),
                            r)                                  # [B,V,R,D]
    if bdd:
        _, nb, si, so = weights.shape
        out = torch.einsum("bvrks,rkst->bvkt",
                           per_rel.reshape(b, v, r, nb, si), weights)
        return out.reshape(b, v, nb * so)
    return per_rel.reshape(b, v, r * d) @ weights.reshape(r * d, -1)


class RGCNLayer(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, num_rels: int,
                 regularizer: str = "bdd", num_bases: Optional[int] = 4,
                 edge_norm: str = "in", self_loop: bool = True,
                 use_bias: bool = True, batch_norm: bool = False,
                 act: str = "relu", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if edge_norm not in EDGE_NORMS:
            raise ValueError(f"edge_norm {edge_norm}")
        self.edge_norm = edge_norm
        self.self_loop = self_loop
        self.act = act
        self.dropout = dropout
        self.rel_weights = RelWeights(num_rels, in_dim, hidden_dim,
                                      regularizer, num_bases, act, generator)
        if self_loop:
            self.loop_weight = nn.Parameter(xavier_uniform(
                calculate_gain(act))((in_dim, hidden_dim), generator))
        self.bias = (nn.Parameter(torch.zeros(hidden_dim)) if use_bias
                     else None)
        self.bn = MaskedBatchNorm(hidden_dim) if batch_norm else None

    def forward(self, graph: GraphBatch, node_feat: torch.Tensor,
                train: bool = False,
                norms: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                update_stats: bool = True) -> torch.Tensor:
        if norms is None:
            norms = degree_norms(graph, self.edge_norm, self.self_loop)
        innorm, outnorm = norms.get("in"), norms.get("out")
        src = node_feat
        if self.edge_norm == "out":
            src = node_feat * outnorm[..., None]
        elif self.edge_norm == "both":
            src = node_feat * torch.sqrt(outnorm)[..., None]
        out = relation_agg(graph, src, self.rel_weights)
        if self.edge_norm == "in":
            out = out * innorm[..., None]
        elif self.edge_norm == "both":
            out = out * torch.sqrt(innorm)[..., None]
        if self.self_loop:
            loop = node_feat @ self.loop_weight.to(node_feat.dtype)
            if self.edge_norm == "in":
                loop = loop * innorm[..., None]
            elif self.edge_norm == "out":
                loop = loop * outnorm[..., None]
            elif self.edge_norm == "both":
                loop = loop * torch.sqrt(innorm * outnorm)[..., None]
            out = out + loop
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        if self.bn is not None:
            lead = out.shape[:-1]
            out = self.bn(out.reshape(-1, out.shape[-1]),
                          graph.node_mask.reshape(-1), train,
                          update_stats).reshape(*lead, -1)
        out = map_activation_str_to_fn(self.act)(out)
        return dropout(out, self.dropout, train, generator)


class RGINLayer(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, num_rels: int,
                 regularizer: str = "bdd", num_bases: Optional[int] = 4,
                 num_mlp_layers: int = 2, self_loop: bool = True,
                 use_bias: bool = True, batch_norm: bool = False,
                 act: str = "relu", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act_fn = map_activation_str_to_fn(act)
        self.dropout = dropout
        self.rel_weights = RelWeights(num_rels, in_dim, hidden_dim,
                                      regularizer, num_bases, act, generator)
        self.loop_weight = (nn.Parameter(xavier_uniform(calculate_gain(
            act))((in_dim, hidden_dim), generator)) if self_loop else None)
        self.bias = (nn.Parameter(torch.zeros(hidden_dim)) if use_bias
                     else None)
        self.mlp = (UpdateMLP(hidden_dim, hidden_dim, num_mlp_layers,
                              batch_norm, act, generator=generator)
                    if num_mlp_layers > 0 else None)

    def forward(self, graph: GraphBatch, node_feat: torch.Tensor,
                train: bool = False, norms=None,
                generator: Optional[torch.Generator] = None,
                update_stats: bool = True) -> torch.Tensor:
        out = relation_agg(graph, node_feat, self.rel_weights)
        if self.loop_weight is not None:
            out = out + node_feat @ self.loop_weight.to(node_feat.dtype)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        if self.mlp is not None:
            out = self.mlp(out, graph.node_mask, train, update_stats)
        else:
            out = self.act_fn(out)
        out = self.act_fn(out)      # the second activation (rgin.py:151)
        return dropout(out, self.dropout, train, generator)


class RGNNStack(nn.Module):
    """Layers rgcn_0, ... (kind "rgcn") or rgin_0, ... ("rgin") with the
    gate/mask multiply and the residual where shapes match (rgcn.py:
    254-300); remat as models/dmpnn.DMPNNStack's."""

    def __init__(self, kind: str, num_layers: int, in_dim: int,
                 hidden_dim: int, num_rels: int, regularizer: str = "bdd",
                 num_bases: Optional[int] = 4, num_mlp_layers: int = 2,
                 edge_norm: str = "in", batch_norm: bool = False,
                 act: str = "relu", dropout: float = 0.0,
                 residual: bool = True, remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kind not in ("rgcn", "rgin"):
            raise ValueError(f"kind {kind}")
        self.kind = kind
        self.num_layers = num_layers
        self.edge_norm = edge_norm if kind == "rgcn" else "none"
        self.residual = residual
        self.remat = remat
        for i in range(num_layers):
            kw = dict(regularizer=regularizer, num_bases=num_bases,
                      batch_norm=batch_norm, act=act, dropout=dropout,
                      generator=generator)
            din = in_dim if i == 0 else hidden_dim
            if kind == "rgcn":
                layer = RGCNLayer(din, hidden_dim, num_rels,
                                  edge_norm=edge_norm, **kw)
            else:
                layer = RGINLayer(din, hidden_dim, num_rels,
                                  num_mlp_layers=num_mlp_layers, **kw)
            self.add_module(f"{kind}_{i}", layer)

    def forward(self, graph: GraphBatch, v_emb: torch.Tensor,
                v_gate: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        v = v_emb if v_gate is None else v_emb * v_gate
        norms = degree_norms(graph, self.edge_norm, self_loop=True)
        for i in range(self.num_layers):
            layer = getattr(self, f"{self.kind}_{i}")
            if self.remat and torch.is_grad_enabled():
                v_new = remat(layer, graph, v, train, norms,
                              generator=generator)
            else:
                v_new = layer(graph, v, train, norms, generator)
            if v_gate is not None:
                v_new = v_new * v_gate
            v = v + v_new if self.residual and v_new.shape == v.shape \
                else v_new
        return v


class RGCN(GraphAdjModel):
    """Relational GCN SCM model (reference rgcn.py:215-300)."""

    def make_rep_net(self, generator) -> nn.Module:
        cfg = self.cfg
        return RGNNStack(
            "rgcn", cfg.rep_num_graph_layers, cfg.hid_dim, cfg.hid_dim,
            cfg.max_ngel, regularizer=cfg.rep_rgcn_regularizer,
            num_bases=cfg.rep_rgcn_num_bases,
            edge_norm=cfg.rep_rgcn_edge_norm,
            batch_norm=cfg.rep_rgcn_batch_norm, act=cfg.rep_act_func,
            dropout=cfg.rep_dropout, residual=cfg.rep_residual,
            remat=cfg.rep_remat, generator=generator)


class RGIN(GraphAdjModel):
    """Relational GIN SCM model (reference rgin.py:175-...)."""

    def make_rep_net(self, generator) -> nn.Module:
        cfg = self.cfg
        return RGNNStack(
            "rgin", cfg.rep_num_graph_layers, cfg.hid_dim, cfg.hid_dim,
            cfg.max_ngel, regularizer=cfg.rep_rgin_regularizer,
            num_bases=cfg.rep_rgin_num_bases,
            num_mlp_layers=cfg.rep_rgin_num_mlp_layers,
            batch_norm=cfg.rep_rgin_batch_norm, act=cfg.rep_act_func,
            dropout=cfg.rep_dropout, residual=cfg.rep_residual,
            remat=cfg.rep_remat, generator=generator)
