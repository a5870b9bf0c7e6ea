"""Composition-based GCN (dualmessagepassing_tpu/models/compgcn.py:
comp_func 36-49, CompGCNLayer 52-130, CompGCNStack 133-165, CompGCN
168-182; reference SubgraphCountingMatching/models/compgcn.py:84-385).
The UNC CompGraphConv (unc/model.py) reads comp_func too.

Per edge (u --e--> v):

    comp = comp_opt(src_feat, edge_feat)      # sub | mult | corr
    msg  = comp @ W_in (forward edge) | comp @ W_out (reversed edge)
    msg *= edge_norm (none | in | out | both) # degree reciprocals
    agg_v = sum of msg at v
    node update: (agg + comp(H, loop_rel) @ W_loop) * 0.3333333 (+ bias,
                 [BN], act, dropout); agg * 0.5 without the self loop
    edge update: E' = E @ W_rel

The sender gather is ops/scatter.gather_nodes (backward K3), the
aggregation ops/scatter.scatter_sum_edges (K3). The degrees the norms
need are K3 of the edge mask, once per stack (the JAX layer recomputes
them per layer; the numbers are the same) and float32, so an amp stream
is promoted to float32 by the norm as in the JAX package. Per layer a
forward launches K3 once and a backward once.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..graph import GraphBatch
from ..ops.scatter import gather_nodes, gather_scalars, scatter_sum_edges
from ..utils.act import map_activation_str_to_fn
from ..utils.init import calculate_gain, xavier_uniform
from .basemodel import GraphAdjModelV2
from .layers import MaskedBatchNorm, dropout, remat

EDGE_NORMS = ("none", "in", "out", "both")


def comp_func(head: torch.Tensor, relation: torch.Tensor,
              comp_opt: str) -> torch.Tensor:
    """head (-) relation: "sub" head - relation, "mult" head * relation,
    "corr" the circular correlation irfft(conj(rfft(head)) * rfft(rel)),
    out[k] = sum_i head[i] * relation[(i + k) mod n], over the last axis.
    The correlation runs in float32 and returns head's dtype, as the JAX
    package's does under bf16 compute."""
    if comp_opt == "sub":
        return head - relation
    if comp_opt == "mult":
        return head * relation
    if comp_opt == "corr":
        n = head.shape[-1]
        fh = torch.fft.rfft(head.float(), dim=-1)
        fr = torch.fft.rfft(relation.float(), dim=-1)
        out = torch.fft.irfft(torch.conj(fh) * fr, n=n, dim=-1)
        return out.to(head.dtype)
    raise NotImplementedError(f"comp_opt {comp_opt}")


def degree_norms(graph: GraphBatch, edge_norm: str,
                 self_loop: bool) -> Dict[str, torch.Tensor]:
    """The [B, V] float32 degree reciprocals edge_norm reads ("in",
    "out"), of CompGCN and R-GCN: 1 / (d + 1) with a self loop, else
    1 / d (compgcn.py:80-89, rgnn.py:126-137). At d = 0 the JAX CompGCN
    takes 1.0 and R-GCN 0.0; no output reads it, as a node of degree 0
    has no edge for it to scale (tests/test_torch_scm_rep_nets.py)."""
    def recip(d):
        if self_loop:
            return 1.0 / (d + 1.0)
        return 1.0 / torch.clamp(d, min=1.0)

    norms = {}
    if edge_norm in ("in", "both"):
        norms["in"] = recip(graph.in_degrees())
    if edge_norm in ("out", "both"):
        norms["out"] = recip(graph.out_degrees())
    return norms


class CompGCNLayer(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, self_loop: bool = True,
                 comp_opt: str = "corr", edge_norm: str = "none",
                 use_bias: bool = True, batch_norm: bool = False,
                 act: str = "relu", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if edge_norm not in EDGE_NORMS:
            raise ValueError(f"edge_norm {edge_norm}")
        self.self_loop = self_loop
        self.comp_opt = comp_opt
        self.edge_norm = edge_norm
        self.act = act
        self.dropout = dropout
        init = xavier_uniform(calculate_gain(act))
        shape = (in_dim, hidden_dim)
        self.in_weight = nn.Parameter(init(shape, generator))
        self.out_weight = nn.Parameter(init(shape, generator))
        self.rel_weight = nn.Parameter(init(shape, generator))
        if self_loop:
            self.loop_weight = nn.Parameter(init(shape, generator))
            self.loop_rel = nn.Parameter(init((1, in_dim), generator))
        self.bias = (nn.Parameter(torch.zeros(hidden_dim)) if use_bias
                     else None)
        self.bn = MaskedBatchNorm(hidden_dim) if batch_norm else None

    def forward(self, graph: GraphBatch, node_feat: torch.Tensor,
                edge_feat: torch.Tensor, train: bool = False,
                norms: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                update_stats: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """node_feat [B, V, Din], edge_feat [B, E, Din] -> ([B, V, H],
        [B, E, H]); norms from degree_norms (computed here when not
        given); update_stats as models/dmpnn.DMPLayer's."""
        dt = node_feat.dtype
        src_feat = gather_nodes(node_feat, graph.senders)       # backward K3
        comp = comp_func(src_feat, edge_feat, self.comp_opt)
        wt = comp.dtype
        msg = torch.where(graph.rev_flag[..., None],
                          comp @ self.out_weight.to(wt),
                          comp @ self.in_weight.to(wt))
        if self.edge_norm != "none":
            if norms is None:
                norms = degree_norms(graph, self.edge_norm, self.self_loop)
            if self.edge_norm == "in":
                norm = gather_scalars(norms["in"], graph.receivers)
            elif self.edge_norm == "out":
                norm = gather_scalars(norms["out"], graph.senders)
            else:
                norm = torch.sqrt(gather_scalars(norms["out"], graph.senders)
                                  * gather_scalars(norms["in"],
                                                   graph.receivers))
            msg = msg * norm[..., None]
        agg = scatter_sum_edges(msg, graph.receivers, graph.edge_mask,
                                graph.max_nodes)                 # K3

        if self.self_loop:
            loop = comp_func(node_feat, self.loop_rel.to(dt), self.comp_opt)
            out = (agg + loop @ self.loop_weight.to(loop.dtype)) * 0.3333333
        else:
            out = agg * 0.5
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        if self.bn is not None:
            lead = out.shape[:-1]
            out = self.bn(out.reshape(-1, out.shape[-1]),
                          graph.node_mask.reshape(-1), train,
                          update_stats).reshape(*lead, -1)
        out = map_activation_str_to_fn(self.act)(out)
        out = dropout(out, self.dropout, train, generator)
        e_out = edge_feat @ self.rel_weight.to(edge_feat.dtype)
        return out, e_out


class CompGCNStack(nn.Module):
    """CompGCNLayers compgcn_0, compgcn_1, ... with the gate/mask multiply
    and the residual where shapes match (compgcn.py:323-385); remat=True
    recomputes each layer in the backward, as models/dmpnn.DMPNNStack
    does."""

    def __init__(self, num_layers: int, in_dim: int, hidden_dim: int,
                 comp_opt: str = "corr", edge_norm: str = "none",
                 batch_norm: bool = False, act: str = "relu",
                 dropout: float = 0.0, residual: bool = True,
                 remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        self.edge_norm = edge_norm
        self.residual = residual
        self.remat = remat
        for i in range(num_layers):
            self.add_module(f"compgcn_{i}", CompGCNLayer(
                in_dim if i == 0 else hidden_dim, hidden_dim,
                comp_opt=comp_opt, edge_norm=edge_norm,
                batch_norm=batch_norm, act=act, dropout=dropout,
                generator=generator))

    def forward(self, graph: GraphBatch, v_emb: torch.Tensor,
                e_emb: torch.Tensor, v_gate: Optional[torch.Tensor] = None,
                e_gate: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        v = v_emb if v_gate is None else v_emb * v_gate
        e = e_emb if e_gate is None else e_emb * e_gate
        norms = degree_norms(graph, self.edge_norm, self_loop=True)
        for i in range(self.num_layers):
            layer = getattr(self, f"compgcn_{i}")
            if self.remat and torch.is_grad_enabled():
                v_new, e_new = remat(layer, graph, v, e, train, norms,
                                     generator=generator)
            else:
                v_new, e_new = layer(graph, v, e, train, norms, generator)
            if v_gate is not None:
                v_new = v_new * v_gate
            if e_gate is not None:
                e_new = e_new * e_gate
            if self.residual and v_new.shape == v.shape \
                    and e_new.shape == e.shape:
                v, e = v + v_new, e + e_new
            else:
                v, e = v_new, e_new
        return v, e


class CompGCN(GraphAdjModelV2):
    """CompGCN SCM model (reference compgcn.py:289-385)."""

    def make_rep_net(self, generator) -> nn.Module:
        cfg = self.cfg
        return CompGCNStack(
            num_layers=cfg.rep_num_graph_layers, in_dim=cfg.hid_dim,
            hidden_dim=cfg.hid_dim, comp_opt=cfg.rep_compgcn_comp_opt,
            edge_norm=cfg.rep_compgcn_edge_norm,
            batch_norm=cfg.rep_compgcn_batch_norm, act=cfg.rep_act_func,
            dropout=cfg.rep_dropout, residual=cfg.rep_residual,
            remat=cfg.rep_remat, generator=generator)
