"""The dual message passing layer of the SCM models
(dualmessagepassing_tpu/models/dmpnn.py: DMPLayer 45-139, DMPNNStack
142-198).

Reference: SubgraphCountingMatching/models/dmpnn.py:16-277. Per edge
(u --e--> v), forward or reversed by rev_flag:

  node message (summed at v):  fwd -E_e @ W_in        rev +E_e @ W_out
  edge message (kept per edge): fwd H_v @ W_dst - H_u @ W_src
                                rev H_u @ W_dst - H_v @ W_src
  node update  H'_v = MLP(H_v @ W_nloop + agg_v + b_n)
  edge update  E'_e = MLP(E_e @ W_eloop + 2 (1 + d) E_e @ (W_src - W_dst)
                          + edge_msg_e + b_e),  d = log2(1 + outdeg(v))

W_in/W_out/W_nloop are drawn divided by init_neigenv, W_src/W_dst/
W_eloop by init_eeigenv (dmpnn.py:79-86).

The endpoint products are one [B, V, 2H] table (H @ [W_src | W_dst]),
gathered per edge at both ends (ops/scatter.gather_nodes: an
index_select, its backward K3); the node aggregation is
ops/scatter.scatter_sum_edges (K3, backward a row gather). The
out-degrees are K3 of the edge mask, once per stack (the JAX layer
recomputes them per layer; the numbers are the same). Per layer a
forward launches K3 once (the aggregation) and a backward twice (the two
endpoint gathers); a stack adds one forward launch (the degrees).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..graph import GraphBatch
from ..ops.scatter import gather_nodes, gather_scalars, scatter_sum_edges
from ..utils.act import map_activation_str_to_fn
from ..utils.init import calculate_gain, scaled, xavier_uniform
from .layers import UpdateMLP, dropout, remat


class DMPLayer(nn.Module):
    """One dual-message-passing layer over a padded GraphBatch."""

    def __init__(self, in_dim: int, hidden_dim: int,
                 init_neigenv: float = 4.0, init_eeigenv: float = 4.0,
                 use_bias: bool = True, num_mlp_layers: int = 2,
                 batch_norm: bool = False, act: str = "relu",
                 dropout: float = 0.0, scatter_method: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.act = act
        self.dropout = dropout
        self.scatter_method = scatter_method
        gain = calculate_gain(act)
        n_init = scaled(xavier_uniform(gain), 1.0 / init_neigenv)
        e_init = scaled(xavier_uniform(gain), 1.0 / init_eeigenv)
        shape = (in_dim, hidden_dim)
        for name, init in (("in_weight", n_init), ("out_weight", n_init),
                           ("nloop_weight", n_init), ("src_weight", e_init),
                           ("dst_weight", e_init), ("eloop_weight", e_init)):
            setattr(self, name, nn.Parameter(init(shape, generator)))
        self.use_bias = use_bias
        if use_bias:
            self.nbias = nn.Parameter(torch.zeros(hidden_dim))
            self.ebias = nn.Parameter(torch.zeros(hidden_dim))
        self.nmlp = self.emlp = None
        if num_mlp_layers > 0:
            self.nmlp = UpdateMLP(hidden_dim, hidden_dim, num_mlp_layers,
                                  batch_norm, act, generator=generator)
            self.emlp = UpdateMLP(hidden_dim, hidden_dim, num_mlp_layers,
                                  batch_norm, act, generator=generator)

    def forward(self, graph: GraphBatch, node_feat: torch.Tensor,
                edge_feat: torch.Tensor, train: bool = False,
                out_deg: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                update_stats: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """node_feat [B, V, Din], edge_feat [B, E, Din] -> ([B, V, H],
        [B, E, H]) in node_feat's dtype; out_deg [B, V] float32 (computed
        here when not given); update_stats=False leaves the BatchNorm
        statistics as they are (a rematerialised layer's recomputation)."""
        h = self.hidden_dim
        dt = node_feat.dtype
        w_src, w_dst = self.src_weight.to(dt), self.dst_weight.to(dt)
        senders, receivers = graph.senders, graph.receivers
        e_mask = graph.edge_mask
        rev = graph.rev_flag[..., None]
        method = self.scatter_method

        # one [B, V, 2H] product: each edge endpoint needs one gather
        hw = node_feat @ torch.cat([w_src, w_dst], dim=1)
        ew_in = edge_feat @ self.in_weight.to(dt)
        ew_out = edge_feat @ self.out_weight.to(dt)
        src_w = gather_nodes(hw, senders, method)       # backward K3
        dst_w = gather_nodes(hw, receivers, method)     # backward K3
        edge_msg = torch.where(rev, src_w[..., h:] - dst_w[..., :h],
                               dst_w[..., h:] - src_w[..., :h])
        node_msg = torch.where(rev, ew_out, -ew_in)
        agg = scatter_sum_edges(node_msg, receivers, e_mask,
                                graph.max_nodes, method)   # K3

        v_out = node_feat @ self.nloop_weight.to(dt) + agg
        if self.use_bias:
            v_out = v_out + self.nbias.to(dt)
        if self.nmlp is not None:
            v_out = self.nmlp(v_out, graph.node_mask, train, update_stats)
        else:
            v_out = map_activation_str_to_fn(self.act)(v_out)
        v_out = dropout(v_out, self.dropout, train, generator)

        if out_deg is None:
            out_deg = graph.out_degrees()
        d = gather_scalars(out_deg, receivers, method)  # outdeg at dst
        # degrees are float32 counts; cast so bf16 compute is not
        # promoted back to float32 through the edge stream
        d = torch.log2(1.0 + d)[..., None].to(edge_feat.dtype)
        add = 2.0 * (1.0 + d) * (edge_feat @ (w_src - w_dst))
        e_out = edge_feat @ self.eloop_weight.to(dt) + add + edge_msg
        if self.use_bias:
            e_out = e_out + self.ebias.to(dt)
        if self.emlp is not None:
            e_out = self.emlp(e_out, e_mask, train, update_stats)
        else:
            e_out = map_activation_str_to_fn(self.act)(e_out)
        e_out = dropout(e_out, self.dropout, train, generator)
        return v_out, e_out


class DMPNNStack(nn.Module):
    """DMPLayers dmpnn_0, dmpnn_1, ... with the gate/mask multiply and a
    residual where shapes match (reference DMPNN.get_pattern_rep /
    get_graph_rep, dmpnn.py:215-277): inputs are gated before the first
    layer, every layer's output is gated again.

    remat=True recomputes each layer in the backward, as the JAX
    package's nn.remat does (models/layers.remat: the same dropout masks,
    the BatchNorm statistics updated once).
    """

    def __init__(self, num_layers: int, in_dim: int, hidden_dim: int,
                 init_neigenv: float = 4.0, init_eeigenv: float = 4.0,
                 num_mlp_layers: int = 2, batch_norm: bool = False,
                 act: str = "relu", dropout: float = 0.0,
                 residual: bool = True, scatter_method: Optional[str] = None,
                 remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        self.residual = residual
        self.remat = remat
        for i in range(num_layers):
            self.add_module(f"dmpnn_{i}", DMPLayer(
                in_dim if i == 0 else hidden_dim, hidden_dim,
                init_neigenv=init_neigenv, init_eeigenv=init_eeigenv,
                num_mlp_layers=num_mlp_layers, batch_norm=batch_norm,
                act=act, dropout=dropout, scatter_method=scatter_method,
                generator=generator))

    def forward(self, graph: GraphBatch, v_emb: torch.Tensor,
                e_emb: torch.Tensor, v_gate: Optional[torch.Tensor] = None,
                e_gate: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        v = v_emb if v_gate is None else v_emb * v_gate
        e = e_emb if e_gate is None else e_emb * e_gate
        out_deg = graph.out_degrees()
        for i in range(self.num_layers):
            layer = getattr(self, f"dmpnn_{i}")
            if self.remat and torch.is_grad_enabled():
                v_new, e_new = remat(layer, graph, v, e, train, out_deg,
                                     generator=generator)
            else:
                v_new, e_new = layer(graph, v, e, train, out_deg, generator)
            if v_gate is not None:
                v_new = v_new * v_gate
            if e_gate is not None:
                e_new = e_new * e_gate
            if self.residual and v_new.shape == v.shape \
                    and e_new.shape == e.shape:
                v = v + v_new
                e = e + e_new
            else:
                v, e = v_new, e_new
        return v, e
