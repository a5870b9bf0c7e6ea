"""Local relational pooling: LRP and DMPLRP
(dualmessagepassing_tpu/models/lrp.py: LRPGraphBatch 38-46, perm_project
49-70, perm_mean_pool 73-82, LRPLayer 85-122, DMPLRPPoolLayer 125-160,
LRPStack 163-191, DMPLRPStack 194-231, LRP 234-241, DMPLRP 244-257;
reference SubgraphCountingMatching/models/lrp.py:18-214, dmplrp.py:
19-330). The perm tables come from data/lrp.py through data/dataset.
batchify_lrp.

perm_project is the reference's N2P/E2P spmm and einsum('dab,bca->dc'):

  perm_feat[p] = sum_i  h[node(p, i)] @ W[:, :, i, i]
               + sum_ij e[edge(p, i, j)] @ W[:, :, i, j]   (cells with an edge)

The JAX package loops over the S node cells and the S^2 edge cells, a
take_along_axis and a product each. Here the node and edge streams are
one [B, V + E, D] table, the cells one [B, P*(S + S^2)] index into it
(edge ids offset by V), the cells without a node or an edge masked like
pads: ONE gather (ops/scatter.gather_nodes, its backward one float32 K3
sum, where 20 take_along_axis backwards would each sum bf16 under amp)
and ONE [B*P, (S + S^2)*D] @ [(S + S^2)*D, H] product, W[:, :, i, i]
serving both the node cell i and the edge cell (i, i), as in the JAX
loop. perm_mean_pool is scatter_sum_edges over the perms' owners (K3) over
their count (K3 of the perm mask, float32).

K3 per stack: LRP launches it forward once per layer (the pool) and once
each for the pool counts and the in-degrees; DMPLRP once per layer for
the pool and once per layer in its DMPLayer, and once each for the pool
counts and the out-degrees. The backward launches it once per layer for
the cell gather, and DMPLRP twice more per layer in its DMPLayer. The
counts and degrees are computed once per stack (the JAX layers recompute
them per layer; the numbers are the same).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..graph import GraphBatch
from ..ops.scatter import bincount_batched, gather_nodes, scatter_sum_edges
from ..utils.act import map_activation_str_to_fn
from ..utils.init import calculate_gain, xavier_uniform
from .basemodel import GraphAdjModelV2
from .dmpnn import DMPLayer
from .layers import Dense, MaskedBatchNorm, dropout


@dataclasses.dataclass
class LRPGraphBatch(GraphBatch):
    """GraphBatch + the perm tables of data/lrp.py, stacked: indices
    int64, masks bool."""

    perm_node: Optional[torch.Tensor] = None       # [B, P, S]
    perm_node_mask: Optional[torch.Tensor] = None  # [B, P, S]
    perm_edge: Optional[torch.Tensor] = None       # [B, P, S, S]
    perm_edge_mask: Optional[torch.Tensor] = None  # [B, P, S, S]
    perm_owner: Optional[torch.Tensor] = None      # [B, P]
    perm_mask: Optional[torch.Tensor] = None       # [B, P]


def _check(graph) -> None:
    if getattr(graph, "perm_node", None) is None:
        raise TypeError("LRP needs an LRPGraphBatch with its perm tables "
                        "(data/dataset.GraphAdjDataset.batchify_lrp)")


def perm_cells(graph: LRPGraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx, valid) [B, P*(S + S^2)]: per perm its S node cells, then its
    S^2 edge cells (row-major), as rows of the [V + E] table."""
    _check(graph)
    b, p, s = graph.perm_node.shape
    idx = torch.cat([graph.perm_node,
                     graph.max_nodes + graph.perm_edge.reshape(b, p, s * s)],
                    -1)
    valid = torch.cat([graph.perm_node_mask,
                       graph.perm_edge_mask.reshape(b, p, s * s)], -1)
    return idx.reshape(b, -1), valid.reshape(b, -1)


def perm_project(graph: LRPGraphBatch, node_feat: torch.Tensor,
                 edge_feat: torch.Tensor, weight: torch.Tensor,
                 seq_len: int,
                 cells: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """node_feat [B, V, D], edge_feat [B, E, D], weight [D, H, S*S] ->
    [B, P, H] in the streams' promoted dtype (S from the perm tables, as
    the JAX function reads it). cells: perm_cells(graph), computed here
    when not given."""
    _check(graph)
    b, p, s = graph.perm_node.shape
    d = node_feat.shape[-1]
    dt = torch.promote_types(node_feat.dtype, edge_feat.dtype)
    idx, valid = perm_cells(graph) if cells is None else cells
    table = torch.cat([node_feat.to(dt), edge_feat.to(dt)], 1)
    rows = gather_nodes(table, idx, valid=valid)       # backward: one K3
    w = weight.to(dt).reshape(d, -1, s, s)
    # rows in the cells' order: the diagonal (i, i), then (i, j) row-major
    w_cells = torch.cat([torch.diagonal(w, 0, 2, 3).permute(2, 0, 1),
                         w.permute(2, 3, 0, 1).reshape(s * s, d, -1)], 0)
    w_cells = w_cells.reshape((s + s * s) * d, -1)
    return rows.reshape(b, p, (s + s * s) * d) @ w_cells


def perm_counts(graph: LRPGraphBatch) -> torch.Tensor:
    """[B, V] float32: the perms each node owns (K3 of the perm mask)."""
    _check(graph)
    return bincount_batched(graph.perm_owner, graph.perm_mask,
                            graph.max_nodes)


def perm_mean_pool(graph: LRPGraphBatch, perm_feat: torch.Tensor,
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, P, H] -> [B, V, H]: the mean over each node's perms
    (build_perm_pooling_matrix 'mean', reference dataset.py:1799-1814).
    The sum is K3 in float32; the count is float32 (perm_counts, given or
    computed here) cast to perm_feat's dtype."""
    summed = scatter_sum_edges(perm_feat, graph.perm_owner, graph.perm_mask,
                               graph.max_nodes)
    if counts is None:
        counts = perm_counts(graph)
    return summed / torch.clamp(counts, min=1.0).to(summed.dtype)[..., None]


class LRPLayer(nn.Module):
    """The perm-pooling layer (reference lrp.py:18-96): perm_project, bias,
    act, mean pool, times a degree factor (degnet_1(act(degnet_0(in
    degree)))), act, [BN], [mlp + act], dropout; the edge stream passes
    through."""

    def __init__(self, in_dim: int, hidden_dim: int, lrp_seq_len: int = 4,
                 use_bias: bool = True, batch_norm: bool = False,
                 use_mlp: bool = False, act: str = "relu",
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, s = hidden_dim, lrp_seq_len
        self.seq_len = s
        self.act_fn = map_activation_str_to_fn(act)
        self.dropout = dropout
        self.weight = nn.Parameter(xavier_uniform(calculate_gain(act))(
            (in_dim, h, s * s), generator))
        self.bias = nn.Parameter(torch.zeros(h)) if use_bias else None
        self.degnet_0 = Dense(1, 2 * h, init="uniform", activation=act,
                              generator=generator)
        self.degnet_1 = Dense(2 * h, h, init="uniform", activation=act,
                              generator=generator)
        self.bn = MaskedBatchNorm(h) if batch_norm else None
        self.mlp = (Dense(h, h, init="uniform", activation=act,
                          generator=generator) if use_mlp else None)

    def forward(self, graph: LRPGraphBatch, node_feat: torch.Tensor,
                edge_feat: torch.Tensor, train: bool = False,
                cells=None, counts: Optional[torch.Tensor] = None,
                in_deg: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """cells, counts, in_deg: perm_cells, perm_counts and the [B, V]
        float32 in-degrees (each computed here when not given)."""
        out = perm_project(graph, node_feat, edge_feat, self.weight,
                           self.seq_len, cells)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        out = perm_mean_pool(graph, self.act_fn(out), counts)
        if in_deg is None:
            in_deg = graph.in_degrees()
        # float32 degrees: the factor, and so the stream, is float32 under
        # amp, as in the JAX package
        factor = self.degnet_1(self.act_fn(self.degnet_0(in_deg[..., None])))
        out = self.act_fn(out * factor)
        if self.bn is not None:
            lead = out.shape[:-1]
            out = self.bn(out.reshape(-1, out.shape[-1]),
                          graph.node_mask.reshape(-1), train).reshape(
                              *lead, -1)
        if self.mlp is not None:
            out = self.act_fn(self.mlp(out))
        return dropout(out, self.dropout, train, generator), edge_feat


class DMPLRPPoolLayer(nn.Module):
    """A DMPLayer ("dmp"), then the perm projection of its two outputs
    with lrp_weight and lrp_bias, mean-pooled onto the nodes (reference
    dmplrp.py:19-198)."""

    def __init__(self, in_dim: int, hidden_dim: int, lrp_seq_len: int = 4,
                 init_neigenv: float = 4.0, init_eeigenv: float = 4.0,
                 use_bias: bool = True, num_mlp_layers: int = 2,
                 batch_norm: bool = False, act: str = "relu",
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, s = hidden_dim, lrp_seq_len
        self.seq_len = s
        self.dmp = DMPLayer(in_dim, h, init_neigenv=init_neigenv,
                            init_eeigenv=init_eeigenv, use_bias=use_bias,
                            num_mlp_layers=num_mlp_layers,
                            batch_norm=batch_norm, act=act, dropout=dropout,
                            generator=generator)
        self.lrp_weight = nn.Parameter(xavier_uniform(1.0)((h, h, s * s),
                                                           generator))
        self.lrp_bias = nn.Parameter(torch.zeros(h)) if use_bias else None

    def forward(self, graph: LRPGraphBatch, node_feat: torch.Tensor,
                edge_feat: torch.Tensor, train: bool = False,
                cells=None, counts: Optional[torch.Tensor] = None,
                out_deg: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        v_out, e_out = self.dmp(graph, node_feat, edge_feat, train, out_deg,
                                generator)
        out = perm_project(graph, v_out, e_out, self.lrp_weight,
                           self.seq_len, cells)
        if self.lrp_bias is not None:
            out = out + self.lrp_bias.to(out.dtype)
        return perm_mean_pool(graph, out, counts), e_out


def _gated(v_emb, e_emb, v_gate, e_gate):
    return (v_emb if v_gate is None else v_emb * v_gate,
            e_emb if e_gate is None else e_emb * e_gate)


class LRPStack(nn.Module):
    """LRPLayers lrp_0, lrp_1, ... with the gate/mask multiply and no
    residual, whatever rep_residual says: the reference appends v, not
    v_prev + v (lrp.py:161-167)."""

    def __init__(self, num_layers: int, in_dim: int, hidden_dim: int,
                 lrp_seq_len: int = 4, batch_norm: bool = False,
                 act: str = "relu", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"lrp_{i}", LRPLayer(
                in_dim if i == 0 else hidden_dim, hidden_dim,
                lrp_seq_len=lrp_seq_len, batch_norm=batch_norm, act=act,
                dropout=dropout, generator=generator))

    def forward(self, graph: LRPGraphBatch, v_emb: torch.Tensor,
                e_emb: torch.Tensor, v_gate: Optional[torch.Tensor] = None,
                e_gate: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        v, e = _gated(v_emb, e_emb, v_gate, e_gate)
        cells, counts = perm_cells(graph), perm_counts(graph)
        in_deg = graph.in_degrees()
        for i in range(self.num_layers):
            v, e = getattr(self, f"lrp_{i}")(graph, v, e, train, cells,
                                             counts, in_deg, generator)
            v, e = _gated(v, e, v_gate, e_gate)
        return v, e


class DMPLRPStack(nn.Module):
    """DMPLRPPoolLayers dmplrp_0, ... with the gate/mask multiply and the
    residual where shapes match (reference dmplrp.py:262-330)."""

    def __init__(self, num_layers: int, in_dim: int, hidden_dim: int,
                 lrp_seq_len: int = 4, init_neigenv: float = 4.0,
                 init_eeigenv: float = 4.0, num_mlp_layers: int = 2,
                 batch_norm: bool = False, act: str = "relu",
                 dropout: float = 0.0, residual: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        self.residual = residual
        for i in range(num_layers):
            self.add_module(f"dmplrp_{i}", DMPLRPPoolLayer(
                in_dim if i == 0 else hidden_dim, hidden_dim,
                lrp_seq_len=lrp_seq_len, init_neigenv=init_neigenv,
                init_eeigenv=init_eeigenv, num_mlp_layers=num_mlp_layers,
                batch_norm=batch_norm, act=act, dropout=dropout,
                generator=generator))

    def forward(self, graph: LRPGraphBatch, v_emb: torch.Tensor,
                e_emb: torch.Tensor, v_gate: Optional[torch.Tensor] = None,
                e_gate: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        v, e = _gated(v_emb, e_emb, v_gate, e_gate)
        cells, counts = perm_cells(graph), perm_counts(graph)
        out_deg = graph.out_degrees()
        for i in range(self.num_layers):
            v_new, e_new = getattr(self, f"dmplrp_{i}")(
                graph, v, e, train, cells, counts, out_deg, generator)
            v_new, e_new = _gated(v_new, e_new, v_gate, e_gate)
            if self.residual and v_new.shape == v.shape \
                    and e_new.shape == e.shape:
                v, e = v + v_new, e + e_new
            else:
                v, e = v_new, e_new
        return v, e


class LRP(GraphAdjModelV2):
    def make_rep_net(self, generator) -> nn.Module:
        cfg = self.cfg
        return LRPStack(cfg.rep_num_graph_layers, cfg.hid_dim, cfg.hid_dim,
                        lrp_seq_len=cfg.lrp_seq_len,
                        batch_norm=cfg.rep_lrp_batch_norm,
                        act=cfg.rep_act_func, dropout=cfg.rep_dropout,
                        generator=generator)


class DMPLRP(GraphAdjModelV2):
    def make_rep_net(self, generator) -> nn.Module:
        cfg = self.cfg
        return DMPLRPStack(
            cfg.rep_num_graph_layers, cfg.hid_dim, cfg.hid_dim,
            lrp_seq_len=cfg.lrp_seq_len, init_neigenv=cfg.init_neigenv,
            init_eeigenv=cfg.init_eeigenv,
            num_mlp_layers=cfg.rep_dmpnn_num_mlp_layers,
            batch_norm=cfg.rep_dmpnn_batch_norm, act=cfg.rep_act_func,
            dropout=cfg.rep_dropout, residual=cfg.rep_residual,
            generator=generator)
