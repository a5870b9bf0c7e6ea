"""The SCM model scaffold: encode -> filter + embed -> represent ->
interact + predict (dualmessagepassing_tpu/models/basemodel.py:
ModelConfig 39-155, EncNet 157, EmbNet 197, GraphAdjModelV2 238-452).

Reference: SubgraphCountingMatching/models/basemodel.py:965-1663
(GraphAdjModelV2). Features stay in the padded [B, V, .] / [B, E, .]
layout end to end; sharing (encoders, embeddings, the rep net) is one
submodule called for pattern and graph. forward returns the JAX model's
output dict: pred_c / pred_v / pred_e, the pattern and graph node and
edge embeddings and reps, and the masks.

The compute dtype is an argument of forward (float32, or bf16 for amp):
the gates, the encoder rows and the exact counts take it, and every
parameter is cast to it at use (models/layers.py). GraphAdjModel
(basemodel.py:454-550) is the node-only scaffold of R-GCN and R-GIN
(models/rgnn.py): no edge stream, a vertex-label gate, one vertex
predict net.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..graph import GraphBatch
from ..ops.encoding import get_enc_len
from ..ops.scatter import gather_nodes, gather_scalars
from .embed import Embedding, MultihotEncoder, PositionEncoder
from .filter import scalar_filter
from .pred import build_pred_net


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Flattened model configuration (the reference's flags, config.py),
    field for field the JAX package's, so a config translates with
    ModelConfig(**dataclasses.asdict(jax_config)). Sizes are model-facing
    (after the reversed-edge doubling, train.py:38-65)."""

    max_ngv: int
    max_ngvl: int
    max_nge: int
    max_ngel: int
    max_npv: int
    max_npvl: int
    max_npe: int
    max_npel: int
    base: int = 2
    hid_dim: int = 64
    share_emb_net: bool = True
    share_enc_net: bool = True
    share_rep_net: bool = True
    rep_residual: bool = True
    pred_with_enc: bool = False
    pred_with_deg: bool = False
    enc_net: str = "Multihot"
    emb_net: str = "Orthogonal"
    filter_net: str = "None"
    rep_net: str = "DMPNN"
    rep_num_pattern_layers: int = 3
    rep_num_graph_layers: int = 3
    rep_act_func: str = "relu"
    rep_dropout: float = 0.0
    rep_dmpnn_num_mlp_layers: int = 2
    rep_dmpnn_batch_norm: bool = False
    init_neigenv: float = 4.0
    init_eeigenv: float = 4.0
    rep_compgcn_comp_opt: str = "corr"
    rep_compgcn_edge_norm: str = "none"
    rep_compgcn_batch_norm: bool = False
    rep_rgcn_num_bases: int = 4
    rep_rgcn_regularizer: str = "bdd"
    rep_rgcn_edge_norm: str = "in"
    rep_rgcn_batch_norm: bool = False
    rep_rgin_num_bases: int = 4
    rep_rgin_regularizer: str = "bdd"
    rep_rgin_num_mlp_layers: int = 2
    rep_rgin_batch_norm: bool = False
    rep_cnn_batch_norm: bool = True
    rep_cnn_kernel_sizes: Tuple[int, ...] = (2,)
    rep_cnn_paddings: Tuple[int, ...] = (-1,)
    rep_cnn_strides: Tuple[int, ...] = (1,)
    rep_rnn_type: str = "LSTM"
    rep_rnn_bidirectional: bool = False
    rep_rnn_layer_norm: bool = False
    rep_txl_num_heads: int = 4
    rep_txl_seg_len: int = 64
    rep_txl_mem_len: int = 64
    rep_txl_clamp_len: int = -1
    rep_txl_pre_norm: bool = True
    lrp_seq_len: int = 4
    rep_lrp_batch_norm: bool = False
    gnn_add_node_id: bool = False
    gnn_add_edge_id: bool = False
    node_pred: bool = True
    edge_pred: bool = True
    pred_net: str = "SumPredictNet"
    pred_hid_dim: int = 64
    pred_act_func: str = "relu"
    pred_dropout: float = 0.0
    pred_return_weights: str = "none"
    pred_infer_steps: int = 1
    pred_num_heads: int = 4
    pred_mem_len: int = 4
    pred_mem_init: str = "mean"
    # the JAX package's lowering of the segment-sums ("onehot", "segment",
    # None = auto); every choice computes the same sum, the port has one
    scatter_method: Optional[str] = None
    # recompute each rep-net layer in the backward (DMPNN, CompGCN, R-GCN,
    # R-GIN, CNN and RNN)
    rep_remat: bool = False

    def enc_dims(self, which: str) -> Dict[str, int]:
        if which == "pattern" and not self.share_enc_net:
            nv, nvl, nel = self.max_npv, self.max_npvl, self.max_npel
        else:
            nv, nvl, nel = self.max_ngv, self.max_ngvl, self.max_ngel
        return {
            "v": get_enc_len(nv - 1, self.base) * self.base,
            "vl": get_enc_len(nvl - 1, self.base) * self.base,
            "el": get_enc_len(nel - 1, self.base) * self.base,
        }

    def rep_dims(self) -> Tuple[int, int]:
        rep_v, rep_e = self.hid_dim, self.hid_dim
        if self.pred_with_enc:
            d = self.enc_dims("graph")
            rep_v += d["v"] + d["vl"]
            rep_e += (d["v"] + d["vl"]) * 2 + d["el"]
        if self.pred_with_deg:
            rep_v += 2
            rep_e += 2
        return rep_v, rep_e

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


class EncNet(nn.Module):
    """Frozen encoder bundle {v, vl[, el]} (basemodel.py:624-662,
    973-1016)."""

    def __init__(self, cfg: ModelConfig, which: str, include_el: bool = True):
        super().__init__()
        self.cfg = cfg
        self.include_el = include_el
        if which == "pattern" and not cfg.share_enc_net:
            nv, nvl, nel = cfg.max_npv, cfg.max_npvl, cfg.max_npel
        else:
            nv, nvl, nel = cfg.max_ngv, cfg.max_ngvl, cfg.max_ngel
        if cfg.enc_net == "Multihot":
            def enc(n, _):
                return MultihotEncoder(n, cfg.base)
        elif cfg.enc_net == "Position":
            def enc(n, d):
                return PositionEncoder(d, n)
        else:
            raise NotImplementedError(f"enc_net {cfg.enc_net}")
        d = cfg.enc_dims(which)
        self.v = enc(nv, d["v"])
        self.vl = enc(nvl, d["vl"])
        self.el = enc(nel, d["el"]) if include_el else None

    def forward(self, graph: GraphBatch,
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        enc = {"v": self.v(graph.node_id, dtype),
               "vl": self.vl(graph.node_label, dtype)}
        if self.include_el:
            enc["el"] = self.el(graph.edge_label, dtype)
            if self.cfg.gnn_add_edge_id:
                enc["src"] = gather_nodes(enc["v"], graph.senders)
                enc["dst"] = gather_nodes(enc["v"], graph.receivers)
        return enc


class EmbNet(nn.Module):
    """Trainable embeddings of the encodings with the 1/enc_len rescale
    (basemodel.py:1028-1072)."""

    def __init__(self, cfg: ModelConfig, which: str, include_el: bool = True,
                 rescale: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dims = cfg.enc_dims(which)
        init = cfg.emb_net.lower()

        def emb(d):
            # 1/(enc_dim // base) = 1/enc_len (basemodel.py:1066-1071)
            return Embedding(d, cfg.hid_dim, weight_init=init,
                             scale=cfg.base / d if rescale else 1.0,
                             generator=generator)

        # flax creates a table at its first call: v only with node or
        # edge ids, el only with an edge stream
        self.vl = emb(dims["vl"])
        self.el = emb(dims["el"]) if include_el else None
        self.v = (emb(dims["v"]) if cfg.gnn_add_node_id
                  or (include_el and cfg.gnn_add_edge_id) else None)

    def forward(self, enc: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        v_emb = self.vl(enc["vl"])
        if cfg.gnn_add_node_id:
            v_emb = v_emb + self.v(enc["v"])
        if self.el is None:
            return v_emb, None
        e_emb = self.el(enc["el"])
        if cfg.gnn_add_edge_id:
            e_emb = e_emb + self.v(enc["src"]) + self.v(enc["dst"])
        return v_emb, e_emb


class GraphAdjModelV2(nn.Module):
    """Node + edge dual-stream scaffold (basemodel.py:965-1663).
    Subclasses provide make_rep_net(generator), a module called as
    (graph, v_emb, e_emb, v_gate, e_gate, train, generator) ->
    (v_rep, e_rep)."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.g_enc_net = EncNet(cfg, "graph")
        self.p_enc_net = (None if cfg.share_enc_net
                          else EncNet(cfg, "pattern"))
        self.g_emb_net = EmbNet(cfg, "graph", generator=generator)
        self.p_emb_net = (None if cfg.share_emb_net
                          else EmbNet(cfg, "pattern", generator=generator))
        self.g_rep_net = self.make_rep_net(generator)
        self.p_rep_net = (None if cfg.share_rep_net
                          else self.make_rep_net(generator))
        rep_v_dim, rep_e_dim = cfg.rep_dims()
        kw = dict(act=cfg.pred_act_func, dropout=cfg.pred_dropout,
                  generator=generator, infer_steps=cfg.pred_infer_steps,
                  num_heads=cfg.pred_num_heads, mem_len=cfg.pred_mem_len,
                  mem_init=cfg.pred_mem_init)
        self.pred_net_v = self.pred_net_e = None
        if cfg.node_pred:
            self.pred_net_v = build_pred_net(
                cfg.pred_net, rep_v_dim, cfg.pred_hid_dim,
                return_weights="node" in cfg.pred_return_weights, **kw)
        if cfg.edge_pred:
            self.pred_net_e = build_pred_net(
                cfg.pred_net, rep_e_dim, cfg.pred_hid_dim,
                return_weights="edge" in cfg.pred_return_weights, **kw)

    def make_rep_net(self, generator) -> nn.Module:
        raise NotImplementedError

    def get_filter_gate(self, pattern: GraphBatch, graph: GraphBatch,
                        dtype: torch.dtype):
        """ScalarFilter gates [B, V, 1] / [B, E, 1] (basemodel.py:
        1394-1423), or (None, None)."""
        if self.cfg.filter_net == "None":
            return None, None
        if self.cfg.filter_net != "ScalarFilter":
            raise ValueError(self.cfg.filter_net)
        vl_gate = scalar_filter(pattern.node_label, graph.node_label,
                                pattern.node_mask)
        el_gate = scalar_filter(pattern.edge_label, graph.edge_label,
                                pattern.edge_mask)
        return vl_gate.to(dtype)[..., None], el_gate.to(dtype)[..., None]

    def forward(self, pattern: GraphBatch, graph: GraphBatch,
                train: bool = False, dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        cfg = self.cfg
        p_v_mask, g_v_mask = pattern.node_mask, graph.node_mask
        p_e_mask, g_e_mask = pattern.edge_mask, graph.edge_mask
        vl_gate, el_gate = self.get_filter_gate(pattern, graph, dtype)

        p_enc_net = self.p_enc_net or self.g_enc_net
        p_emb_net = self.p_emb_net or self.g_emb_net
        p_rep_net = self.p_rep_net or self.g_rep_net

        def gate(mask):
            return mask.to(dtype)[..., None]

        p_enc = p_enc_net(pattern, dtype)
        p_v_emb, p_e_emb = p_emb_net(p_enc)
        p_v_rep, p_e_rep = p_rep_net(
            pattern, p_v_emb, p_e_emb, gate(p_v_mask), gate(p_e_mask),
            train, generator)

        g_enc = self.g_enc_net(graph, dtype)
        g_v_emb, g_e_emb = self.g_emb_net(g_enc)
        g_v_gate, g_e_gate = gate(g_v_mask), gate(g_e_mask)
        if vl_gate is not None:
            g_v_gate = g_v_gate * vl_gate
            g_e_gate = g_e_gate * el_gate
        g_v_rep, g_e_rep = self.g_rep_net(
            graph, g_v_emb, g_e_emb, g_v_gate, g_e_gate, train, generator)

        # reversed edges never reach the prediction (basemodel.py:1521-1531)
        p_e_mask = p_e_mask & ~pattern.rev_flag
        g_e_mask = g_e_mask & ~graph.rev_flag

        if cfg.pred_with_deg:
            p_out_deg, p_in_deg = pattern.out_degrees(), pattern.in_degrees()
            g_out_deg, g_in_deg = graph.out_degrees(), graph.in_degrees()

        # ---- node head inputs (basemodel.py:1540-1577) ----------------------
        p_v_out = g_v_out = None
        if cfg.node_pred:
            p_v_add, g_v_add = [], []
            if cfg.pred_with_enc:
                p_v_add += [p_enc["v"], p_enc["vl"]]
                g_v_add += [g_enc["v"], g_enc["vl"]]
            if cfg.pred_with_deg:
                p_v_add += [p_out_deg[..., None], p_in_deg[..., None]]
                g_v_add += [g_out_deg[..., None], g_in_deg[..., None]]
            p_v_out = _prepend(p_v_add, p_v_rep) * p_v_mask[..., None]
            g_v_out = _prepend(g_v_add, g_v_rep) * g_v_mask[..., None]

        # ---- edge head inputs (basemodel.py:1582-1627) ----------------------
        p_e_out = g_e_out = None
        if cfg.edge_pred:
            p_e_add, g_e_add = [], []
            if cfg.pred_with_enc:
                for enc, gb, add in ((p_enc, pattern, p_e_add),
                                     (g_enc, graph, g_e_add)):
                    add += [gather_nodes(enc["v"], gb.senders),
                            gather_nodes(enc["v"], gb.receivers),
                            gather_nodes(enc["vl"], gb.senders), enc["el"],
                            gather_nodes(enc["vl"], gb.receivers)]
            if cfg.pred_with_deg:
                p_e_add += [gather_scalars(p_out_deg, pattern.senders)[
                    ..., None], gather_scalars(p_in_deg, pattern.receivers)[
                    ..., None]]
                g_e_add += [gather_scalars(g_out_deg, graph.senders)[
                    ..., None], gather_scalars(g_in_deg, graph.receivers)[
                    ..., None]]
            p_e_out = _prepend(p_e_add, p_e_rep) * p_e_mask[..., None]
            g_e_out = _prepend(g_e_add, g_e_rep) * g_e_mask[..., None]

        # ---- dual-head prediction (basemodel.py:1477-1498) ------------------
        pred_v = pred_e = v_pred_c = e_pred_c = None
        if cfg.node_pred:
            v_pred_c, pred_v = self.pred_net_v(
                p_v_out, p_v_mask, g_v_out, g_v_mask, train, generator)
        if cfg.edge_pred:
            e_pred_c, pred_e = self.pred_net_e(
                p_e_out, p_e_mask, g_e_out, g_e_mask, train, generator)
        if cfg.node_pred and cfg.edge_pred:
            # exact counts: summed in float32, then the compute dtype
            g_v_len = g_v_mask.float().sum(1, keepdim=True).to(dtype)
            g_e_len = g_e_mask.float().sum(1, keepdim=True).to(dtype)
            g_len = g_v_len + g_e_len
            pred_c = (g_v_len / g_len) * v_pred_c + (g_e_len / g_len) * e_pred_c
        elif cfg.node_pred:
            pred_c = v_pred_c
        elif cfg.edge_pred:
            pred_c = e_pred_c
        else:
            raise ValueError("at least one of node_pred/edge_pred required")

        return {
            "p_v_emb": p_v_emb, "p_e_emb": p_e_emb,
            "g_v_emb": g_v_emb, "g_e_emb": g_e_emb,
            "p_v_rep": p_v_rep, "p_e_rep": p_e_rep,
            "g_v_rep": g_v_rep, "g_e_rep": g_e_rep,
            "p_v_mask": p_v_mask, "p_e_mask": p_e_mask,
            "g_v_mask": g_v_mask, "g_e_mask": g_e_mask,
            "pred_c": pred_c, "pred_v": pred_v, "pred_e": pred_e,
        }


def _prepend(extra, rep: torch.Tensor) -> torch.Tensor:
    """concat(extra + [rep]) on the last axis (dtypes promote as in
    jnp.concatenate), rep alone without extras."""
    if not extra:
        return rep
    return torch.cat([torch.cat(extra, -1), rep], -1)


class GraphAdjModel(nn.Module):
    """Node-only scaffold of R-GCN and R-GIN (basemodel.py:454-550,
    reference basemodel.py:619-962): the rep net sees the vertex stream
    and reads the edge labels as relation types; there is no edge stream
    and no edge head. Its embeddings have no 1/enc_len rescale
    (BaseModel.create_emb_net, reference basemodel.py:69-91). Subclasses
    provide make_rep_net(generator), a module called as (graph, v_emb,
    v_gate, train, generator) -> v_rep."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.g_enc_net = EncNet(cfg, "graph", include_el=False)
        self.p_enc_net = (None if cfg.share_enc_net
                          else EncNet(cfg, "pattern", include_el=False))
        self.g_emb_net = EmbNet(cfg, "graph", include_el=False,
                                rescale=False, generator=generator)
        self.p_emb_net = (None if cfg.share_emb_net else EmbNet(
            cfg, "pattern", include_el=False, rescale=False,
            generator=generator))
        self.g_rep_net = self.make_rep_net(generator)
        self.p_rep_net = (None if cfg.share_rep_net
                          else self.make_rep_net(generator))
        self.pred_net_v = build_pred_net(
            cfg.pred_net, cfg.rep_dims()[0], cfg.pred_hid_dim,
            act=cfg.pred_act_func, dropout=cfg.pred_dropout,
            return_weights="node" in cfg.pred_return_weights,
            generator=generator, infer_steps=cfg.pred_infer_steps,
            num_heads=cfg.pred_num_heads, mem_len=cfg.pred_mem_len,
            mem_init=cfg.pred_mem_init)

    def make_rep_net(self, generator) -> nn.Module:
        raise NotImplementedError

    def forward(self, pattern: GraphBatch, graph: GraphBatch,
                train: bool = False, dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        cfg = self.cfg
        p_v_mask, g_v_mask = pattern.node_mask, graph.node_mask
        p_enc_net = self.p_enc_net or self.g_enc_net
        p_emb_net = self.p_emb_net or self.g_emb_net
        p_rep_net = self.p_rep_net or self.g_rep_net

        p_enc = p_enc_net(pattern, dtype)
        p_v_emb, _ = p_emb_net(p_enc)
        p_v_rep = p_rep_net(pattern, p_v_emb, p_v_mask.to(dtype)[..., None],
                            train, generator)

        g_enc = self.g_enc_net(graph, dtype)
        g_v_emb, _ = self.g_emb_net(g_enc)
        g_v_gate = g_v_mask.to(dtype)[..., None]
        if cfg.filter_net == "ScalarFilter":    # the vl gate only (820-837)
            g_v_gate = g_v_gate * scalar_filter(
                pattern.node_label, graph.node_label,
                pattern.node_mask).to(dtype)[..., None]
        elif cfg.filter_net != "None":
            raise ValueError(cfg.filter_net)
        g_v_rep = self.g_rep_net(graph, g_v_emb, g_v_gate, train, generator)

        p_add, g_add = [], []
        if cfg.pred_with_enc:
            p_add += [p_enc["v"], p_enc["vl"]]
            g_add += [g_enc["v"], g_enc["vl"]]
        if cfg.pred_with_deg:
            p_add += [pattern.out_degrees()[..., None],
                      pattern.in_degrees()[..., None]]
            g_add += [graph.out_degrees()[..., None],
                      graph.in_degrees()[..., None]]
        p_v_out = _prepend(p_add, p_v_rep) * p_v_mask[..., None]
        g_v_out = _prepend(g_add, g_v_rep) * g_v_mask[..., None]
        pred_c, pred_v = self.pred_net_v(p_v_out, p_v_mask, g_v_out,
                                         g_v_mask, train, generator)
        return {
            "p_v_emb": p_v_emb, "p_e_emb": None,
            "g_v_emb": g_v_emb, "g_e_emb": None,
            "p_v_rep": p_v_rep, "p_e_rep": None,
            "g_v_rep": g_v_rep, "g_e_rep": None,
            "p_v_mask": p_v_mask, "p_e_mask": None,
            "g_v_mask": g_v_mask, "g_e_mask": None,
            "pred_c": pred_c, "pred_v": pred_v, "pred_e": None,
        }
