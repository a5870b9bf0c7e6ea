"""The SCM sequence networks CNN, RNN and TransformerXL over edge
sequences (dualmessagepassing_tpu/models/edgeseq.py: the EdgeSeqModel
scaffold 49-223, CNN 230-353, RNN 360-427, TXL 434-600).

Reference: SubgraphCountingMatching/models/basemodel.py:222-616
(EdgeSeqModel), cnn.py, rnn.py, txl.py. The scaffold encodes the five
tuple fields (u, v, ul, el, vl), sums their embeddings (no 1/enc_len
rescale), gates the graph's tuples by the label filter (ul & el & vl),
runs the sequence network and predicts over the sequence, whose length
CNN's pooling changes: refine_edge_weights takes masks, the extra
prediction features and the weight targets (train/scm_driver) to the
new length.

As in the JAX package the padding is post-padding with masks. The mask
and filter gates are float32 (edgeseq.py:153,169,174), so under amp a
bf16 embedding is promoted by them and the sequence networks and the
predict net compute in float32, with the JAX package's parameters cast
to bf16 (cast_floats) and promoted back. The port does the same: under
a bf16 `dtype` the forward runs on its parameters rounded to bf16 and
back to float32 (the rounding passes the gradient, rounded to bf16, to
the float32 masters), and each parameter is cast to its input's dtype
at use, as everywhere in the port. The rounding is done once for the
whole model, not at use: casting at use casts to the input's dtype,
float32 here after the gates, and rounds nothing, and rounding at use
would take the amp dtype into every consumer of a parameter, the
predict nets and layers shared with the graph networks among them.

Parameters keep the flax paths (g_rep_net.cnn_0.conv.kernel [k, in,
out], g_rep_net.rnn_1.OptimizedLSTMCell_0.hf.kernel [h, h] and .bias,
g_rep_net.attn_0.q_kernel, ...), so models/scm_models.params_from_flax
takes a JAX model's tree without a table of names. The recurrences do
not loop in Python: each call builds the cuDNN weight buffer from the
flax kernels (torch.lstm / torch.gru / torch.rnn_tanh, one layer, batch
first). A bidirectional RNN runs its backward direction over the whole
padded sequence, pad steps first, as flax's nn.Bidirectional without
seq_lengths does (no packed sequences).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..graph import EdgeSeqBatch
from ..ops.encoding import get_enc_len, position_table
from ..utils.act import map_activation_str_to_fn
from ..utils.init import calculate_gain, kaiming_normal
from .basemodel import ModelConfig
from .embed import Embedding, MultihotEncoder, PositionEncoder
from .filter import scalar_filter
from .layers import (Dense, LayerNorm, MaskedBatchNorm, dropout, remat,
                     rounded_params)
from .pred import build_pred_net

_FIELDS = ("u", "v", "ul", "el", "vl")


# =============================================================================
# scaffold
# =============================================================================

class EdgeSeqEncNet(nn.Module):
    """The five frozen encoders (basemodel.py:226-284)."""

    def __init__(self, cfg: ModelConfig, which: str):
        super().__init__()
        if which == "pattern" and not cfg.share_enc_net:
            nv, nvl, nel = cfg.max_npv, cfg.max_npvl, cfg.max_npel
        else:
            nv, nvl, nel = cfg.max_ngv, cfg.max_ngvl, cfg.max_ngel
        if cfg.enc_net == "Multihot":
            def enc(n):
                return MultihotEncoder(n, cfg.base)
        elif cfg.enc_net == "Position":
            def enc(n):
                return PositionEncoder(get_enc_len(n - 1, cfg.base)
                                       * cfg.base, n)
        else:
            raise NotImplementedError(f"enc_net {cfg.enc_net}")
        for name, n in zip(_FIELDS, (nv, nv, nvl, nel, nvl)):
            self.add_module(name, enc(n))

    def forward(self, seq: EdgeSeqBatch,
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k)(getattr(seq, k), dtype) for k in _FIELDS}


class EdgeSeqEmbNet(nn.Module):
    """The summed five-field embedding (basemodel.py:484-500), without
    the 1/enc_len rescale (BaseModel.create_emb_net, basemodel.py:69-91)."""

    def __init__(self, cfg: ModelConfig, which: str,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = cfg.enc_dims(which)
        for name, d in zip(_FIELDS, ("v", "v", "vl", "el", "vl")):
            self.add_module(name, Embedding(
                dims[d], cfg.hid_dim, weight_init=cfg.emb_net.lower(),
                generator=generator))

    def forward(self, enc: Dict[str, torch.Tensor]) -> torch.Tensor:
        return (self.u(enc["u"]) + self.v(enc["v"]) + self.ul(enc["ul"])
                + self.el(enc["el"]) + self.vl(enc["vl"]))


def _gate(mask: Optional[torch.Tensor], gate: Optional[torch.Tensor]):
    """The stacks' combined gate: mask, gate, their product, or None."""
    if mask is None:
        return gate
    return mask if gate is None else mask * gate


class EdgeSeqModel(nn.Module):
    """The sequence scaffold (basemodel.py:222-616). Subclasses provide
    make_rep_net(generator), a module called as (emb, mask, gate, train,
    generator) -> rep, and rep_width(), the width of that rep."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.g_enc_net = EdgeSeqEncNet(cfg, "graph")
        self.p_enc_net = (None if cfg.share_enc_net
                          else EdgeSeqEncNet(cfg, "pattern"))
        self.g_emb_net = EdgeSeqEmbNet(cfg, "graph", generator)
        self.p_emb_net = (None if cfg.share_emb_net
                          else EdgeSeqEmbNet(cfg, "pattern", generator))
        self.g_rep_net = self.make_rep_net(generator)
        self.p_rep_net = (None if cfg.share_rep_net
                          else self.make_rep_net(generator))
        # flax sizes the predict net from its inputs: the rep, then the
        # five encodings (pred_with_enc) and the two degrees (pred_with_deg)
        def width(which):
            d = cfg.enc_dims(which)
            extra = (2 * d["v"] + 2 * d["vl"] + d["el"]
                     if cfg.pred_with_enc else 0)
            return self.rep_width() + extra + (2 if cfg.pred_with_deg
                                               else 0)
        self.pred_net = build_pred_net(
            cfg.pred_net, width("graph"), cfg.pred_hid_dim,
            act=cfg.pred_act_func, dropout=cfg.pred_dropout,
            return_weights="edge" in cfg.pred_return_weights,
            generator=generator, p_rep_dim=width("pattern"),
            infer_steps=cfg.pred_infer_steps, num_heads=cfg.pred_num_heads,
            mem_len=cfg.pred_mem_len, mem_init=cfg.pred_mem_init)

    def make_rep_net(self, generator) -> nn.Module:
        raise NotImplementedError

    def rep_width(self) -> int:
        return self.cfg.hid_dim

    # CNN overrides these to follow its pooling's length changes;
    # train/scm_driver.refine_weights applies them to the weight targets
    # too (reference train.py:630,641)
    def refine_edge_weights(self, w: torch.Tensor,
                            use_max: bool = False) -> torch.Tensor:
        return w

    def refine_node_weights(self, w: torch.Tensor,
                            use_max: bool = False) -> torch.Tensor:
        return w

    def get_filter_gate(self, pattern: EdgeSeqBatch,
                        graph: EdgeSeqBatch) -> Optional[torch.Tensor]:
        """ScalarFilter's gate ul & el & vl, float32 [B, L, 1], or None."""
        if self.cfg.filter_net == "None":
            return None
        if self.cfg.filter_net != "ScalarFilter":
            raise ValueError(self.cfg.filter_net)
        pm = pattern.mask
        keep = (scalar_filter(pattern.ul, graph.ul, pm)
                & scalar_filter(pattern.vl, graph.vl, pm)
                & scalar_filter(pattern.el, graph.el, pm))
        return keep.float()[..., None]

    def forward(self, pattern: EdgeSeqBatch, graph: EdgeSeqBatch,
                train: bool = False, dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None,
                params_rounded: bool = False) -> Dict[str, Any]:
        """Under a `dtype` other than float32 the forward runs again on
        the parameters rounded to it (functional_call, params_rounded),
        which are used in float32 where the float32 gates promote (the
        module docstring)."""
        if dtype == torch.float32 or params_rounded:
            return self._forward(pattern, graph, train, dtype, generator)
        return functional_call(self, rounded_params(self, dtype), (
            pattern, graph), dict(
            train=train, dtype=dtype, generator=generator,
            params_rounded=True))

    def _forward(self, pattern, graph, train, dtype, generator):
        cfg = self.cfg
        p_mask, g_mask = pattern.mask, graph.mask
        el_gate = self.get_filter_gate(pattern, graph)
        p_enc_net = self.p_enc_net or self.g_enc_net
        p_emb_net = self.p_emb_net or self.g_emb_net
        p_rep_net = self.p_rep_net or self.g_rep_net

        # the pattern is masked, the graph gated (edgeseq.py:167-177)
        p_enc = p_enc_net(pattern, dtype)
        p_e_emb = p_emb_net(p_enc)
        p_e_rep = p_rep_net(p_e_emb, p_mask.float()[..., None], None, train,
                            generator)
        g_enc = self.g_enc_net(graph, dtype)
        g_e_emb = self.g_emb_net(g_enc)
        g_gate = g_mask.float()[..., None]
        if el_gate is not None:
            g_gate = g_gate * el_gate
        g_e_rep = self.g_rep_net(g_e_emb, None, g_gate, train, generator)

        # reversed edges leave the prediction masks (basemodel.py:531-535)
        p_e_mask = p_mask & ~pattern.rev_flag
        g_e_mask = g_mask & ~graph.rev_flag

        p_add, g_add = [], []
        if cfg.pred_with_enc:
            p_add += [p_enc[k] for k in _FIELDS]
            g_add += [g_enc[k] for k in _FIELDS]
        if cfg.pred_with_deg:
            for seq, add in ((pattern, p_add), (graph, g_add)):
                add += [torch.gather(seq.out_degrees(), 1, seq.u)[..., None],
                        torch.gather(seq.in_degrees(), 1, seq.v)[..., None]]
        if p_add:
            p_feat = self.refine_edge_weights(
                torch.cat(p_add, -1) * p_e_mask[..., None])
            g_feat = self.refine_edge_weights(
                torch.cat(g_add, -1) * g_e_mask[..., None])
            p_e_out = torch.cat([p_feat, p_e_rep], -1)
            g_e_out = torch.cat([g_feat, g_e_rep], -1)
        else:
            p_e_out, g_e_out = p_e_rep, g_e_rep

        def refine_mask(m):
            return self.refine_edge_weights(m.float()[..., None],
                                            use_max=True)[..., 0] > 0

        p_e_mask, g_e_mask = refine_mask(p_e_mask), refine_mask(g_e_mask)
        pred_c, pred_e = self.pred_net(p_e_out, p_e_mask, g_e_out, g_e_mask,
                                       train, generator)
        return {
            "p_v_emb": None, "p_e_emb": p_e_emb,
            "g_v_emb": None, "g_e_emb": g_e_emb,
            "p_v_rep": None, "p_e_rep": p_e_rep,
            "g_v_rep": None, "g_e_rep": g_e_rep,
            "p_v_mask": None, "p_e_mask": p_e_mask,
            "g_v_mask": None, "g_e_mask": g_e_mask,
            "pred_c": pred_c, "pred_v": None, "pred_e": pred_e,
        }


# =============================================================================
# CNN (reference cnn.py:13-237)
# =============================================================================

def _pool1d(x: torch.Tensor, kernel: int, stride: int, padding: int,
            use_max: bool) -> torch.Tensor:
    """jax.lax.reduce_window over axis 1 of x [B, L, C]: windows of
    `kernel` rows every `stride` rows of x padded by `padding` rows on
    each side with the reduction's identity (-inf for max, 0 for the
    sum); (L + 2 padding - kernel) // stride + 1 windows, none when that
    is not positive. Windows that lie in the padding alone give the
    identity. torch's pooling would refuse padding > kernel / 2, so the
    padding is made here."""
    if kernel < 1 or stride < 1:
        raise ValueError(f"pooling window {kernel}, stride {stride}: both "
                         "must be positive")
    b, n, c = x.shape
    if padding:
        pad = x.new_full((b, padding, c), -math.inf if use_max else 0.0)
        x = torch.cat([pad, x, pad], 1)
    if n + 2 * padding < kernel:
        return x.new_zeros((b, 0, c))
    if use_max:
        # max_pool1d's gradient goes to the first maximum of a window, as
        # XLA's select-and-scatter does
        return F.max_pool1d(x.transpose(1, 2), kernel, stride).transpose(1, 2)
    return x.unfold(1, kernel, stride).sum(-1)


def max_pool1d(x, kernel, stride, padding):
    """torch MaxPool1d's semantics on [B, L, C], padding with -inf."""
    return _pool1d(x, kernel, stride, padding, True)


class Conv1d(nn.Module):
    """flax nn.Conv over [B, L, C]: kernel [k, in, out] (kaiming-normal,
    fan-in the in axis), bias zeros, cross-correlation."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int, gain: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.kernel = nn.Parameter(kaiming_normal(gain, fan_axis=1)(
            (kernel_size, in_channels, out_channels), generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = F.conv1d(x.transpose(1, 2), self.kernel.to(dt).permute(2, 1, 0),
                     self.bias.to(dt), self.stride, self.padding)
        return y.transpose(1, 2)


class CNNLayer(nn.Module):
    """Conv1d -> act -> MaxPool -> [BN] -> dropout (reference cnn.py:
    13-62): the pool's window is kernel // stride, its padding the
    conv's."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 2, padding: int = -1, stride: int = 1,
                 batch_norm: bool = True, act: str = "relu",
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_padding = kernel_size // 2 if padding == -1 else padding
        self.pool_kernel = kernel_size // stride
        self.act_fn = map_activation_str_to_fn(act)
        self.dropout = dropout
        self.conv = Conv1d(in_channels, out_channels, kernel_size, stride,
                           self.conv_padding, calculate_gain(act), generator)
        self.bn = MaskedBatchNorm(out_channels) if batch_norm else None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                update_stats: bool = True) -> torch.Tensor:
        o = self.act_fn(self.conv(x))
        o = max_pool1d(o, self.pool_kernel, 1, self.conv_padding)
        if self.bn is not None:
            c = o.shape[-1]
            m = (torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
                 if mask is None else mask)
            o = self.bn(o.reshape(-1, c), m.reshape(-1), train,
                        update_stats).reshape(o.shape)
        return dropout(o, self.dropout, train, generator)


def cnn_geometry(cfg: ModelConfig) -> List[Tuple[int, int, int, int]]:
    """Per layer (kernel, conv padding, stride, pool kernel), shared by
    the stack and by CNN.refine_edge_weights."""
    n = cfg.rep_num_graph_layers

    def expand(t):
        t = (t,) if isinstance(t, int) else tuple(t)
        return t * n if len(t) == 1 else t

    ks = expand(cfg.rep_cnn_kernel_sizes)
    ps = expand(cfg.rep_cnn_paddings)
    ss = expand(cfg.rep_cnn_strides)
    return [(ks[i], ks[i] // 2 if ps[i] == -1 else ps[i], ss[i],
             ks[i] // ss[i]) for i in range(n)]


class CNNStack(nn.Module):
    """The gated CNN stack (reference cnn.py:112-190): the gate is pooled
    as the sequence is, and a layer's residual is added only where its
    output keeps the input's shape."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.geometry = cnn_geometry(cfg)
        for i, (k, p, s, _) in enumerate(self.geometry):
            self.add_module(f"cnn_{i}", CNNLayer(
                cfg.hid_dim, cfg.hid_dim, kernel_size=k, padding=p,
                stride=s, batch_norm=cfg.rep_cnn_batch_norm,
                act=cfg.rep_act_func, dropout=cfg.rep_dropout,
                generator=generator))

    def forward(self, emb, mask=None, gate=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        g = _gate(mask, gate)
        x = emb if g is None else emb * g
        for i, (k, p, s, pk) in enumerate(self.geometry):
            layer = getattr(self, f"cnn_{i}")
            if g is not None:
                g = max_pool1d(max_pool1d(g, k, s, p), pk, 1, p)
            m = None if g is None else g[..., 0] > 0
            if self.cfg.rep_remat and torch.is_grad_enabled():
                o = remat(layer, x, m, train, generator=generator)
            else:
                o = layer(x, m, train, generator)
            if g is not None:
                o = o * g
            x = x + o if self.cfg.rep_residual and o.shape == x.shape else o
        return x


class CNN(EdgeSeqModel):
    def make_rep_net(self, generator) -> nn.Module:
        return CNNStack(self.cfg, generator)

    def refine_edge_weights(self, w: torch.Tensor,
                            use_max: bool = False) -> torch.Tensor:
        """w [B, L, C] through the stack's pooling (reference cnn.py:192-
        237): the conv's window (a max, or a sum for use_max=False), then
        the max pool."""
        for k, p, s, pk in cnn_geometry(self.cfg):
            w = _pool1d(w, k, s, p, use_max)
            w = max_pool1d(w, pk, 1, p)
        return w


# =============================================================================
# RNN (reference rnn.py:13-124)
# =============================================================================

# flax's cell names and their dense parts (name, input side, bias), in
# the gate order of torch's weight rows
_CELLS = {
    "LSTM": ("OptimizedLSTMCell", (("ii", "i", False), ("if", "i", False),
                                   ("ig", "i", False), ("io", "i", False),
                                   ("hi", "h", True), ("hf", "h", True),
                                   ("hg", "h", True), ("ho", "h", True))),
    "GRU": ("GRUCell", (("ir", "i", True), ("iz", "i", True),
                        ("in", "i", True), ("hr", "h", False),
                        ("hz", "h", False), ("hn", "h", True))),
    "RNN": ("SimpleCell", (("i", "i", True), ("h", "h", False))),
}
_RNN_FNS = {"LSTM": torch.lstm, "GRU": torch.gru, "RNN": torch.rnn_tanh}


class RNNCell(nn.Module):
    """The parameters of one flax cell (OptimizedLSTMCell, GRUCell or
    SimpleCell), Dense parts [in, h] with the init get_initializer(
    "uniform") (edgeseq.py:370), biases zero."""

    def __init__(self, rnn_type: str, in_dim: int, hid: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.parts = _CELLS[rnn_type][1]
        self.hid = hid
        for name, side, bias in self.parts:
            self.add_module(name, Dense(in_dim if side == "i" else hid, hid,
                                        use_bias=bias, init="uniform",
                                        generator=generator))

    def weights(self) -> List[torch.Tensor]:
        """[w_ih, w_hh, b_ih, b_hh] of torch's RNN functions: the gate
        kernels transposed and stacked in torch's gate order (LSTM i, f,
        g, o; GRU r, z, n), a missing bias zero."""
        out = []
        for side in ("i", "h"):
            parts = [getattr(self, n) for n, s, _ in self.parts if s == side]
            out.append(torch.cat([p.kernel for p in parts], 1).t())
        for side in ("i", "h"):
            parts = [getattr(self, n) for n, s, _ in self.parts if s == side]
            out.append(torch.cat([
                p.bias if p.bias is not None else p.kernel.new_zeros(self.hid)
                for p in parts]))
        return out


def run_cells(rnn_type: str, cells: List[RNNCell], x: torch.Tensor,
              bidirectional: bool = False) -> torch.Tensor:
    """One recurrent layer (one cell, or a forward and a backward cell)
    over x [N, T, in] from zero states, batch first -> outputs [N, T,
    hid * len(cells)] in x's dtype, by torch's RNN function of rnn_type.
    The weights go in as one buffer in cuDNN's layout, the matrices of
    each direction (w_ih, w_hh), then their biases: cuDNN takes views
    into it as they are, and compacts any other weight list at every
    call."""
    x = x.contiguous()
    ws = [c.weights() for c in cells]
    parts = [w for w4 in ws for w in w4[:2]] + [b for w4 in ws
                                                 for b in w4[2:]]
    flat = torch.cat([p.reshape(-1) for p in parts]).to(x.dtype)
    views = [v.view(p.shape) for p, v in zip(
        parts, flat.split([p.numel() for p in parts]))]
    mats, biases = views[:2 * len(ws)], views[2 * len(ws):]
    weights = [w for d in range(0, len(mats), 2)
               for w in mats[d:d + 2] + biases[d:d + 2]]
    h0 = x.new_zeros((len(cells), x.shape[0], cells[0].hid))
    hx = (h0, h0) if rnn_type == "LSTM" else h0
    # `train` of torch's RNN functions: cuDNN keeps what its backward
    # needs only then (their dropout is 0)
    return _RNN_FNS[rnn_type](x, hx, weights, True, 1, 0.0,
                              torch.is_grad_enabled(), bidirectional,
                              True)[0]


class RNNLayer(nn.Module):
    """One recurrent layer (uni- or bidirectional, hid // 2 per direction)
    -> [LayerNorm] -> dropout, over the whole padded sequence."""

    def __init__(self, in_dim: int, hid_dim: int, rnn_type: str = "LSTM",
                 bidirectional: bool = False, layer_norm: bool = False,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if rnn_type not in _CELLS:
            raise ValueError(rnn_type)
        self.rnn_type = rnn_type
        self.bidirectional = bidirectional
        self.dropout = dropout
        self.hid = hid_dim // 2 if bidirectional else hid_dim
        name = _CELLS[rnn_type][0]
        self.cells = [f"{name}_{d}" for d in range(2 if bidirectional else 1)]
        for c in self.cells:
            self.add_module(c, RNNCell(rnn_type, in_dim, self.hid, generator))
        self.ln = LayerNorm(self.hid * len(self.cells)) if layer_norm \
            else None

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                update_stats: bool = True) -> torch.Tensor:
        o = run_cells(self.rnn_type, [getattr(self, c) for c in self.cells],
                      x, self.bidirectional)
        if self.ln is not None:
            o = self.ln(o)
        return dropout(o, self.dropout, train, generator)


class RNNStack(nn.Module):
    """The recurrent stack (reference rnn.py:60-124): the pattern (mask
    only) takes no residual, the graph (gate) does, where the shapes
    allow it (edgeseq.py:405-421)."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.rep_num_graph_layers):
            self.add_module(f"rnn_{i}", RNNLayer(
                cfg.hid_dim if i == 0 else rnn_width(cfg), cfg.hid_dim,
                cfg.rep_rnn_type, cfg.rep_rnn_bidirectional,
                cfg.rep_rnn_layer_norm, cfg.rep_dropout, generator))

    def forward(self, emb, mask=None, gate=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        g = _gate(mask, gate)
        residual = cfg.rep_residual and (gate is not None or g is None)
        x = emb if g is None else emb * g
        for i in range(cfg.rep_num_graph_layers):
            layer = getattr(self, f"rnn_{i}")
            if cfg.rep_remat and torch.is_grad_enabled():
                o = remat(layer, x, train, generator=generator)
            else:
                o = layer(x, train, generator)
            if g is not None:
                o = o * g
            x = x + o if residual and o.shape == x.shape else o
        return x


def rnn_width(cfg: ModelConfig) -> int:
    """The rep's width: hid_dim, or 2 (hid_dim // 2) bidirectional."""
    return 2 * (cfg.hid_dim // 2) if cfg.rep_rnn_bidirectional \
        else cfg.hid_dim


class RNN(EdgeSeqModel):
    def make_rep_net(self, generator) -> nn.Module:
        return RNNStack(self.cfg, generator)

    def rep_width(self) -> int:
        return rnn_width(self.cfg)


# =============================================================================
# TransformerXL (reference txl.py:18-383)
# =============================================================================

def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """TXL's relative-position shift (reference txl.py:95-108), the pad-
    and-reshape trick with its wrap: x [B, q, k, n]."""
    b, q, k, n = x.shape
    x = torch.cat([x.new_zeros((b, q, 1, n)), x], 2)
    return x.reshape(b, k + 1, q, n)[:, 1:].reshape(b, q, k, n)


class TXLAttn(nn.Module):
    """Relative multi-head attention (reference txl.py:110-170): no
    attention mask, so the pad tuples of a segment attend and are
    attended to, as in the JAX package."""

    def __init__(self, hid_dim: int, num_heads: int = 4,
                 dropout: float = 0.0, pre_lnorm: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hid, self.num_heads = hid_dim, num_heads
        self.dropout, self.pre_lnorm = dropout, pre_lnorm
        self.layer_norm = LayerNorm(hid_dim)
        init = kaiming_normal(1.0)
        for name in ("q_kernel", "k_kernel", "v_kernel", "r_kernel"):
            setattr(self, name, nn.Parameter(init((hid_dim, hid_dim),
                                                  generator)))
        self.o_net = Dense(hid_dim, hid_dim, init="normal",
                           generator=generator)

    def forward(self, w, r, r_w_bias, r_r_bias, mems=None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        h, nh = self.hid, self.num_heads
        scale = 1.0 / math.sqrt(h / nh)
        bsz, qlen = w.shape[:2]
        original_w = w
        c = w if mems is None else torch.cat([mems, w], 1)
        klen = c.shape[1]
        if self.pre_lnorm:
            w, c = self.layer_norm(w), self.layer_norm(c)
        dt = w.dtype
        q = (w @ self.q_kernel.to(dt)).reshape(bsz, qlen, nh, -1)
        k = (c @ self.k_kernel.to(dt)).reshape(bsz, klen, nh, -1)
        v = (c @ self.v_kernel.to(dt)).reshape(bsz, klen, nh, -1)
        rk = (r @ self.r_kernel.to(dt)).reshape(klen, nh, -1)
        ac = torch.einsum("bind,bjnd->bijn", q + r_w_bias.to(dt), k)
        bd = rel_shift(torch.einsum("bind,jnd->bijn", q + r_r_bias.to(dt),
                                    rk))
        prob = torch.softmax((ac + bd) * scale, dim=2)
        prob = dropout(prob, self.dropout, train, generator)
        vec = torch.einsum("bijn,bjnd->bind", prob, v).reshape(bsz, qlen, h)
        out = dropout(self.o_net(vec), self.dropout, train, generator)
        out = out + original_w
        if not self.pre_lnorm:
            out = self.layer_norm(out)
        return out


class TXLFF(nn.Module):
    """Position-wise feed-forward (reference txl.py:173-209)."""

    def __init__(self, hid_dim: int, act: str = "relu", dropout: float = 0.0,
                 pre_lnorm: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act_fn = map_activation_str_to_fn(act)
        self.dropout, self.pre_lnorm = dropout, pre_lnorm
        self.layer_norm = LayerNorm(hid_dim)
        self.layer1 = Dense(hid_dim, hid_dim, init="normal", activation=act,
                            generator=generator)
        self.layer2 = Dense(hid_dim, hid_dim, init="normal",
                            generator=generator)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        original = x
        if self.pre_lnorm:
            x = self.layer_norm(x)
        o = dropout(self.act_fn(self.layer1(x)), self.dropout, train,
                    generator)
        o = dropout(self.layer2(o), self.dropout, train, generator)
        o = o + original
        if not self.pre_lnorm:
            o = self.layer_norm(o)
        return o


class TXLStack(nn.Module):
    """Segment-recurrent TXL over the padded sequence (reference txl.py:
    212-383): segments of rep_txl_seg_len, the last zero-padded; each
    layer attends over its own segment and the memory of its input's last
    min(mem_len, i * seg_len) positions, which takes no gradient."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        h, nh = cfg.hid_dim, cfg.rep_txl_num_heads
        init = kaiming_normal(1.0)
        self.r_w_bias = nn.Parameter(init((nh, h // nh), generator))
        self.r_r_bias = nn.Parameter(init((nh, h // nh), generator))
        for i in range(cfg.rep_num_graph_layers):
            self.add_module(f"attn_{i}", TXLAttn(
                h, nh, cfg.rep_dropout, cfg.rep_txl_pre_norm, generator))
            self.add_module(f"ff_{i}", TXLFF(
                h, cfg.rep_act_func, cfg.rep_dropout, cfg.rep_txl_pre_norm,
                generator))
        max_klen = cfg.rep_txl_seg_len + cfg.rep_txl_mem_len
        self.register_buffer("pos_table", torch.from_numpy(position_table(
            h, max(cfg.rep_txl_clamp_len, max_klen))), persistent=False)

    def forward(self, emb, mask=None, gate=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        seg_len, mem_len = cfg.rep_txl_seg_len, cfg.rep_txl_mem_len
        clamp = cfg.rep_txl_clamp_len
        b, total = emb.shape[:2]
        g = _gate(mask, gate)
        x = emb if g is None else emb * g
        n_seg = -(-total // seg_len)
        pad = n_seg * seg_len - total
        if pad:
            x = torch.cat([x, x.new_zeros((b, pad, x.shape[2]))], 1)
        # one dropout for the inputs and the position rows (txl.py:554-567)
        x = dropout(x, cfg.rep_dropout, train, generator)
        layers = [(getattr(self, f"attn_{i}"), getattr(self, f"ff_{i}"))
                  for i in range(cfg.rep_num_graph_layers)]

        mems: Optional[List[torch.Tensor]] = None
        outs = []
        for i in range(n_seg):
            seg = x[:, i * seg_len: (i + 1) * seg_len]
            mlen = min(mem_len, i * seg_len)
            klen = mlen + seg_len
            pos_seq = torch.arange(klen - 1, -1, -1, device=x.device)
            if clamp > 0:
                pos_seq = pos_seq.clamp(max=clamp)
            r = dropout(self.pos_table[pos_seq].to(x.dtype), cfg.rep_dropout,
                        train, generator)
            hids = [seg]
            o = seg
            for li, (attn, ff) in enumerate(layers):
                m = None if mems is None or mlen == 0 else mems[li]
                o = attn(o, r, self.r_w_bias, self.r_r_bias, m, train,
                         generator)
                o = ff(o, train, generator)
                hids.append(o)
            outs.append(o)
            # the memories: each layer's input, its last mem_len positions
            # (txl.py:269-288), without gradient
            end = mlen + seg_len
            beg = max(0, end - mem_len)
            mems = [(hid if mems is None or mlen == 0 else
                     torch.cat([mems[li], hid], 1))[:, beg:end].detach()
                    for li, hid in enumerate(hids)]

        out = torch.cat(outs, 1)[:, :total]
        if g is not None:
            # the JAX package masks the graph's output once by the mask
            # (1 without one) and again by the whole gate (edgeseq.py:
            # 588-594)
            out = out * (g if gate is None else
                         (mask if mask is not None else 1.0))
            if gate is not None:
                out = out * g
        return out


class TransformerXL(EdgeSeqModel):
    def make_rep_net(self, generator) -> nn.Module:
        return TXLStack(self.cfg, generator)
