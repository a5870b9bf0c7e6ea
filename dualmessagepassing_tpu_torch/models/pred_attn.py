"""Attention predict nets (dualmessagepassing_tpu/models/pred_attn.py:
DotAttention 40-132, BaseAttnPredictNet and the Mean/Sum/Max Attn nets
306-339).

Reference: SubgraphCountingMatching/models/pred.py:240-641. Before the
pooling, an Attn net refines the graph's rows infer_steps times with two
attentions, the same two modules every round: p_attn (the graph's rows
query the pattern's) and g_attn (the graph's rows attend to each other).
Both have 4 heads, scale 1/sqrt(hidden / heads), sparsemax scores, an
output gate and the "identity" init (eye plus noise).

One departure from the JAX package, on purpose: a masked key scores
-1e30, so softmax and sparsemax give it no weight. The JAX package
writes +_INF there (pred_attn.py:95), which gives the pad keys all the
weight; on a batch without pad keys the two agree (tests/
test_torch_scm_pred_attn.py). The memory nets (MemAttn, DIAMNet) are not
ported.

Parameters keep the flax names (pred_net_v.p_attn.weight_q, .g_kernel,
.g_bias, .q_layer_norm.scale, ...) and the [in, out] layout, each cast
to the input's dtype at use; the scores are einsums over [B, qlen, klen,
heads], as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..constants import _INF
from ..utils.act import map_activation_str_to_fn, sparsemax
from ..utils.init import get_initializer
from .layers import LayerNorm, dropout
from .pred import MaxPredictNet, MeanPredictNet, PredictNet, SumPredictNet


class DotAttention(nn.Module):
    """Multi-head dot attention with softmax, sparsemax or an activation
    as scores, and an optional output gate, residual and LayerNorms
    (pred_attn.py:40-132). query_dim, key_dim and value_dim are the
    inputs' widths; hidden_dim -1 projects nothing (the inputs split into
    heads as they are)."""

    def __init__(self, query_dim: int, key_dim: int, value_dim: int,
                 hidden_dim: int, num_heads: int = 1, scale: float = 1.0,
                 score_func: str = "softmax", add_zero_attn: bool = False,
                 add_gate: bool = False, add_residual: bool = False,
                 pre_lnorm: bool = False, post_lnorm: bool = False,
                 dropout: float = 0.0, param_init: str = "normal",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim, self.num_heads, self.scale = (hidden_dim, num_heads,
                                                       scale)
        self.score_func = score_func
        self.add_zero_attn, self.add_gate = add_zero_attn, add_gate
        self.add_residual, self.dropout = add_residual, dropout
        init = get_initializer(param_init)
        qd, h = query_dim, hidden_dim
        self.pre_lnorm = pre_lnorm
        if pre_lnorm:
            self.q_layer_norm = LayerNorm(qd)
            self.k_layer_norm = LayerNorm(key_dim)
            self.v_layer_norm = LayerNorm(value_dim)
        if h != -1:
            for name, shape in (("weight_q", (qd, h)),
                                ("weight_k", (key_dim, h)),
                                ("weight_v", (value_dim, h)),
                                ("weight_o", (h, qd))):
                setattr(self, name, nn.Parameter(init(shape, generator)))
        if add_gate:
            self.g_kernel = nn.Parameter(init((2 * qd, qd), generator))
            self.g_bias = nn.Parameter(torch.ones(qd))
        self.o_layer_norm = LayerNorm(qd) if post_lnorm else None

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                query_mask: Optional[torch.Tensor] = None,
                key_mask: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """query [B, qlen, qd], key [B, klen, kd], value [B, klen, vd],
        masks bool [B, qlen] / [B, klen] -> [B, qlen, qd] in query's
        dtype; the dropout masks drawn from `generator`."""
        bsz, qlen = query.shape[:2]
        dt = query.dtype
        nh, h = self.num_heads, self.hidden_dim
        original_query = query
        if self.add_zero_attn:
            key = torch.cat([key, key.new_zeros((bsz, 1, key.shape[2]))], 1)
            value = torch.cat(
                [value, value.new_zeros((bsz, 1, value.shape[2]))], 1)
            if key_mask is not None:
                key_mask = torch.cat(
                    [key_mask, key_mask.new_ones((bsz, 1))], 1)
        if self.pre_lnorm:
            query = self.q_layer_norm(query)
            key = self.k_layer_norm(key)
            value = self.v_layer_norm(value)
        klen, vlen = key.shape[1], value.shape[1]
        if h != -1:
            query = query @ self.weight_q.to(dt)
            key = key @ self.weight_k.to(key.dtype)
            value = value @ self.weight_v.to(value.dtype)
        q = query.reshape(bsz, qlen, nh, -1)
        k = key.reshape(bsz, klen, nh, -1)
        score = torch.einsum("bind,bjnd->bijn", q, k) * self.scale
        if key_mask is not None:
            score = torch.where(key_mask[:, None, :, None], score, -_INF)
        if self.score_func == "sparsemax":
            score = sparsemax(score, axis=2)
        elif self.score_func == "softmax":
            score = torch.softmax(score, dim=2)
        else:
            score = map_activation_str_to_fn(self.score_func)(score)
        score = dropout(score, self.dropout, train, generator)

        v = value.reshape(bsz, vlen, nh, -1)
        vec = torch.einsum("bijn,bjnd->bind", score, v).reshape(bsz, qlen, -1)
        if query_mask is not None:
            vec = vec * query_mask[..., None]
        if h != -1:
            vec = vec @ self.weight_o.to(vec.dtype)
        vec = dropout(vec, self.dropout, train, generator)

        if self.add_gate:
            g = torch.sigmoid(
                torch.cat([original_query, vec], -1) @ self.g_kernel.to(dt)
                + self.g_bias.to(dt))
            out = g * original_query + (1 - g) * vec
        else:
            out = vec
        if self.add_residual:
            out = original_query + out
        if self.o_layer_norm is not None:
            out = self.o_layer_norm(out)
        return out


class BaseAttnPredictNet(PredictNet):
    """A PredictNet whose pre_transform refines the graph's rows with
    p_attn and g_attn, infer_steps rounds of the same two modules
    (pred_attn.py:306-328)."""

    def __init__(self, rep_dim: int, hidden_dim: int, act: str = "relu",
                 dropout: float = 0.0, return_weights: bool = False,
                 generator: Optional[torch.Generator] = None,
                 p_rep_dim: Optional[int] = None, num_heads: int = 4,
                 infer_steps: int = 1):
        super().__init__(rep_dim, hidden_dim, act=act, dropout=dropout,
                         return_weights=return_weights, generator=generator,
                         p_rep_dim=p_rep_dim)
        self.infer_steps = infer_steps
        kw = dict(hidden_dim=hidden_dim, num_heads=num_heads,
                  scale=1.0 / math.sqrt(hidden_dim / num_heads),
                  score_func="sparsemax", add_gate=True,
                  param_init="identity", generator=generator)
        p_dim = p_rep_dim or rep_dim
        self.p_attn = DotAttention(rep_dim, p_dim, p_dim, **kw)
        self.g_attn = DotAttention(rep_dim, rep_dim, rep_dim, **kw)

    def pre_transform(self, p_rep, p_mask, g_rep, g_mask, train=False,
                      generator=None):
        g = g_rep
        for _ in range(self.infer_steps):
            g = self.p_attn(g, p_rep, p_rep, g_mask, p_mask, train,
                            generator)
            g = self.g_attn(g, g, g, g_mask, g_mask, train, generator)
        return g


class MeanAttnPredictNet(BaseAttnPredictNet, MeanPredictNet):
    pass


class SumAttnPredictNet(BaseAttnPredictNet, SumPredictNet):
    pass


class MaxAttnPredictNet(BaseAttnPredictNet, MaxPredictNet):
    pass


ATTN_PRED_NETS = {
    "MeanAttnPredictNet": MeanAttnPredictNet,
    "SumAttnPredictNet": SumAttnPredictNet,
    "MaxAttnPredictNet": MaxAttnPredictNet,
}
