"""Prediction (readout) networks (dualmessagepassing_tpu/models/pred.py:
PredictNet 37-113, Sum/Mean/MaxPredictNet 116-128, build_pred_net 138).

Reference: SubgraphCountingMatching/models/pred.py:17-237. Count head
(pred.py:140-156):

    y = fc2(act(fc1([p, g, g-p, g*p, pl, gl, 1/pl, 1/gl])) ++ [pl, gl, 1/pl, 1/gl])

weight head per graph element (pred.py:114-136):

    w = fc2(act(fc1([p, g_j, g_j-p, g_j*p, pl, 1/pl])) ++ [pl, 1/pl])

written concat-free (Dense parts=), so the [B, L, 4h+2] input never
exists; the parameters are those of the concatenation. The true lengths
pl, gl are summed in float32 and then cast to the compute dtype (bf16
cannot count above 256). Pooling: sum (masked), mean (sum over the
batch's largest true length, the reference's padded length) or max
(padding at 0). Under data parallelism (parallel/dist.split_rows) the
largest true length is the whole batch's, as under the JAX package's
sharding. The attention and memory variants (models/pred_attn.py)
transform the graph's rows first (pre_transform); DIAMNet, also there,
is a predict net of its own with the same call.
"""

from __future__ import annotations

import inspect
from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel.dist import all_reduce_max
from ..utils.act import map_activation_str_to_fn
from .layers import Dense, dropout


class PredictNet(nn.Module):
    """Base predict net; subclasses define `agg` (the pooling)."""

    def __init__(self, rep_dim: int, hidden_dim: int, act: str = "relu",
                 dropout: float = 0.0, return_weights: bool = False,
                 generator: Optional[torch.Generator] = None,
                 p_rep_dim: Optional[int] = None):
        super().__init__()
        h = hidden_dim
        self.act_fn = map_activation_str_to_fn(act)
        self.dropout = dropout
        self.return_weights = return_weights
        # the ranks holding the batch's other rows (parallel/dist.py)
        self.row_world = None

        def dense(din, dout, init="normal"):
            return Dense(din, dout, init=init, activation=act,
                         generator=generator)

        # flax sizes p_fc from the pattern's rep, which may be narrower
        # than the graph's (EdgeSeqModel with an encoder of its own)
        self.p_fc = dense(p_rep_dim or rep_dim, h)
        self.g_fc = dense(rep_dim, h)
        if return_weights:
            self.weight_fc1 = dense(4 * h + 2, h)
            self.weight_fc2 = dense(h + 2, 1, "zero")
        self.pred_fc1 = dense(4 * h + 4, h)
        self.pred_fc2 = dense(h + 4, 1, "zero")

    def agg(self, rep, mask, max_len):
        raise NotImplementedError

    def pre_transform(self, p_rep, p_mask, g_rep, g_mask, train=False,
                      generator=None):
        """The attention variants' hook: g_rep before the pooling
        (pred.py:48-51). Here the identity."""
        return g_rep

    def forward(self, p_rep: torch.Tensor, p_mask: torch.Tensor,
                g_rep: torch.Tensor, g_mask: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """p_rep [B, Lp, D] (or a pooled [B, h]), g_rep [B, Lg, D], masks
        bool -> (count [B, 1], weights [B, Lg] or None) in g_rep's dtype."""
        g_rep = self.pre_transform(p_rep, p_mask, g_rep, g_mask, train,
                                   generator)
        dt = g_rep.dtype
        pl = p_mask.float().sum(1, keepdim=True).to(dt)      # [B, 1]
        gl = g_mask.float().sum(1, keepdim=True).to(dt)
        pl_inv, gl_inv = 1.0 / pl, 1.0 / gl
        p_max_len, g_max_len = pl.max(), gl.max()
        if self.row_world is not None:
            p_max_len, g_max_len = all_reduce_max(
                torch.stack([p_max_len, g_max_len]), self.row_world)

        if p_rep.dim() == 2:
            p = p_rep
        else:
            p = dropout(self.p_fc(p_rep), self.dropout, train, generator)
            p = self.agg(p, p_mask, p_max_len)
        g_el = dropout(self.g_fc(g_rep), self.dropout, train, generator)

        w = None
        if self.return_weights:
            pe = p[:, None, :]                 # [B, 1, h]
            pl_e, pli_e = pl[:, :, None], pl_inv[:, :, None]
            w = self.weight_fc1(
                parts=[pe, g_el, g_el - pe, g_el * pe, pl_e, pli_e])
            w = self.weight_fc2(parts=[self.act_fn(w), pl_e, pli_e])[..., 0]

        g = self.agg(g_el, g_mask, g_max_len)
        y = self.pred_fc1(torch.cat(
            [p, g, g - p, g * p, pl, gl, pl_inv, gl_inv], dim=1))
        y = self.pred_fc2(torch.cat(
            [self.act_fn(y), pl, gl, pl_inv, gl_inv], dim=1))
        return y, w


class SumPredictNet(PredictNet):
    def agg(self, rep, mask, max_len):
        return (rep * mask[..., None]).sum(1)


class MeanPredictNet(PredictNet):
    def agg(self, rep, mask, max_len):
        return (rep * mask[..., None]).sum(1) / torch.clamp(max_len, min=1.0)


class MaxPredictNet(PredictNet):
    def agg(self, rep, mask, max_len):
        return torch.where(mask[..., None], rep, 0.0).amax(1)


PRED_NETS = {
    "SumPredictNet": SumPredictNet,
    "MeanPredictNet": MeanPredictNet,
    "MaxPredictNet": MaxPredictNet,
}


def build_pred_net(name: str, rep_dim: int, hidden_dim: int, act: str,
                   dropout: float, return_weights: bool,
                   generator: Optional[torch.Generator] = None,
                   p_rep_dim: Optional[int] = None, infer_steps: int = 1,
                   num_heads: int = 4, mem_len: int = 4,
                   mem_init: str = "mean") -> nn.Module:
    """create_pred_net (basemodel.py:1074-1366): the pooling nets, and
    the attention and memory nets (models/pred_attn.py), each given the
    options of infer_steps, num_heads, mem_len and mem_init its
    constructor takes (the JAX package's field filter, pred.py:138-162).
    p_rep_dim is the pattern rep's width where it is not rep_dim."""
    from .pred_attn import ATTN_PRED_NETS   # it subclasses the nets here

    kw = dict(act=act, dropout=dropout, return_weights=return_weights,
              generator=generator, p_rep_dim=p_rep_dim)
    if name in PRED_NETS:
        return PRED_NETS[name](rep_dim, hidden_dim, **kw)
    if name not in ATTN_PRED_NETS:
        raise ValueError(f"unknown pred_net '{name}'")
    cls = ATTN_PRED_NETS[name]
    takes = inspect.signature(cls).parameters
    extra = dict(infer_steps=infer_steps, num_heads=num_heads,
                 mem_len=mem_len, mem_init=mem_init)
    return cls(rep_dim, hidden_dim, **kw,
               **{k: v for k, v in extra.items() if k in takes})
