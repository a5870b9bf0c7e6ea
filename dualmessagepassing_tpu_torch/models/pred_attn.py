"""Attention and memory predict nets (dualmessagepassing_tpu/models/
pred_attn.py: DotAttention 40-132, the memory initialisation 138-302,
the Attn nets 306-339, MemDotAttention and the MemAttn nets 346-426,
DIAMNet 433-524).

Reference: SubgraphCountingMatching/models/pred.py:240-1328. Before the
pooling, an Attn net refines the graph's rows infer_steps times with two
attentions, the same two modules every round: p_attn (the graph's rows
query the pattern's) and g_attn (the graph's rows attend to each other).
Both have 4 heads, scale 1/sqrt(hidden / heads), sparsemax scores, an
output gate and the "identity" init (eye plus noise). A MemAttn net's
two attentions first compress their keys and values into mem_len slots
(MemDotAttention); DIAMNet keeps a memory of mem_len slots made from the
graph's rows and predicts from it. The slots pool windows of the
sequence (init_mem_static: mean, sum, max, a window attention or a
window LSTM, each also circular), computed per sample from its true
length over the padded batch, as the JAX package does.

One departure from the JAX package, on purpose: a masked key scores
-1e30, so softmax and sparsemax give it no weight. The JAX package
writes +_INF there (pred_attn.py:95), which gives the pad keys, and in
the window attention the keys outside the slot's window, all the
weight; without such keys the two agree (tests/
test_torch_scm_pred_attn.py, tests/test_torch_scm_pred_mem.py).

Parameters keep the flax names (pred_net_v.p_attn.weight_q, .g_kernel,
.g_bias, .q_layer_norm.scale, .mem_lstm_k.cell.ii.kernel, ...) and the
[in, out] layout, each cast to the input's dtype at use; the scores are
einsums over [B, qlen, klen, heads], as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..constants import _INF
from ..parallel.dist import all_reduce_max
from ..utils.act import map_activation_str_to_fn, sparsemax
from ..utils.init import get_initializer
from .edgeseq import RNNCell, run_cells
from .layers import Dense, LayerNorm, dropout, rounded_params
from .pred import MaxPredictNet, MeanPredictNet, PredictNet, SumPredictNet


def _promote(a: torch.Tensor, b: torch.Tensor):
    """a and b in their common dtype (JAX's promotion of an einsum's
    operands)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x promoted against float32: bf16 to float32, float64 kept."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


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
        masks bool [B, qlen] / [B, klen] -> [B, qlen, qd]; the dropout
        masks drawn from `generator`. Inputs of two dtypes (a memory net's
        float32 slots beside bf16 rows under amp) meet in the wider one,
        as JAX promotes them; each parameter is cast to its input's
        dtype."""
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
        q, k = _promote(query.reshape(bsz, qlen, nh, -1),
                        key.reshape(bsz, klen, nh, -1))
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

        score, v = _promote(score, value.reshape(bsz, vlen, nh, -1))
        vec = torch.einsum("bijn,bjnd->bind", score, v).reshape(bsz, qlen, -1)
        if query_mask is not None:
            vec = vec * query_mask[..., None]
        if h != -1:
            vec = vec @ self.weight_o.to(vec.dtype)
        vec = dropout(vec, self.dropout, train, generator)

        if self.add_gate:
            both = torch.cat([original_query, vec], -1)
            g = torch.sigmoid(both @ self.g_kernel.to(both.dtype)
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


# =============================================================================
# memory initialisation (pred_attn.py:138-302)
# =============================================================================

# the ten mem_init values: a pooling base, each also circular_
MEM_INITS = tuple(p + b for p in ("", "circular_")
                  for b in ("mean", "sum", "max", "attn", "lstm"))


def check_mem_init(mem_init: str) -> None:
    """An unknown mem_init raises at build (pred_attn.py:298)."""
    if mem_init not in MEM_INITS:
        raise NotImplementedError(f"mem_init '{mem_init}'")


def virtual_len(seq_len: int, circular: bool) -> int:
    """The virtual sequence's length at true length seq_len: circular
    pads (l + 2) // 2 - 1 positions, folded back mod l."""
    return seq_len + (seq_len + 2) // 2 - 1 if circular else seq_len


def window_bounds(lengths: torch.Tensor, mem_len: int, circular: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per sample (start [B, M], kernel [B, M]) of each memory slot's
    window in the virtual sequence (pred_attn.py:
    179-196). With lv > mem_len, slot k covers [k * stride, k * stride +
    kernel), stride = lv // M, kernel = lv - (M - 1) * stride; otherwise
    slot k holds position k - (M - lv), and kernel is 0 where that is
    negative (an empty slot)."""
    l = lengths.long()[:, None]
    k_ids = torch.arange(mem_len, device=l.device)[None, :]
    lv = l + ((l + 2) // 2 - 1).clamp(min=0) if circular else l
    stride = (lv // mem_len).clamp(min=1)
    start_b = k_ids - (mem_len - lv)
    regime_a = lv > mem_len
    start = torch.where(regime_a, k_ids * stride, start_b.clamp(min=0))
    kernel = torch.where(regime_a, lv - (mem_len - 1) * stride,
                         (start_b >= 0).long())
    return start, kernel


def fold(virt: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Virtual positions [B, ...] -> real ones, mod each sample's length
    (0 for an empty sample)."""
    l = lengths.long().reshape((-1,) + (1,) * (virt.dim() - 1))
    return torch.where(l > 0, virt % l.clamp(min=1), 0)


def window_selection(lengths: torch.Tensor, seq_len: int, mem_len: int,
                     circular: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per sample the pooling windows' counts (sel [B, M, seq_len]
    float32: how often slot k's window holds real position j) and
    mem_mask [B, M] (the slot's window is not empty), equal to
    pred_attn.py:138-176's. The JAX package sums a [B, M, Lv, L] one-hot;
    here each window position adds 1 at its folded index (scatter_add_
    along L), so nothing larger than [B, M, Lv] is built."""
    start, kernel = window_bounds(lengths, mem_len, circular)
    j = torch.arange(virtual_len(seq_len, circular), device=start.device)
    in_win = (j >= start[..., None]) & (j < (start + kernel)[..., None])
    real = fold(j.expand_as(in_win), lengths)
    sel = torch.zeros(in_win.shape[:2] + (seq_len,),
                      device=in_win.device).scatter_add_(2, real,
                                                          in_win.float())
    return sel, kernel > 0


class WindowLSTMMem(nn.Module):
    """The lstm mem_init (pred_attn.py:199-245): flax's OptimizedLSTMCell
    (`cell`, the parameters of edgeseq.RNNCell) over each slot's window,
    the final hidden state as the slot's value, empty slots zero. The
    windows are gathered by index into B * M sequences of k_max steps
    (seq_len - M + 1, circular the virtual length) and run through
    torch.lstm over all of them; slot k reads the output of step kernel
    - 1, which is flax's carry under seq_lengths. Not packed:
    pack_padded_sequence refuses the empty slots' length 0, so their
    step index is clamped and their rows zeroed (a zero gradient).
    flax's carry is float32, so the recurrence runs in float32 under amp
    too."""

    def __init__(self, in_dim: int, features: int, mem_len: int,
                 circular: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mem_len, self.circular = mem_len, circular
        self.cell = RNNCell("LSTM", in_dim, features, generator)

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, L, D], x_mask bool [B, L] or None -> (mem [B, M,
        features] at least float32, mem_mask [B, M])."""
        b, seq_len, d = x.shape
        m = self.mem_len
        lengths = (torch.full((b,), seq_len, device=x.device)
                   if x_mask is None else x_mask.long().sum(1))
        start, kernel = window_bounds(lengths, m, self.circular)
        k_max = max(virtual_len(seq_len, True) if self.circular
                    else seq_len - m + 1, 1)
        virt = start[..., None] + torch.arange(k_max, device=x.device)
        real = fold(virt, lengths).clamp(max=seq_len - 1)
        rows = real + seq_len * torch.arange(b, device=x.device)[:, None,
                                                                 None]
        win = _wide(x).reshape(b * seq_len, d).index_select(
            0, rows.reshape(-1)).reshape(b * m, k_max, d)
        out = run_cells("LSTM", [self.cell], win)
        last = (kernel.clamp(min=1, max=k_max) - 1).reshape(-1)
        h = out[torch.arange(b * m, device=x.device), last].reshape(b, m, -1)
        mem_mask = kernel > 0
        return torch.where(mem_mask[..., None], h, 0.0), mem_mask


def init_mem_static(x: torch.Tensor, x_mask: Optional[torch.Tensor],
                    mem_len: int, mem_init: str,
                    attn: Optional[DotAttention] = None,
                    lstm: Optional[WindowLSTMMem] = None,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """init_mem (pred_attn.py:248-299) over a padded batch: x [B, L, D],
    x_mask bool [B, L] or None -> (mem [B, M, D'], mem_mask [B, M]).
    mean, sum and attn pool with window_selection's float32 counts, so
    their slots are float32 (JAX promotes a bf16 x there); max stays in
    x's dtype. attn's query is the window's mean; with a DotAttention
    the slots are folded into the batch and each attends over its
    window's keys (a masked key scores -1e30, where the JAX package's
    +1e30 lets a slot read keys outside its window), without one a
    softmax over the window; lstm runs the WindowLSTMMem."""
    check_mem_init(mem_init)
    b, seq_len, d = x.shape
    base = mem_init.split("_")[-1]
    if base == "lstm":
        if lstm is None:
            raise ValueError("lstm mem_init requires a WindowLSTMMem module")
        return lstm(x, x_mask)
    lengths = (torch.full((b,), seq_len, device=x.device)
               if x_mask is None else x_mask.long().sum(1))
    sel, mem_mask = window_selection(lengths, seq_len, mem_len,
                                     mem_init.startswith("circular"))
    if base == "max":
        big = torch.where(sel[..., None] > 0, x[:, None], -_INF)
        return torch.where(mem_mask[..., None], big.amax(2), 0.0), mem_mask
    xf = _wide(x)
    sel = sel.to(xf.dtype)
    mem = torch.einsum("bml,bld->bmd", sel, xf)
    if base == "sum":
        return mem, mem_mask
    mem = mem / sel.sum(-1, keepdim=True).clamp(min=1.0)
    if base == "attn":
        if attn is not None:
            keys = x.repeat_interleave(mem_len, 0)
            mem = attn(mem.reshape(b * mem_len, 1, d), keys, keys, None,
                       (sel > 0).reshape(b * mem_len, seq_len), train,
                       generator).reshape(b, mem_len, -1)
        else:
            score = torch.einsum("bmd,bld->bml", mem, xf) / math.sqrt(d)
            score = torch.softmax(torch.where(sel > 0, score, -_INF), -1)
            mem = torch.einsum("bml,bld->bmd",
                               torch.where(sel > 0, score, 0.0), xf)
        mem = torch.where(mem_mask[..., None], mem, 0.0)
    return mem, mem_mask


class _RoundedUnderAmp(nn.Module):
    """A memory net's call: under amp (rows in bf16) `predict` runs on the
    net's parameters rounded to bf16 (layers.rounded_params), since its
    float32 slots meet them in float32, where JAX's amp computes on the
    rounded values; in float32 (and inside EdgeSeqModel, whose float32
    gates promote the rows and which rounds every parameter itself) on
    the parameters as they are."""

    def forward(self, p_rep: torch.Tensor, p_mask: torch.Tensor,
                g_rep: torch.Tensor, g_mask: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                params_rounded: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if params_rounded or g_rep.dtype not in (torch.bfloat16,
                                                 torch.float16):
            return self.predict(p_rep, p_mask, g_rep, g_mask, train,
                                generator)
        return functional_call(
            self, rounded_params(self, g_rep.dtype),
            (p_rep, p_mask, g_rep, g_mask),
            dict(train=train, generator=generator, params_rounded=True))


# =============================================================================
# MemAttn predict nets (pred_attn.py:346-426)
# =============================================================================

class MemDotAttention(nn.Module):
    """DotAttention over keys and values first compressed into mem_len
    slots (pred_attn.py:346-387): proj_k / proj_v (Dense to mem_dim, the
    identity init), init_mem_static with one inner attention mem_attn
    for both (attn inits) or an LSTM each, mem_lstm_k / mem_lstm_v (lstm
    inits), then `attn` (scale 1, pre-LayerNorm, gate) over the slots."""

    def __init__(self, query_dim: int, key_dim: int, value_dim: int,
                 hidden_dim: int, mem_dim: int, mem_len: int = 4,
                 mem_init: str = "mean", num_heads: int = 1,
                 score_func: str = "sparsemax", add_gate: bool = True,
                 pre_lnorm: bool = True, param_init: str = "identity",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_mem_init(mem_init)
        self.mem_len, self.mem_init = mem_len, mem_init
        self.proj_k = Dense(key_dim, mem_dim, init=param_init,
                            generator=generator)
        self.proj_v = Dense(value_dim, mem_dim, init=param_init,
                            generator=generator)
        self.mem_attn = self.mem_lstm_k = self.mem_lstm_v = None
        if mem_init.endswith("attn"):
            self.mem_attn = DotAttention(
                mem_dim, mem_dim, mem_dim, hidden_dim, num_heads,
                scale=1.0 / math.sqrt(hidden_dim / num_heads),
                score_func=score_func, param_init=param_init,
                generator=generator)
        elif mem_init.endswith("lstm"):
            circ = mem_init.startswith("circular")
            self.mem_lstm_k = WindowLSTMMem(mem_dim, mem_dim, mem_len, circ,
                                            generator)
            self.mem_lstm_v = WindowLSTMMem(mem_dim, mem_dim, mem_len, circ,
                                            generator)
        self.attn = DotAttention(
            query_dim, mem_dim, mem_dim, hidden_dim, num_heads, scale=1.0,
            score_func=score_func, add_gate=add_gate, pre_lnorm=pre_lnorm,
            param_init=param_init, generator=generator)

    def forward(self, query, key, value, query_mask=None, key_mask=None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        mem_k, mem_k_mask = init_mem_static(
            self.proj_k(key), key_mask, self.mem_len, self.mem_init,
            self.mem_attn, self.mem_lstm_k, train, generator)
        mem_v, _ = init_mem_static(
            self.proj_v(value), key_mask, self.mem_len, self.mem_init,
            self.mem_attn, self.mem_lstm_v, train, generator)
        return self.attn(query, mem_k, mem_v, query_mask, mem_k_mask, train,
                         generator)


class BaseMemAttnPredictNet(_RoundedUnderAmp, PredictNet):
    """A PredictNet whose pre_transform refines the graph's rows with two
    MemDotAttentions, p_attn over the pattern's rows and g_attn over the
    graph's own, infer_steps rounds (pred_attn.py:394-414); mem_dim is
    hidden_dim."""

    def __init__(self, rep_dim: int, hidden_dim: int, act: str = "relu",
                 dropout: float = 0.0, return_weights: bool = False,
                 generator: Optional[torch.Generator] = None,
                 p_rep_dim: Optional[int] = None, num_heads: int = 4,
                 infer_steps: int = 1, mem_len: int = 4,
                 mem_init: str = "mean"):
        super().__init__(rep_dim, hidden_dim, act=act, dropout=dropout,
                         return_weights=return_weights, generator=generator,
                         p_rep_dim=p_rep_dim)
        self.infer_steps = infer_steps
        kw = dict(hidden_dim=hidden_dim, mem_dim=hidden_dim, mem_len=mem_len,
                  mem_init=mem_init, num_heads=num_heads, generator=generator)
        p_dim = p_rep_dim or rep_dim
        self.p_attn = MemDotAttention(rep_dim, p_dim, p_dim, **kw)
        self.g_attn = MemDotAttention(rep_dim, rep_dim, rep_dim, **kw)

    pre_transform = BaseAttnPredictNet.pre_transform
    predict = PredictNet.forward


class MeanMemAttnPredictNet(BaseMemAttnPredictNet, MeanPredictNet):
    pass


class SumMemAttnPredictNet(BaseMemAttnPredictNet, SumPredictNet):
    pass


class MaxMemAttnPredictNet(BaseMemAttnPredictNet, MaxPredictNet):
    pass


# =============================================================================
# DIAMNet (pred_attn.py:433-524)
# =============================================================================

class DIAMNet(_RoundedUnderAmp):
    """Dynamic intermedium attention memory network: a memory of mem_len
    slots from the graph's rows (mem_layer: the window attention, the
    window LSTM, or a Dense after the pooling), refined infer_steps
    rounds by p_attn (over the pattern's rows) and g_attn (over the
    graph's); the count from the flattened memory and the lengths, the
    weights (return_weights) from p_fc / g_fc rows that query the memory
    through m_attn. The memory's width is rep_dim under the attn inits
    (DotAttention returns the query's width) and hidden_dim otherwise.
    The lengths stay float32 (pred_attn.py:450-451), so under amp the
    count head and the weight head's sum are float32, as JAX promotes
    them. Called as the other predict nets, -> (count [B, 1], weights
    [B, Lg] or None)."""

    def __init__(self, rep_dim: int, hidden_dim: int, act: str = "relu",
                 dropout: float = 0.0, return_weights: bool = False,
                 generator: Optional[torch.Generator] = None,
                 p_rep_dim: Optional[int] = None, num_heads: int = 4,
                 infer_steps: int = 1, mem_len: int = 4,
                 mem_init: str = "mean"):
        super().__init__()
        check_mem_init(mem_init)
        h = hidden_dim
        self.act_fn = map_activation_str_to_fn(act)
        self.dropout, self.return_weights = dropout, return_weights
        self.infer_steps, self.mem_len, self.mem_init = (infer_steps, mem_len,
                                                         mem_init)
        self.row_world = None      # as PredictNet's
        attn_kw = dict(hidden_dim=h, num_heads=num_heads,
                       scale=1.0 / math.sqrt(h / num_heads),
                       score_func="sparsemax", add_gate=True,
                       param_init="identity", generator=generator)

        def dense(din, dout, init="normal", activation=act):
            return Dense(din, dout, init=init, activation=activation,
                         generator=generator)

        if mem_init.endswith("attn"):
            self.mem_layer = DotAttention(rep_dim, rep_dim, rep_dim,
                                          **attn_kw)
            mem_dim = rep_dim
        elif mem_init.endswith("lstm"):
            self.mem_layer = WindowLSTMMem(
                rep_dim, h, mem_len, mem_init.startswith("circular"),
                generator)
            mem_dim = h
        else:
            self.mem_layer = dense(rep_dim, h, activation="none")
            mem_dim = h
        p_dim = p_rep_dim or rep_dim
        self.p_attn = DotAttention(mem_dim, p_dim, p_dim, **attn_kw)
        self.g_attn = DotAttention(mem_dim, rep_dim, rep_dim, **attn_kw)
        if return_weights:
            self.m_attn = DotAttention(h, mem_dim, mem_dim, **attn_kw)
            self.p_fc = dense(p_dim, h)
            self.g_fc = dense(rep_dim, h)
            self.weight_fc1 = dense(4 * h + 2, h)
            self.weight_fc2 = dense(h + 2, 1, "zero", "none")
        self.pred_fc1 = dense(mem_len * mem_dim + 4, h)
        self.pred_fc2 = dense(h + 4, 1, "zero", "none")

    def predict(self, p_rep, p_mask, g_rep, g_mask, train=False,
                generator=None):
        pl = p_mask.float().sum(1, keepdim=True)          # [B, 1]
        gl = g_mask.float().sum(1, keepdim=True)
        pl_inv, gl_inv = 1.0 / pl, 1.0 / gl
        base = self.mem_init.split("_")[-1]
        m, m_mask = init_mem_static(
            g_rep, g_mask, self.mem_len, self.mem_init,
            self.mem_layer if base == "attn" else None,
            self.mem_layer if base == "lstm" else None, train, generator)
        if base not in ("attn", "lstm"):
            m = self.mem_layer(m)
        for _ in range(self.infer_steps):
            m = self.p_attn(m, p_rep, p_rep, m_mask, p_mask, train,
                            generator)
            m = self.g_attn(m, g_rep, g_rep, m_mask, g_mask, train,
                            generator)

        w = None
        if self.return_weights:
            p = self.m_attn(self.p_fc(p_rep), m, m, p_mask, m_mask, train,
                            generator)
            p = dropout(p, self.dropout, train, generator)
            if base == "max":
                p = torch.where(p_mask[..., None], p, 0.0).amax(1)
            else:
                p = (p * p_mask[..., None]).sum(1)
                if base != "sum":
                    p = p / all_reduce_max(
                        pl.max(), self.row_world).clamp(min=1.0)
            p = p[:, None, :]                              # [B, 1, h]
            g = self.m_attn(self.g_fc(g_rep), m, m, g_mask, m_mask, train,
                            generator)
            g = dropout(g, self.dropout, train, generator)
            pl_e, pli_e = pl[:, :, None], pl_inv[:, :, None]
            w = self.weight_fc1(parts=[p, g, g - p, g * p, pl_e, pli_e])
            w = self.weight_fc2(parts=[self.act_fn(w), pl_e, pli_e])[..., 0]

        lens = [pl, gl, pl_inv, gl_inv]
        y = self.act_fn(self.pred_fc1(torch.cat(
            [m.reshape(m.shape[0], -1)] + lens, 1)))
        return self.pred_fc2(torch.cat([y] + lens, 1)), w


ATTN_PRED_NETS = {
    "MeanAttnPredictNet": MeanAttnPredictNet,
    "SumAttnPredictNet": SumAttnPredictNet,
    "MaxAttnPredictNet": MaxAttnPredictNet,
    "MeanMemAttnPredictNet": MeanMemAttnPredictNet,
    "SumMemAttnPredictNet": SumMemAttnPredictNet,
    "MaxMemAttnPredictNet": MaxMemAttnPredictNet,
    "DIAMNet": DIAMNet,
}
