"""Shared building blocks (dualmessagepassing_tpu/models/layers.py):
the init-by-name Dense (21-65), MaskedBatchNorm (68-124), the update
MLP of the GNN layers (127-150), flax's Dropout and LayerNorm, and the
rematerialisation of a rep-net layer (flax's nn.remat).

Parameters keep flax's names and JAX's [in, out] kernel layout (x @ W),
so a flax tree copies across (models/scm_models.params_from_flax). Each
parameter is float32 and is cast to the input's dtype at use, which is
the JAX package's amp: float32 master parameters, bf16 compute.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..parallel.dist import all_reduce_sum
from ..utils.act import map_activation_str_to_fn
from ..utils.init import get_initializer


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax nn.Dropout: in train mode keep each element with probability
    1 - rate and scale it by 1 / (1 - rate); identity otherwise. The
    mask is drawn from `generator` (on x's device)."""
    if not train or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def rounded_params(module: nn.Module, dtype: torch.dtype
                   ) -> Dict[str, torch.Tensor]:
    """The module's parameters rounded to `dtype` and back to float32,
    by name, for torch.func.functional_call: JAX's amp casts every
    parameter to bf16 (cast_floats), so where a float32 input meets a
    parameter, JAX computes in float32 on the rounded value. The
    rounding passes the gradient, rounded to `dtype`, to the float32
    masters. All parameters go through one buffer: one cast each way."""
    names, params = zip(*module.named_parameters())
    flat = torch.cat([p.reshape(-1) for p in params]).to(dtype).float()
    return {k: v.view_as(p) for k, p, v in zip(
        names, params, flat.split([p.numel() for p in params]))}


class Dense(nn.Module):
    """x @ kernel + bias, kernel [in_dim, features] drawn by init name
    (utils/init.get_initializer); `activation` picks only the init gain
    and applies nothing. forward(parts=[...]) is the concat-free form:
    concat(parts, -1) @ kernel == sum_i parts[i] @ kernel[rows of part
    i], the kernel's rows in parts order, each part broadcasting against
    the others (a per-graph [B, 1, h] row beside [B, L, h] streams).
    Each part meets the kernel in its own dtype and the sum promotes, as
    in JAX (DIAMNet's float32 lengths beside bf16 rows under amp)."""

    def __init__(self, in_dim: int, features: int, use_bias: bool = True,
                 init: str = "uniform", activation: str = "none",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(
            get_initializer(init, activation)((in_dim, features), generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: Optional[torch.Tensor] = None,
                parts: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        if parts is None:
            dt = x.dtype
            y = x @ self.kernel.to(dt)
        else:
            dt = parts[0].dtype
            w = self.kernel
            if sum(p.shape[-1] for p in parts) != w.shape[0]:
                raise ValueError("parts do not add up to the kernel's rows")
            y, off = None, 0
            for p in parts:
                k = p.shape[-1]
                term = p @ w[off: off + k].to(p.dtype)
                y = term if y is None else y + term
                off += k
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the element axis using only mask-valid rows.

    The reference applies nn.BatchNorm1d to unpadded node/edge tables;
    here tables are padded, so mean and variance run over masked rows.
    `momentum` follows torch's convention (0.1, which is flax's 0.9 in the
    JAX package), and the running variance is unbiased, as torch keeps it.
    Statistics are always computed in float32 (a bf16 input cannot count
    above 256 rows exactly); the normalisation runs in the input's dtype
    as (x - mean) * rsqrt(var + eps), like the JAX package. The `train`
    argument, not nn.Module.training, selects batch statistics, and in
    train mode the running buffers are updated in place (unless
    update_stats is False: a rematerialised layer's recomputation).

    row_world (parallel/dist.split_rows sets it) is the counterpart of
    the JAX layer's axis_name: the ranks that hold the other rows. The
    count and the sum are then summed over them, and after them the
    centred sum of squares (two passes, as the JAX layer), so the batch
    statistics and the running ones are those of all the rows. Rows that
    every rank holds alike give the same statistics either way, but for
    the unbiased running variance's count, which the JAX layer also
    takes over the ranks.
    """

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.row_world = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        """x [N, F]; mask [N] bool marks the rows the statistics use."""
        dt = x.dtype
        if train:
            xf = x.float()
            m = mask.float()[:, None]
            world = self.row_world
            if world is None:
                cnt = torch.clamp(m.sum(), min=1.0)
                mean = (xf * m).sum(0) / cnt
                var = (((xf - mean) ** 2) * m).sum(0) / cnt
            else:
                sums = all_reduce_sum(
                    torch.cat([(xf * m).sum(0), m.sum()[None]]), world)
                cnt = torch.clamp(sums[-1], min=1.0)
                mean = sums[:-1] / cnt
                var = all_reduce_sum((((xf - mean) ** 2) * m).sum(0),
                                     world) / cnt
        if train and update_stats:
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                keep = 1.0 - self.momentum
                self.running_mean.copy_(
                    keep * self.running_mean + self.momentum * mean)
                self.running_var.copy_(
                    keep * self.running_var + self.momentum * unbiased)
        if not train:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.to(dt)) * torch.rsqrt(var + self.eps).to(dt)
        return y * self.weight.to(dt) + self.bias.to(dt)


class UpdateMLP(nn.Module):
    """num_layers Dense layers fc0, fc1, ... with [BN]-act between them
    and none after the last (the DMPLayer's nmlp/emlp, reference
    dmpnn.py:45-60). forward takes x [..., F] and, for the BatchNorm, a
    mask of x's leading shape."""

    def __init__(self, in_dim: int, features: int, num_layers: int = 2,
                 batch_norm: bool = False, act: str = "relu",
                 init: str = "uniform",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        self.act_fn = map_activation_str_to_fn(act)
        for i in range(num_layers):
            self.add_module(f"fc{i}", Dense(
                in_dim if i == 0 else features, features, init=init,
                activation=act, generator=generator))
            if batch_norm and i != num_layers - 1:
                self.add_module(f"bn{i}", MaskedBatchNorm(features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
            if i != self.num_layers - 1:
                bn = getattr(self, f"bn{i}", None)
                if bn is not None:
                    lead = x.shape[:-1]
                    m = (torch.ones(lead, dtype=torch.bool, device=x.device)
                         if mask is None else mask)
                    x = bn(x.reshape(-1, x.shape[-1]), m.reshape(-1),
                           train, update_stats).reshape(x.shape)
                x = self.act_fn(x)
        return x


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis: epsilon 1e-6, statistics in
    float32 (float64 for a float64 input), parameters "scale" and
    "bias"."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.to(dt), x.shape[-1:], self.scale.to(dt),
                         self.bias.to(dt), self.eps)
        return y.to(x.dtype)


def remat(layer: nn.Module, *args,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """layer(*args, generator=generator, update_stats=...) recomputed in
    the backward (torch.utils.checkpoint, non-reentrant), as the JAX
    package's nn.remat, with dropout and BatchNorm: the recomputation
    computes what the forward computed.

      * It runs on the parameter tensors of the forward (under amp the
        rounded ones, which EdgeSeqModel.forward puts in place only while
        it runs).
      * It does not update the running BatchNorm statistics a second time
        (update_stats=False).
      * Its dropout masks are the forward's: it draws from a replay
        generator, a new one on `generator`'s device in the state
        `generator` had just before the forward. The live generator is
        never rewound, so it ends the step where the plain run ends it.
        Without a generator the masks come from the global RNG, whose
        state checkpoint itself preserves.
    """
    params = dict(layer.named_parameters())
    state = None if generator is None else generator.get_state()
    first = [True]

    def run(*args):
        gen = generator
        if not first[0] and generator is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(state)
        update, first[0] = first[0], False
        return functional_call(layer, params, args,
                               {"generator": gen, "update_stats": update})

    return checkpoint(run, *args, use_reentrant=False)
