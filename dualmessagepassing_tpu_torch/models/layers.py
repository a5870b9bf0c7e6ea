"""Masked BatchNorm (dualmessagepassing_tpu/models/layers.py:68-124)."""

from __future__ import annotations

import torch
from torch import nn


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
    train mode the running buffers are updated in place.
    """

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """x [N, F]; mask [N] bool marks the rows the statistics use."""
        dt = x.dtype
        if train:
            xf = x.float()
            m = mask.float()[:, None]
            cnt = torch.clamp(m.sum(), min=1.0)
            mean = (xf * m).sum(0) / cnt
            var = (((xf - mean) ** 2) * m).sum(0) / cnt
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                keep = 1.0 - self.momentum
                self.running_mean.copy_(
                    keep * self.running_mean + self.momentum * mean)
                self.running_var.copy_(
                    keep * self.running_var + self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.to(dt)) * torch.rsqrt(var + self.eps).to(dt)
        return y * self.weight.to(dt) + self.bias.to(dt)
