"""Weight initializers drawing from an explicit torch.Generator
(dualmessagepassing_tpu/utils/init.py).

Kernels keep JAX's ``[in, out]`` layout and are used as ``x @ W``. Each
factory returns ``init(shape, generator) -> float32 tensor``. The
distributions equal the JAX package's; the numbers do not (torch and
jax.random draw different streams), so parity tests copy weights across
with unc.model.params_from_flax instead of re-drawing them.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Init = Callable[[Sequence[int], torch.Generator], torch.Tensor]


def _uniform(shape, generator, low: float, high: float) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return u * (high - low) + low


def _fans(shape):
    """(fan_in, fan_out) as the JAX package counts them: the last two
    axes, each times the product of the leading (receptive) axes."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def xavier_uniform(gain: float = 1.0) -> Init:
    """U(-a, a), a = sqrt(3) * gain * sqrt(2 / (fan_in + fan_out))."""

    def init(shape, generator):
        fan_in, fan_out = _fans(shape)
        a = math.sqrt(3.0) * gain * math.sqrt(2.0 / float(fan_in + fan_out))
        return _uniform(shape, generator, -a, a)

    return init


def scaled(initializer: Init, scale: float) -> Init:
    """Multiply an initializer's samples by `scale` (the DMPLayer
    eigenvalue reparameterization, dmpnn.py:79-86)."""

    def init(shape, generator):
        return initializer(shape, generator) * scale

    return init


def embedding_uniform(h_dim: int) -> Init:
    """U(-1, 1) / sqrt(h_dim): the learned node and relation embeddings
    (unc/model.py:979-991)."""

    def init(shape, generator):
        return _uniform(shape, generator, -1.0, 1.0) / math.sqrt(float(h_dim))

    return init
