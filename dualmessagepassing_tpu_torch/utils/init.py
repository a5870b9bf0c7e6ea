"""Weight initializers drawing from an explicit torch.Generator
(dualmessagepassing_tpu/utils/init.py; the SCM embeddings' inits,
models/embed.py:129-148).

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

from ..constants import LEAKY_RELU_A

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


def calculate_gain(activation: str) -> float:
    """torch.nn.init.calculate_gain with the reference's LeakyReLU slope
    (init.py:17-49)."""
    if activation in ("none", "identity", "maximum", "minimum", "linear"):
        return 1.0
    if activation in ("relu", "relu6", "elu", "selu", "celu", "gelu"):
        return math.sqrt(2.0)
    if activation in ("leaky_relu", "prelu") or activation.startswith(
            "leaky_relu"):
        return math.sqrt(2.0 / (1.0 + LEAKY_RELU_A ** 2))
    if activation in ("softmax", "sparsemax", "gumbel_softmax", "sigmoid"):
        return 1.0
    if activation == "tanh":
        return 5.0 / 3.0
    raise NotImplementedError(f"no gain rule for activation '{activation}'")


def _normal(shape, generator) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float32)


def kaiming_normal(gain: float = 1.0, fan_axis: int = 0) -> Init:
    """N(0, gain / sqrt(fan_in)), fan_in = shape[fan_axis]."""

    def init(shape, generator):
        return gain / math.sqrt(shape[fan_axis]) * _normal(shape, generator)

    return init


def zeros_init() -> Init:
    return lambda shape, generator: torch.zeros(tuple(shape))


def orthogonal() -> Init:
    """A 2D matrix with orthonormal rows or columns, as
    jax.nn.initializers.orthogonal draws it: QR of a normal matrix, Q's
    columns signed by diag(R)."""

    def init(shape, generator):
        rows, cols = shape
        a = _normal((max(rows, cols), min(rows, cols)), generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        return q if rows >= cols else q.T.contiguous()

    return init


def equivariant(gain: float = 1.0) -> Init:
    """Circulant: row i = roll(row 0, i), row 0 ~ kaiming-normal."""

    def init(shape, generator):
        n, d = shape
        row = kaiming_normal(gain)((d,), generator)
        idx = (torch.arange(d)[None, :] - torch.arange(n)[:, None]) % d
        return row[idx]

    return init


def identity_init(gain: float = 1.0) -> Init:
    def init(shape, generator):
        fan_in, fan_out = _fans(shape)
        std = gain * (2.0 / float(fan_in + fan_out))
        eye = torch.eye(shape[-2], shape[-1]).expand(tuple(shape))
        return eye + std ** 2 * _normal(shape, generator)

    return init


def get_initializer(init: str, activation: str = "none") -> Init:
    """Init by name (init_weight, init.py:125-143)."""
    gain = calculate_gain(activation)
    if init == "zero":
        return zeros_init()
    if init == "identity":
        return identity_init(gain)
    if init == "uniform":
        return xavier_uniform(gain)
    if init == "normal":
        return kaiming_normal(gain)
    if init == "orthogonal":
        return orthogonal()
    if init == "equivariant":
        return equivariant(gain)
    raise ValueError(f"init='{init}' is not supported")
