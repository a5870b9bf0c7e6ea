"""Activation registry (dualmessagepassing_tpu/utils/act.py, all of it).

Plain functions f(x, ...) selected by name with map_activation_str_to_fn,
as the JAX package has them: identity, the jax.nn activations (gelu in
its tanh form, jax.nn.gelu's default), leaky_relu with the reference
slope 1/5.5 (and a "leaky_relu0.1"-style suffix), sparsemax, a
Gumbel-softmax and the hard maximum/minimum one-hots.

Reference: SubgraphCountingMatching/utils/act.py:1-489 (Sparsemax
210-356).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..constants import LEAKY_RELU_A


def identity(x):
    return x


def leaky_relu(x, negative_slope: float = LEAKY_RELU_A):
    return F.leaky_relu(x, negative_slope)


def maximum(x, axis=-1):
    """Hard-max one-hot along axis (reference `Maximum`)."""
    return (x == x.amax(dim=axis, keepdim=True)).to(x.dtype)


def minimum(x, axis=-1):
    return (x == x.amin(dim=axis, keepdim=True)).to(x.dtype)


def sparsemax(x, axis: int = -1):
    """Sparsemax (Martins & Astudillo 2016) through a full sort: support
    size k* = max{k : 1 + k z_(k) > cumsum(z)_k}, threshold tau =
    (cumsum_{k*} - 1) / k*, output max(z - tau, 0). tau carries no
    gradient, as in the JAX package (its sort runs on stop_gradient)."""
    x = x.transpose(axis, -1)
    n = x.shape[-1]
    z = x - x.amax(dim=-1, keepdim=True).detach()
    z_sorted = torch.sort(z.detach(), dim=-1, descending=True).values
    cumsum = torch.cumsum(z_sorted, dim=-1)
    k = torch.arange(1, n + 1, dtype=x.dtype, device=x.device)
    support = 1.0 + k * z_sorted > cumsum
    k_star = support.sum(dim=-1, keepdim=True).to(x.dtype)
    cumsum_k = torch.gather(
        cumsum, -1, (k_star.long() - 1).clamp(min=0))
    tau = (cumsum_k - 1.0) / k_star.clamp(min=1.0)
    return torch.clamp(z - tau, min=0.0).transpose(axis, -1)


def gumbel_softmax(x, axis: int = -1, tau: float = 1.0,
                   rng: Optional[torch.Generator] = None):
    """Gumbel-softmax sample (soft), the noise drawn from the generator
    `rng`; a plain softmax when rng is None."""
    if rng is not None:
        u = torch.rand(x.shape, generator=rng, device=x.device,
                       dtype=x.dtype)
        x = x - torch.log(-torch.log(u + 1e-20) + 1e-20)
    return torch.softmax(x / tau, dim=axis)


def _softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


_ACTS = {
    "none": identity,
    "identity": identity,
    "relu": F.relu,
    "relu6": F.relu6,
    "elu": F.elu,
    "selu": F.selu,
    "celu": F.celu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "leaky_relu": leaky_relu,
    "prelu": leaky_relu,  # PReLU init slope == LEAKY_RELU_A in the reference
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": _softmax,
    "sparsemax": sparsemax,
    "gumbel_softmax": gumbel_softmax,
    "maximum": maximum,
    "minimum": minimum,
}


def supported_act_funcs():
    return sorted(_ACTS)


def map_activation_str_to_fn(act: str) -> Callable:
    """Activation by name, with `leaky_relu0.1`-style slope suffixes."""
    if act in _ACTS:
        return _ACTS[act]
    if act.startswith("leaky_relu"):
        slope = float(act[len("leaky_relu"):])
        return functools.partial(leaky_relu, negative_slope=slope)
    raise NotImplementedError(f"activation '{act}' is not supported")
