"""Weights made by the benchmark from the seed, on the device, in one
draw, and handed alike to the program and to the plain reference.

A reference declares its parameters and buffers as a spec: name ->
(shape, kind). The names are sorted, one uniform draw of their total
size is made by a torch.Generator on the device seeded with the seed,
and each leaf takes its slice, scaled by its kind:

  "fan"    U(-b, b), b = sqrt(6 / (fan_in + fan_out)) over the last two
           dims (a [in, out] kernel or a [rows, width] table);
  "vector" U(-0.1, 0.1)                (biases);
  "scale"  1 + U(-0.1, 0.1)            (BatchNorm weights);
  "mean"   U(-0.1, 0.1)                (running means);
  "var"    1 + U(-0.5, 0.5)            (running variances).

Every leaf is non-zero, so every leaf takes a gradient in the first
step (a zero-initialised head would hide the layers under it).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Spec = Dict[str, Tuple[Tuple[int, ...], str]]


def torch_seed(seed: int) -> int:
    return int(seed) % (2 ** 63)


def make_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    names = sorted(spec)
    sizes = [math.prod(spec[n][0]) for n in names]
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for name, part in zip(names, flat.split(sizes)):
        shape, kind = spec[name]
        if kind == "fan":
            bound = math.sqrt(6.0 / (shape[-2] + shape[-1]))
            leaf = part * bound
        elif kind in ("vector", "mean"):
            leaf = part * 0.1
        elif kind == "scale":
            leaf = 1.0 + part * 0.1
        elif kind == "var":
            leaf = 1.0 + part * 0.5
        else:
            raise ValueError(f"{name}: unknown weight kind {kind!r}")
        out[name] = leaf.reshape(shape).contiguous()
    return out
