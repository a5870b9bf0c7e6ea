"""Frozen encoders and trainable embeddings of the SCM models
(dualmessagepassing_tpu/models/embed.py: _apply_table 27-72,
MultihotEncoder 75, PositionEncoder 92, Embedding 107-153).

Reference: SubgraphCountingMatching/models/embed.py:105-222. Each table
takes integer ids (a row lookup) or float rows of its width (a matmul
with the table), the dual calling convention of the reference
Embedding.forward (embed.py:109-118). The JAX package looks ids up as a
one-hot matmul, a TPU workaround for slow narrow gathers; here a row
lookup, with the ids clamped into the table as XLA's gather clamps.
The frozen tables are non-persistent buffers (no parameters, nothing in
the state_dict), cast to the compute dtype the caller names.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.encoding import get_enc_len, multihot_table, position_table
from ..utils.init import get_initializer


def apply_table(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Integer ids -> table rows (ids clamped into [0, rows)); float
    [..., rows] -> x @ table in x's dtype."""
    if not x.is_floating_point():
        return table[x.clamp(0, table.shape[0] - 1)]
    if x.shape[-1] != table.shape[0]:
        raise ValueError(f"embedding input last dim {x.shape[-1]} != "
                         f"num_embeddings {table.shape[0]}")
    return x @ table.to(x.dtype)


class MultihotEncoder(nn.Module):
    """Frozen multi-hot base-`base` digit encoding (embed.py:197-208)."""

    def __init__(self, max_n: int, base: int = 2):
        super().__init__()
        self.features = get_enc_len(max_n - 1, base) * base
        self.register_buffer("table", torch.from_numpy(
            multihot_table(max_n, base)), persistent=False)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return apply_table(self.table.to(dtype), x)


class PositionEncoder(nn.Module):
    """Frozen sinusoidal position encoding (embed.py:211-222)."""

    def __init__(self, features: int, max_len: int = 512,
                 scale: float = 1.0):
        super().__init__()
        self.features = features
        self.register_buffer("table", torch.from_numpy(
            position_table(features, max_len, scale)), persistent=False)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return apply_table(self.table.to(dtype), x)


class Embedding(nn.Module):
    """Trainable [num_embeddings, features] table, init by name
    (embed.py:124-194): "normal" N(0, 1), "uniform" U(-1, 1),
    "orthogonal" orthogonal rows, "equivariant" circulant (row i =
    roll(row 0, i), row 0 ~ N(0, 1), then trained as a dense matrix);
    `scale` multiplies the drawn weight once (GraphAdjModelV2's
    1/enc_len rescale, basemodel.py:1066-1071)."""

    def __init__(self, num_embeddings: int, features: int,
                 weight_init: str = "orthogonal", scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = (num_embeddings, features)
        if weight_init == "normal":
            w = torch.randn(shape, generator=generator)
        elif weight_init == "uniform":
            w = torch.rand(shape, generator=generator) * 2.0 - 1.0
        elif weight_init == "orthogonal":
            w = get_initializer("orthogonal")(shape, generator)
        elif weight_init == "equivariant":
            row = torch.randn(features, generator=generator)
            idx = (torch.arange(features)[None, :]
                   - torch.arange(num_embeddings)[:, None]) % features
            w = row[idx]
        else:
            raise ValueError(f"unknown embedding init '{weight_init}'")
        self.weight = nn.Parameter(w * scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_table(self.weight, x)
