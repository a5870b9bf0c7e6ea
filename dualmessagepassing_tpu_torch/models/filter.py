"""Label filter (dualmessagepassing_tpu/models/filter.py): gate graph
elements whose label never appears in the pattern.

Reference: SubgraphCountingMatching/models/filter.py:6-16 (ScalarFilter),
with explicit pattern masks so padded pattern slots cannot enable label-0
graph elements.
"""

from __future__ import annotations

from typing import Optional

import torch


def scalar_filter(p_x: torch.Tensor, g_x: torch.Tensor,
                  p_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """gate[b, j] = any_i (g_x[b, j] == p_x[b, i] and p_mask[b, i]).

    p_x [B, Lp] int, g_x [B, Lg] int, p_mask [B, Lp] bool -> [B, Lg] bool.
    """
    eq = g_x[:, :, None] == p_x[:, None, :]
    if p_mask is not None:
        eq = eq & p_mask[:, None, :]
    return eq.any(dim=2)
