"""Mixed precision for the port (dualmessagepassing_tpu/utils/amp.py).

The JAX package reads a trace-time global compute dtype. Here the
compute dtype is an argument: the model's forward takes ``dtype`` and
casts each float32 master parameter to it at use (unc/model.py), which
is what ``apply_unc_forward(amp=True)`` does with cast_floats(params,
bf16). Statistics and accumulators stay float32 inside the model
(MaskedBatchNorm, the segment-sum kernel), and outputs come back
float32 through cast_floats.

torch.autocast is deliberately not used: it picks the dtype per
operator, so index_add_ and other scatters would accumulate in bf16 and
the matmul inputs would round at other places than the reference's.
"""

from __future__ import annotations

import torch


def cast_floats(tree, dtype: torch.dtype):
    """Cast every float tensor of a nested tuple/list/dict to dtype."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return tree
