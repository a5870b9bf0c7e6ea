"""The port's operations (dualmessagepassing_tpu/ops/): encodings, the
gathers and segment-sums over a padded batch and the helpers off every
model path (scatter.py, on K3), degree norms (spectral.py), and the
kernels' wrappers (segment_kernel.py: K1, K2; scatter_kernels.py: K3,
K4). The names below are exported as the JAX package's ops/__init__.py
exports them."""

from .encoding import (get_enc_len, int2anybase, int2multihot,
                       multihot_table, position_table)
from .scatter import (gather_nodes, scatter_max_edges, scatter_sum_edges,
                      scatter_sum_flat, segment_softmax_edges)
from .spectral import (compute_norm_np, degrees_np, edge_norm_device,
                       largest_eigenvalue_bounds_np)

__all__ = ["compute_norm_np", "degrees_np", "edge_norm_device",
           "gather_nodes", "get_enc_len", "int2anybase", "int2multihot",
           "largest_eigenvalue_bounds_np", "multihot_table",
           "position_table", "scatter_max_edges", "scatter_sum_edges",
           "scatter_sum_flat", "segment_softmax_edges"]
