"""Degree norms and largest-eigenvalue bounds
(dualmessagepassing_tpu/ops/spectral.py): the numpy host half (18-70)
and the device edge norm (edge_norm_device, 71).

Reference: SubgraphCountingMatching/utils/graph.py:11-71. The bounds set
the DMPLayer init scale (init_neigenv / init_eeigenv); the reference's
training script clamps them to >= 4.0 (train.py:1174-1186). No model
calls edge_norm_device (models/compgcn.py computes its norms inline, and
the port's CompGCN and R-GCN use degree_norms): it is a plain gather,
indexed as JAX's take_along_axis (ops/scatter.jax_index: [-V, 0) wraps,
any other index outside [0, V) reads NaN).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .scatter import jax_index


def degrees_np(senders: np.ndarray, receivers: np.ndarray, num_nodes: int,
               mask: np.ndarray = None) -> Tuple[np.ndarray, np.ndarray]:
    """(out_deg, in_deg) of a host COO edge list."""
    if mask is not None:
        senders = senders[mask]
        receivers = receivers[mask]
    out_deg = np.bincount(senders, minlength=num_nodes).astype(np.float64)
    in_deg = np.bincount(receivers, minlength=num_nodes).astype(np.float64)
    return out_deg, in_deg


def largest_eigenvalue_bounds_np(
    senders: np.ndarray, receivers: np.ndarray, num_nodes: int,
    mask: np.ndarray = None,
) -> Tuple[float, float]:
    """Upper bounds on the largest eigenvalue of the primal and dual
    Laplacians: max over edges (u, v) of outdeg(u) + indeg(v), and of
    indeg(u) + outdeg(v) (utils/graph.py:40-71)."""
    if mask is not None:
        senders = senders[mask]
        receivers = receivers[mask]
    if len(senders) == 0:
        return 0.0, 0.0
    out_deg, in_deg = degrees_np(senders, receivers, num_nodes)
    max_nd = float((out_deg[senders] + in_deg[receivers]).max())
    max_ed = float((in_deg[senders] + out_deg[receivers]).max())
    return max_nd, max_ed


def compute_norm_np(
    senders: np.ndarray, receivers: np.ndarray, num_nodes: int,
    self_loop: bool, mask: np.ndarray = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reciprocal in-degree node norm and its per-edge gather at dst
    (compute_norm, utils/graph.py:11-37): 1/(indeg+1) with self loops,
    else 1/indeg with in-degree 0 mapped to 1."""
    _, in_deg = degrees_np(senders, receivers, num_nodes, mask)
    if self_loop:
        node_norm = 1.0 / (in_deg + 1.0)
    else:
        node_norm = np.where(in_deg == 0, 1.0, 1.0 / np.maximum(in_deg, 1))
    node_norm = node_norm[:, None].astype(np.float32)
    return node_norm, node_norm[receivers]


def edge_norm_device(in_degrees: torch.Tensor, receivers: torch.Tensor,
                     self_loop: bool) -> torch.Tensor:
    """[B, V] in-degrees and [B, E] receivers -> [B, E, 1]: compute_norm's
    node norm gathered at each edge's receiver."""
    if not in_degrees.is_floating_point():
        in_degrees = in_degrees.float()
    if self_loop:
        node_norm = 1.0 / (in_degrees + 1.0)
    else:
        node_norm = torch.where(in_degrees == 0, 1.0,
                                1.0 / torch.clamp_min(in_degrees, 1.0))
    idx, inside = jax_index(receivers, node_norm.shape[1])
    rows = torch.gather(node_norm, 1, torch.where(inside, idx, 0))
    return torch.where(inside, rows, float("nan"))[..., None]
