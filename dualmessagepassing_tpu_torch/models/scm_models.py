"""SCM model classes, registry and builder
(dualmessagepassing_tpu/models/scm_models.py; reference train.py:68-87
build_model), and params_from_flax, which carries a JAX model's weights
into the port.

DMPNN is the one SCM model the port has (the flagship of
__graft_entry__.py:_flagship_config); CompGCN, R-GCN, R-GIN, LRP and the
EdgeSeq models register in the JAX package from modules not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Type

import numpy as np
import torch
from torch import nn

from .basemodel import GraphAdjModelV2, ModelConfig
from .dmpnn import DMPNNStack


class DMPNN(GraphAdjModelV2):
    """Dual message passing network (reference models/dmpnn.py:179-277)."""

    def make_rep_net(self, generator) -> nn.Module:
        cfg = self.cfg
        return DMPNNStack(
            num_layers=cfg.rep_num_graph_layers,
            in_dim=cfg.hid_dim,
            hidden_dim=cfg.hid_dim,
            init_neigenv=cfg.init_neigenv,
            init_eeigenv=cfg.init_eeigenv,
            num_mlp_layers=cfg.rep_dmpnn_num_mlp_layers,
            batch_norm=cfg.rep_dmpnn_batch_norm,
            act=cfg.rep_act_func,
            dropout=cfg.rep_dropout,
            residual=cfg.rep_residual,
            scatter_method=cfg.scatter_method,
            remat=cfg.rep_remat,
            generator=generator,
        )


MODEL_REGISTRY: Dict[str, Type[GraphAdjModelV2]] = {"DMPNN": DMPNN}


def build_model(cfg: ModelConfig, device="cuda",
                seed: int = 0) -> GraphAdjModelV2:
    """The model cfg.rep_net names, with random weights drawn on the CPU
    from torch.Generator(seed), on `device` (cuda by default; the CPU
    only when asked)."""
    try:
        cls = MODEL_REGISTRY[cfg.rep_net]
    except KeyError:
        raise ValueError(f"unknown or unported rep_net '{cfg.rep_net}'") \
            from None
    model = cls(cfg, generator=torch.Generator().manual_seed(seed))
    return model.to(device)


_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_flax(params: Mapping,
                     batch_stats: Optional[Mapping] = None
                     ) -> Dict[str, torch.Tensor]:
    """A JAX SCM model's flax variables (the "params" and "batch_stats"
    trees, numpy arrays or anything np.asarray takes) -> this port's
    state_dict. Names are the flax paths joined by "."; a BatchNorm's
    scale is its weight and its mean/var are running_mean/running_var.
    Kernels keep their [in, out] layout, so every leaf is a copy."""
    sd = {}
    for path, leaf in _leaves(params):
        if len(path) > 1 and path[-2].startswith("bn") \
                and path[-1] == "scale":
            path = path[:-1] + ("weight",)
        sd[".".join(path)] = torch.from_numpy(np.array(leaf, np.float32))
    for path, leaf in _leaves(batch_stats or {}):
        path = path[:-1] + (_STAT_NAMES[path[-1]],)
        sd[".".join(path)] = torch.from_numpy(np.array(leaf, np.float32))
    return sd


def k3_launches(cfg: ModelConfig, train: bool) -> int:
    """K3 launches of one forward (train=False) or of one forward and
    backward (train=True) of the model on a CUDA batch, derived from the
    code: the pattern and the graph each run the rep net (shared or not,
    rep_num_graph_layers layers), which launches K3 once for the
    out-degrees and once per layer for the aggregation; the backward
    launches it twice per layer, for the two endpoint gathers (a
    rematerialised layer repeats its aggregation too); pred_with_deg adds
    the two degree tables of each side."""
    layers = cfg.rep_num_graph_layers
    fwd = 2 * (1 + layers) + (4 if cfg.pred_with_deg else 0)
    if not train:
        return fwd
    return fwd + 2 * (2 * layers + (layers if cfg.rep_remat else 0))
