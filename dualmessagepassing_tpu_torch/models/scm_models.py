"""SCM model classes, registry and builder
(dualmessagepassing_tpu/models/scm_models.py; reference train.py:68-87
build_model), and params_from_flax, which carries a JAX model's weights
into the port.

DMPNN is the flagship (__graft_entry__.py:_flagship_config); CompGCN
(models/compgcn.py), R-GCN and R-GIN (models/rgnn.py), LRP and DMPLRP
(models/lrp.py) are the paper's other graph networks, CNN, RNN and TXL
(models/edgeseq.py) its sequence networks. Submodules are named by their
flax paths (g_rep_net.compgcn_0.in_weight, g_rep_net.rgin_1.rel_weights.
weight, g_rep_net.lrp_0.degnet_0.kernel, g_rep_net.rnn_0.GRUCell_1.hn.
bias, g_rep_net.attn_2.layer_norm.scale, ...), and the sequence networks
keep flax's kernel layouts (nn.Conv [k, in, out], the RNN cells' gate
kernels [in, h]), so params_from_flax needs no table of names.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .basemodel import GraphAdjModelV2, ModelConfig
from .compgcn import CompGCN
from .dmpnn import DMPNNStack
from .edgeseq import CNN, RNN, TransformerXL
from .lrp import DMPLRP, LRP
from .rgnn import RGCN, RGIN


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


MODEL_REGISTRY: Dict[str, type] = {
    "DMPNN": DMPNN, "CompGCN": CompGCN, "RGCN": RGCN, "RGIN": RGIN,
    "LRP": LRP, "DMPLRP": DMPLRP, "CNN": CNN, "RNN": RNN,
    "TXL": TransformerXL}


def build_model(cfg: ModelConfig, device="cuda", seed: int = 0) -> nn.Module:
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
    backward (train=True) of cfg.rep_net's model on a CUDA batch, derived
    from the code. The pattern and the graph each run the rep net (shared
    or not) of L = rep_num_graph_layers layers. Per side, forward:

      DMPNN   1 (out-degrees) + L (aggregation)
      CompGCN L (aggregation) + the degree tables edge_norm reads (in,
              out: 1; both: 2)
      RGCN    L (relation fold) + the degree tables edge_norm reads
      RGIN    L (relation fold)
      LRP     L (pool sum) + 1 (pool counts) + 1 (in-degrees)
      DMPLRP  2L (aggregation, pool sum) + 1 (pool counts) + 1
              (out-degrees)
      CNN, RNN, TXL  0 (convolutions, recurrences, attention)

    backward: DMPNN 2L (the two endpoint gathers), CompGCN, RGCN, RGIN L
    (the sender gather), LRP L (the cell gather), DMPLRP 3L, the
    sequence networks 0; a
    rematerialised layer (rep_remat: DMPNN, CompGCN, RGCN, RGIN) repeats
    its forward launches but the degrees'. pred_with_deg adds the two
    degree tables of each side."""
    layers = cfg.rep_num_graph_layers
    net = cfg.rep_net
    n_deg = {"none": 0, "in": 1, "out": 1, "both": 2}
    if net == "DMPNN":
        fwd, bwd, remat = 1 + layers, 2 * layers, layers
    elif net == "CompGCN":
        fwd = layers + n_deg[cfg.rep_compgcn_edge_norm]
        bwd, remat = layers, layers
    elif net in ("RGCN", "RGIN"):
        fwd = layers + (n_deg[cfg.rep_rgcn_edge_norm] if net == "RGCN"
                        else 0)
        bwd, remat = layers, layers
    elif net == "LRP":
        fwd, bwd, remat = layers + 2, layers, 0
    elif net == "DMPLRP":
        fwd, bwd, remat = 2 * layers + 2, 3 * layers, 0
    elif net in ("CNN", "RNN", "TXL"):
        fwd, bwd, remat = 0, 0, 0
    else:
        raise ValueError(f"unknown or unported rep_net '{net}'")
    fwd = 2 * fwd + (4 if cfg.pred_with_deg else 0)
    if not train:
        return fwd
    return fwd + 2 * (bwd + (remat if cfg.rep_remat else 0))
