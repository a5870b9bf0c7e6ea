"""The JAX package's performance surface in one script
(examples/performance_levers.py): the SCM step under amp bf16 in 4
microbatches, and train_unc owner-sharded over ranks.

    python -m dualmessagepassing_tpu_torch.examples.performance_levers \
        [--ranks N] [--backend gloo|nccl] [--device cpu]

SCM: make_train_step(amp=True, accum_chunks=4), bf16 compute with
float32 master parameters, the mean gradient of 4 microbatches in one
update, on the JAX script's dataset (32 synthetic pairs, hid 16, node
and edge weights).

UNC: train_unc(ep_mode="halo", ep_partition="bfs", amp=True) over the
ranks on the script's 30-node, 150-link graph: each rank owns its node
rows and their in-edges (BFS-grown owners), one exchange of the
boundary rows a layer, the backbone in bf16.

The JAX script's two single-device UNC demos set TPU levers this package
does not carry (endpoint_gather="fused", pad_cols and
scatter_backend="windowed"; ROADMAP.md "Not ported": their numbers
equal the plain path's). The port always runs its K1/K2 plans, so in
their place this script runs train_unc on one device with amp, the
port's single-device default.
"""

from __future__ import annotations

import argparse
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .. import ModelConfig, build_model
from ..data.dataset import GraphAdjDataset
from ..data.synthetic import generate_dataset
from ..parallel.dist import World
from ..train.scm_driver import make_optimizer, make_train_step
from ..unc.driver import train_unc
from ..unc.model import UNCTrainModel
from .multichip_dp import run_ranks

SCM_CONFIG = ModelConfig(max_ngv=8, max_ngvl=2, max_nge=16, max_ngel=2,
                         max_npv=4, max_npvl=2, max_npe=4, max_npel=2,
                         hid_dim=16, pred_return_weights="nodeedge")
# the JAX step's scalars: neg_slope, match_loss_w, match_reg_w,
# rep_reg_w, lr_mult
SCM_SCALARS = (0.2, 0.1, 0.0, 1e-4, 1.0)
UNC_NODES, UNC_RELS = 30, 2
UNC_KW = dict(graph_batch_size=50, sample_depth=2, sample_width=5,
              n_epochs=2, v_max=30, e_max=150, seed=0, amp=True)


def scm_amp_microbatched(device: str = "cuda",
                         state_dict: Optional[Mapping] = None,
                         amp: bool = True) -> Dict[str, object]:
    """One amp step in 4 microbatches on 16 pairs -> its losses (before
    the update), the gradient the update took (the microbatches' mean)
    and the parameters after it, numpy. state_dict replaces the seed-0
    weights; amp=False takes the float32 step, which the amp step is
    held to."""
    data = generate_dataset(32, seed=0, pv=3, pe=3, gv=8, ge=16,
                            num_vlabels=2, num_elabels=2, p_v_max=4,
                            p_e_max=4, g_v_max=8, g_e_max=16)
    model = build_model(SCM_CONFIG, device=device, seed=0)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    _, pattern, graph, counts, (nw, ew) = GraphAdjDataset(data).batchify(
        range(16), "nodeedge")
    step = make_train_step(model, make_optimizer(model.parameters(), 1e-3),
                           return_weights="nodeedge", amp=amp,
                           accum_chunks=4)
    losses = step(pattern.to(device), graph.to(device), counts.to(device),
                  nw.to(device), ew.to(device), *SCM_SCALARS)
    losses = {k: v.item() for k, v in losses.items()}
    print(f"SCM {'amp+' if amp else ''}chunked step: loss "
          f"{losses['total']:.4f}")
    return {"losses": losses,
            "grads": {k: p.grad.cpu().numpy()
                      for k, p in model.named_parameters()},
            "params": {k: p.detach().cpu().numpy()
                       for k, p in model.named_parameters()}}


def unc_triplets() -> np.ndarray:
    """The script's graph: 150 links among 30 nodes, 2 relations."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, UNC_NODES, 150)
    dst = (src + rng.integers(1, UNC_NODES, 150)) % UNC_NODES
    rel = rng.integers(0, UNC_RELS, 150)
    return np.stack([src, rel, dst], 1).astype(np.int64)


def unc_model(device) -> UNCTrainModel:
    """The JAX train_unc's model: h_dim 8, one layer, its defaults
    (dropout 0.2, reg_param 1e-2), weights from seed 0."""
    return UNCTrainModel(
        UNC_NODES, UNC_RELS, 8, num_hidden_layers=1, dropout=0.2,
        reg_param=1e-2, generator=torch.Generator().manual_seed(0)
    ).to(device)


def unc_train(world: Optional[World], device=None,
              amp: bool = True) -> Dict[str, object]:
    """train_unc on one device (world None) or owner-sharded over the
    ranks of `world` (halo, bfs; on world.device) -> the embeddings, the
    coverage, each epoch's loss and the number of steps. amp=False takes
    the float32 run, which the amp run is held to."""
    kw = dict(UNC_KW, amp=amp)
    if world is not None:
        device = world.device
        kw.update(world=world, ep_mode="halo", ep_partition="bfs")
    epochs = []
    emb, coverage = train_unc(unc_model(device), unc_triplets(), UNC_NODES,
                              UNC_RELS, on_epoch=epochs.append,
                              log=lambda s: None, **kw)
    return {"emb": emb, "coverage": coverage,
            "losses": [e["loss"] for e in epochs],
            "steps": sum(e["steps"] for e in epochs)}


def unc_all_levers(device: str = "cuda", ranks: Optional[int] = None,
                   backend: Optional[str] = None) -> Dict[str, object]:
    """The owner-sharded run over `ranks` ranks -> rank 0's result."""
    out = run_ranks(unc_train, ranks, device, backend)[0]
    print(f"UNC halo+bfs+amp over {len(out['emb'])} nodes: coverage "
          f"{out['coverage']:.2f}, emb shape {out['emb'].shape}")
    return out


def unc_single_device(device: str = "cuda") -> Dict[str, object]:
    """The port's single-device default composition, with amp."""
    out = unc_train(None, device)
    print(f"UNC single device, amp: coverage {out['coverage']:.2f}, "
          f"emb shape {out['emb'].shape}")
    return out


def main(device: str = "cuda", ranks: Optional[int] = None,
         backend: Optional[str] = None) -> Dict[str, object]:
    return {"scm": scm_amp_microbatched(device)["losses"],
            "unc_halo": unc_all_levers(device, ranks, backend),
            "unc_single": unc_single_device(device)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ranks", type=int)
    parser.add_argument("--backend", choices=("gloo", "nccl"))
    main(**vars(parser.parse_args()))
