"""Data-parallel training step over ranks (examples/multichip_dp.py):
the quickstart's model and step on a batch of 2 pairs a rank.

    python -m dualmessagepassing_tpu_torch.examples.multichip_dp \
        [--ranks N] [--backend gloo|nccl] [--device cpu]

The JAX example shards the batch over a 'dp' mesh axis and replicates
the parameters; XLA inserts the gradient psum. Here each rank is a
spawned process (parallel/dist.launch): the batch is cut to the rank's
share (parallel/dp.shard_batch), rank 0's weights are written to every
rank (parallel/dp.replicate), and make_train_step(world=...) sums the
gradients over the ranks before the AdamW update. The loss is the JAX
example's, the mean squared error of pred_c: scm_loss's count loss with
a leaky ReLU slope of 1, the identity, completed over the ranks.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import build_model
from ..parallel.dist import World, launch, launch_plan, rank_threads
from ..parallel.dp import replicate, shard_batch
from ..train.scm_driver import make_train_step
from .quickstart_scm import CONFIG, adamw, make_batch


def dp_step(world: Optional[World], device=None, ranks: int = 1,
            state_dict=None) -> Dict[str, object]:
    """One step on this rank of `world` (None: the whole batch of 2 *
    ranks pairs on `device`, the one-device step it must equal) -> the
    loss over the whole batch, the gradient the update took (the whole
    batch's, summed over the ranks) and the state after the step
    (numpy)."""
    if world is not None:
        device, ranks = world.device, world.size
    bsz = 2 * ranks
    rng = np.random.default_rng(0)
    pattern, graph = make_batch(rng, bsz=bsz)
    counts = torch.from_numpy(rng.poisson(2.0, (bsz, 1)).astype(np.float32))
    model = build_model(CONFIG, device=device, seed=0)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    if world is not None:
        replicate(world, model.state_dict().values())
        pattern, graph, counts = shard_batch(world, pattern, graph, counts)
    step = make_train_step(model, adamw(model.parameters()), accum_chunks=1,
                           world=world)
    losses = step(pattern.to(device), graph.to(device), counts.to(device),
                  None, None, neg_slope=1.0, match_loss_w=0.0,
                  match_reg_w=0.0, rep_reg_w=0.0)
    return {"loss": losses["total"].item(),
            "grads": {k: p.grad.cpu().numpy()
                      for k, p in model.named_parameters()},
            "state": {k: v.cpu().numpy()
                      for k, v in model.state_dict().items()}}


def run_ranks(fn, ranks: Optional[int], device: str,
              backend: Optional[str], args: tuple = ()) -> List[object]:
    """fn(world, *args) on `ranks` spawned ranks (every visible card, or
    2 on the CPU; parallel/dist.launch_plan's backend and devices) ->
    each rank's result."""
    if ranks is None:
        ranks = torch.cuda.device_count() if device != "cpu" else 2
    backend, devices = launch_plan(ranks, device, backend)
    print(f"world: {ranks} ranks over {backend} on {devices}")
    with tempfile.TemporaryDirectory() as tmp:
        return launch(fn, ranks, backend=backend, devices=devices,
                      init_file=os.path.join(tmp, "rdv"), args=args,
                      threads=rank_threads(devices))


def main(device: str = "cuda", ranks: Optional[int] = None,
         backend: Optional[str] = None) -> Dict[str, object]:
    """The step over `ranks` ranks -> each rank's loss."""
    losses = [r["loss"] for r in run_ranks(dp_step, ranks, device, backend)]
    print("dp train-step loss:", losses[0])
    return {"losses": losses}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ranks", type=int)
    parser.add_argument("--backend", choices=("gloo", "nccl"))
    main(**vars(parser.parse_args()))
