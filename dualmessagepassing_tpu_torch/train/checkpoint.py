"""Per-epoch training checkpoints of the UNC driver
(dualmessagepassing_tpu/train/checkpoint.py and unc/driver.py:562-581,
630-636).

One file, checkpoint_dir/latest, written with torch.save: the model's
state_dict (parameters and BatchNorm running statistics), the
optimizer's state (Adam moments and step, the schedule's update count),
the loop clocks (last finished epoch, the loss the early stop compares
with) and the numpy sampling RNG. The format is not the
JAX package's orbax directory, and neither package reads the other's.
Unlike the JAX package, the sampling RNG is saved, so a resumed run
samples what the uninterrupted run would have sampled. The file is
written to a temporary name and renamed, so an interrupted save leaves
the previous checkpoint whole.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch


def rng_state(rng: np.random.Generator) -> Dict:
    """Everything a Generator made by default_rng(seed) needs to be made
    again: its bit generator's state and its seed sequence, with the
    count of children rng.spawn has taken from it."""
    seq = rng.bit_generator.seed_seq
    return {"entropy": seq.entropy, "spawn_key": list(seq.spawn_key),
            "pool_size": seq.pool_size,
            "n_children_spawned": seq.n_children_spawned,
            "bit_generator": rng.bit_generator.state}


def rng_from_state(state: Dict) -> np.random.Generator:
    seq = np.random.SeedSequence(
        state["entropy"], spawn_key=tuple(state["spawn_key"]),
        pool_size=state["pool_size"],
        n_children_spawned=state["n_children_spawned"])
    bit_gen = getattr(np.random, state["bit_generator"]["bit_generator"])(seq)
    bit_gen.state = state["bit_generator"]
    return np.random.Generator(bit_gen)


def save_unc_checkpoint(path: str, model: torch.nn.Module, optimizer,
                        clocks: Dict, rng: np.random.Generator) -> None:
    """clocks: {"epoch", "prev_loss"}; optimizer: anything with
    state_dict() (unc.driver.UNCOptimizer)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "clocks": json.dumps(dict(clocks, rng=rng_state(rng)))}, tmp)
    os.replace(tmp, path)


def restore_unc_checkpoint(path: str, model: torch.nn.Module,
                           optimizer) -> Dict:
    """Load the model's and the optimizer's state in place -> the clocks,
    with the RNG's state under "rng" (rng_from_state)."""
    device = next(model.parameters()).device
    saved = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(saved["model"])
    optimizer.load_state_dict(saved["optimizer"])
    return json.loads(saved["clocks"])
