"""Training checkpoints (dualmessagepassing_tpu/train/checkpoint.py):
the UNC driver's per-epoch state, the SCM CLI's best-epoch state and
params-only checkpoints, and expand_params, which grows a trained SCM
model onto a larger vocabulary.

SCM (save_state/restore_state, cli/scm_train.py's epoch{N}/): one file,
epoch{N}/state.pt, written with torch.save: the model's state_dict, the
optimizer's (SCMOptimizer or MultiSteps), the step (the LR clock) and the
dropout generator's state. save_params/restore_params keep the
state_dict alone (the reference's epoch{E}.pt). The JAX package writes
orbax directories; neither package reads the other's checkpoints (the
JAX package's weights reach the port through
models/scm_models.params_from_flax).

UNC: one file, checkpoint_dir/latest, written with torch.save: the model's
state_dict (parameters and BatchNorm running statistics), the
optimizer's state (Adam moments and step, the schedule's update count),
the loop clocks (last finished epoch, the loss the early stop compares
with), the numpy sampling RNG and the dropout generator's state. It
saves every backbone alike (the state_dict holds whatever the model
has). The format is not the
JAX package's orbax directory, and neither package reads the other's.
Unlike the JAX package, the sampling RNG is saved, so a resumed run
samples what the uninterrupted run would have sampled. The file is
written to a temporary name and renamed, so an interrupted save leaves
the previous checkpoint whole.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

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
                        clocks: Dict, rng: np.random.Generator,
                        generator: Optional[torch.Generator] = None) -> None:
    """clocks: {"epoch", "prev_loss"}; optimizer: anything with
    state_dict() (unc.driver.UNCOptimizer); generator: the dropout
    generator, if any."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    state = {"model": model.state_dict(),
             "optimizer": optimizer.state_dict(),
             "clocks": json.dumps(dict(clocks, rng=rng_state(rng)))}
    if generator is not None:
        state["dropout_rng"] = generator.get_state()
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore_unc_checkpoint(path: str, model: torch.nn.Module, optimizer,
                           generator: Optional[torch.Generator] = None
                           ) -> Dict:
    """Load the model's, the optimizer's and (where both have it) the
    dropout generator's state in place -> the clocks, with the RNG's
    state under "rng" (rng_from_state)."""
    device = next(model.parameters()).device
    saved = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(saved["model"])
    optimizer.load_state_dict(saved["optimizer"])
    if generator is not None and "dropout_rng" in saved:
        generator.set_state(saved["dropout_rng"].cpu())
    return json.loads(saved["clocks"])


# -----------------------------------------------------------------------------
# SCM: best-epoch state, params-only checkpoints, expansion
# -----------------------------------------------------------------------------

STATE_FILE, PARAMS_FILE = "state.pt", "params.pt"


def _save(obj, path: str, name: str) -> None:
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, name)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, target)


def save_state(path: str, model: torch.nn.Module, optimizer, step: int,
               generator: Optional[torch.Generator] = None) -> None:
    """The directory `path` gets state.pt: the model's state_dict
    (parameters and BatchNorm statistics), optimizer.state_dict(), the
    step and the dropout generator's state."""
    state = {"model": model.state_dict(),
             "optimizer": optimizer.state_dict(), "step": int(step)}
    if generator is not None:
        state["dropout_rng"] = generator.get_state()
    _save(state, path, STATE_FILE)


def restore_state(path: str, model: Optional[torch.nn.Module] = None,
                  optimizer=None,
                  generator: Optional[torch.Generator] = None) -> Dict:
    """Read what save_state wrote -> its dict (tensors on the CPU); the
    model, the optimizer and the generator that are given load their
    parts in place."""
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    if model is not None:
        model.load_state_dict(saved["model"])
    if optimizer is not None:
        optimizer.load_state_dict(saved["optimizer"])
    if generator is not None and "dropout_rng" in saved:
        generator.set_state(saved["dropout_rng"])
    return saved


def save_params(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Params-only checkpoint: the directory `path` gets params.pt."""
    _save(dict(state_dict), path, PARAMS_FILE)


def restore_params(path: str, model: Optional[torch.nn.Module] = None
                   ) -> Dict[str, torch.Tensor]:
    """The state_dict save_params wrote (on the CPU); a given model loads
    it in place."""
    sd = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu",
                    weights_only=True)
    if model is not None:
        model.load_state_dict(sd)
    return sd


def expand_params(old: Mapping[str, torch.Tensor],
                  new: Mapping[str, torch.Tensor],
                  pre_pad: bool = True) -> Dict[str, torch.Tensor]:
    """Copy old tensors into the tail (pre_pad) or head slices of the new
    ones, matched by name (the JAX package's expand_params over flax
    paths; reference expand_dimensions, utils/dl.py:157-191): a new
    tensor with no old match keeps its fresh value; one of the old shape
    takes the old value; a larger one is zeroed and the old values go
    into its tail (head) slice in every dimension; ranks that differ
    raise. The multihot encodings grow at the front (new most-
    significant digit blocks), so old rows live at the tail."""
    out = {}
    for name, fresh in new.items():
        prev = old.get(name)
        if prev is None:
            out[name] = fresh
            continue
        prev = prev.to(fresh.device, fresh.dtype)
        if prev.shape == fresh.shape:
            out[name] = prev.clone()
            continue
        if prev.dim() != fresh.dim():
            raise ValueError(f"rank mismatch at {name}")
        idx = tuple(slice(n - o, None) if pre_pad else slice(0, o)
                    for o, n in zip(prev.shape, fresh.shape))
        grown = torch.zeros_like(fresh)
        grown[idx] = prev
        out[name] = grown
    return out
