"""Minimal SCM quickstart (examples/quickstart_scm.py): build a DMPNN
counting model, one forward, one AdamW step.

    python -m dualmessagepassing_tpu_torch.examples.quickstart_scm \
        [--device cpu]

The batch is the JAX example's: numpy seed 0, 4 pairs of a 4-node,
6-edge pattern and an 8-node, 16-edge graph over 3 labels; hid 32,
DMPNN. The loss is the mean squared error of pred_c against Poisson(2)
counts and the step optax.adamw(1e-3) with its defaults (betas 0.9,
0.999, eps 1e-8, weight decay 1e-4), written as torch.optim.AdamW.
"""

from __future__ import annotations

import argparse
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from .. import ModelConfig, batch_graphs, build_model, single_graph
from ..train.scm_driver import TorchOptimizer

CONFIG = ModelConfig(max_ngv=8, max_ngvl=3, max_nge=16, max_ngel=3,
                     max_npv=4, max_npvl=3, max_npe=6, max_npel=3,
                     hid_dim=32, rep_net="DMPNN")


def make_batch(rng: np.random.Generator, bsz: int = 4):
    """(pattern, graph) GraphBatches of bsz random pairs, drawn as the
    JAX example draws them."""
    pats, gras = [], []
    for _ in range(bsz):
        pats.append(single_graph(
            4, rng.integers(0, 4, 6), rng.integers(0, 4, 6),
            node_labels=rng.integers(0, 3, 4),
            edge_labels=rng.integers(0, 3, 6), v_max=4, e_max=6))
        gras.append(single_graph(
            8, rng.integers(0, 8, 16), rng.integers(0, 8, 16),
            node_labels=rng.integers(0, 3, 8),
            edge_labels=rng.integers(0, 3, 16), v_max=8, e_max=16))
    return batch_graphs(pats), batch_graphs(gras)


def adamw(params: Iterable[torch.nn.Parameter],
          lr: float = 1e-3) -> TorchOptimizer:
    """optax.adamw(lr) with its defaults."""
    return TorchOptimizer(params, torch.optim.AdamW, lr=lr,
                          betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def main(device: str = "cuda",
         state_dict: Optional[Mapping[str, torch.Tensor]] = None
         ) -> Dict[str, object]:
    """The forward's pred_c and the step's loss (before the update, as
    the JAX example prints it), its gradients and the parameters after
    it, all numpy. state_dict replaces the seed-0 weights (tests carry
    the JAX example's in through models/scm_models.params_from_flax)."""
    rng = np.random.default_rng(0)
    pattern, graph = make_batch(rng)
    model = build_model(CONFIG, device=device, seed=0)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    pattern, graph = pattern.to(device), graph.to(device)
    with torch.no_grad():
        pred_c = model(pattern, graph)["pred_c"]
    print("pred_c:", pred_c.cpu().numpy().ravel())

    counts = torch.from_numpy(
        rng.poisson(2.0, (4, 1)).astype(np.float32)).to(device)
    tx = adamw(model.parameters())
    tx.zero_grad()
    loss = ((model(pattern, graph)["pred_c"] - counts) ** 2).mean()
    loss.backward()
    grads = {k: p.grad.cpu().numpy().copy()
             for k, p in model.named_parameters()}
    tx.step()
    print("loss after one step:", loss.item())
    return {"pred_c": pred_c.cpu().numpy(), "loss": loss.item(),
            "grads": grads,
            "params": {k: p.detach().cpu().numpy()
                       for k, p in model.named_parameters()}}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
