"""Edge-partitioned dual message passing (examples/edge_parallel.py):
the demonstration layer of parallel/edge_partition.py over ranks.

    python -m dualmessagepassing_tpu_torch.examples.edge_parallel \
        [--ranks N] [--backend gloo|nccl] [--device cpu]

The edges and the edge stream [E, H] are split into one block a rank
(pad_to_multiple, shard_flat_edges); each rank sums its messages into
the whole node table on K3 and one sum over the ranks a layer completes
it. The JAX example's sizes and draws: numpy seed 0, V 64, E 4,096, H
32, 2 layers; the weights from seed 0 (init_edge_parallel_params), or
the JAX package's (params_from_jax).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..parallel.dist import World
from ..parallel.edge_partition import (edge_parallel_dmp_apply,
                                       init_edge_parallel_params,
                                       pad_to_multiple, params_from_jax,
                                       shard_flat_edges)
from .multichip_dp import run_ranks

V, E, H, LAYERS = 64, 4096, 32, 2


def inputs(n_shards: int) -> tuple:
    """(edge arrays padded to a multiple of n_shards, node_feat [V, H],
    edge_feat [E', H], pad rows 0), drawn as the JAX example draws them."""
    rng = np.random.default_rng(0)
    arrays = pad_to_multiple({
        "senders": rng.integers(0, V, E),
        "receivers": rng.integers(0, V, E),
        "rev_flag": rng.integers(0, 2, E).astype(bool),
    }, n_shards)
    node_feat = rng.normal(size=(V, H)).astype(np.float32)
    edge_feat = rng.normal(size=(len(arrays["senders"]), H)).astype(
        np.float32)
    edge_feat[~arrays["edge_mask"]] = 0.0
    return arrays, node_feat, edge_feat


def ep_forward(world: Optional[World],
               jax_params: Optional[Sequence[dict]] = None,
               device="cuda") -> Dict[str, np.ndarray]:
    """The forward on this rank of `world` (None: every edge on `device`)
    -> the node rows (the same on every rank) and this rank's edge rows,
    numpy."""
    if world is not None:
        device = world.device
    arrays, node_feat, edge_feat = inputs(1 if world is None else world.size)
    a = shard_flat_edges(world, dict(arrays, edge_feat=edge_feat), device)
    params = (init_edge_parallel_params(LAYERS, H, device=device)
              if jax_params is None else params_from_jax(jax_params, device))
    with torch.no_grad():
        v_out, e_out = edge_parallel_dmp_apply(
            params, torch.from_numpy(node_feat).to(device), a["edge_feat"],
            a["senders"], a["receivers"], a["rev_flag"], a["edge_mask"], V,
            world)
    return {"node_out": v_out.cpu().numpy(), "edge_out": e_out.cpu().numpy()}


def main(device: str = "cuda", ranks: Optional[int] = None,
         backend: Optional[str] = None) -> Dict[str, object]:
    """The forward over `ranks` ranks -> the node rows and every rank's
    edge rows in rank order."""
    out = run_ranks(ep_forward, ranks, device, backend)
    node = out[0]["node_out"]
    edge = np.concatenate([r["edge_out"] for r in out])
    print("node out:", node.shape, "edge out:", edge.shape,
          "edge shards:", len(out))
    return {"node_out": node, "edge_out": edge}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ranks", type=int)
    parser.add_argument("--backend", choices=("gloo", "nccl"))
    main(**vars(parser.parse_args()))
