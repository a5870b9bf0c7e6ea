"""Edge-partitioned message passing for single large graphs: the JAX
package's demonstration layer (dualmessagepassing_tpu/parallel/
edge_partition.py) over the ranks of a World.

A simplified DMP layer (the math of DMPLayer, models/dmpnn.py) with the
graph itself sharded:

  * the primal edges, and with them the edge stream [E, H], are split
    into contiguous blocks, one a rank (shard_flat_edges, as P("ep")
    cuts axis 0 on the JAX mesh);
  * the node table [V, H] is replicated on every rank;
  * a layer sums its local messages into the whole [V, H] table on K3
    (ops/scatter.SegmentSumRows, csrc/scatter_kernels.cu), and one
    parallel/dist.all_reduce_sum a layer completes the aggregation;
  * the out-degrees are counted once, on K3, as one column summed over
    the ranks.

The endpoint gathers go through ops/scatter.GatherRows, whose backward is
K3. JAX writes edge_msg as jnp.where(rev, a, b) of two differences, which
evaluates four gathers; here each edge selects its endpoints first
(where(rev, senders, receivers) for the dst table, the other for the
src table), the same rows in two gathers, so a layer's backward
launches K3 twice for them, not four times.

make_edge_parallel_train_step is the JAX demonstration step: the DistMult
BCE on the replicated node outputs, gradients to the layer parameters
and the relation table only, and an SGD update. It follows
parallel/dist.py's convention (each rank the whole loss, its backward
seeded with 1 / size, the gradients summed over the ranks), which gives
the one-device gradient, as the JAX step does on 1, 2 and 8 devices.

Parameters are a list of per-layer dicts of float32 tensors, the JAX
package's names and [in, out] layout: in/out/nloop_weight (node),
src/dst/eloop_weight (edge), nbias, ebias. world=None is the one-rank
path: no collective runs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import LEAKY_RELU_A
from ..ops.scatter import GatherRows, SegmentSumRows
from ..ops.scatter_kernels import segment_sum_unsorted
from ..utils.init import scaled, xavier_uniform
from .dist import World, all_reduce_grads, all_reduce_sum

Params = List[Dict[str, torch.Tensor]]

NODE_WEIGHTS = ("in_weight", "out_weight", "nloop_weight")
EDGE_WEIGHTS = ("src_weight", "dst_weight", "eloop_weight")


def pad_to_multiple(edges: Dict[str, np.ndarray], n_shards: int
                    ) -> Dict[str, np.ndarray]:
    """Pad flat edge arrays so E divides n_shards (mask marks real)."""
    e = len(edges["senders"])
    target = -(-e // n_shards) * n_shards
    pad = target - e

    def pad1(x, fill=0):
        return np.concatenate([x, np.full((pad,) + x.shape[1:], fill,
                                          x.dtype)])

    out = {k: pad1(v) for k, v in edges.items()}
    out["edge_mask"] = np.concatenate(
        [edges.get("edge_mask", np.ones(e, bool)), np.zeros(pad, bool)])
    return out


def init_edge_parallel_params(num_layers: int, hidden: int,
                              neigenv: float = 4.0, eeigenv: float = 4.0,
                              generator: Optional[torch.Generator] = None,
                              device="cuda") -> Params:
    """Xavier-uniform scaled by 1 / eigenvalue, zero biases: the law of
    DMPLayer's init and of the JAX function. The draws come from
    `generator` (a CPU torch.Generator; seed 0 where None), in the
    order in, out, nloop, src, dst, eloop of each layer."""
    gen = generator or torch.Generator().manual_seed(0)
    mk_n = scaled(xavier_uniform(1.0), 1.0 / neigenv)
    mk_e = scaled(xavier_uniform(1.0), 1.0 / eeigenv)
    params = []
    for _ in range(num_layers):
        layer = {k: mk_n((hidden, hidden), gen) for k in NODE_WEIGHTS}
        layer.update({k: mk_e((hidden, hidden), gen) for k in EDGE_WEIGHTS})
        layer["nbias"] = torch.zeros(hidden)
        layer["ebias"] = torch.zeros(hidden)
        params.append({k: v.to(device) for k, v in layer.items()})
    return params


def params_from_jax(layers: Sequence[Mapping[str, np.ndarray]],
                    device="cuda") -> Params:
    """The JAX package's parameters (a list of per-layer dicts of arrays,
    as its init_edge_parallel_params returns them) -> this module's, the
    same numbers as float32 tensors on `device`."""
    return [{k: torch.tensor(np.asarray(v), dtype=torch.float32,
                             device=device) for k, v in layer.items()}
            for layer in layers]


def shard_flat_edges(world: Optional[World], arrays: Mapping[str, np.ndarray],
                     device="cuda") -> Dict[str, torch.Tensor]:
    """This rank's contiguous block of axis 0 of every array (rank r the
    r-th of world.size equal blocks; every row without a world), as
    tensors on `device`: integer arrays int64 (K3's index type), bool
    arrays bool, the rest float32. Axis 0 must divide world.size
    (pad_to_multiple)."""
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if world is not None:
            if len(v) % world.size:
                raise ValueError(f"{k}: {len(v)} rows do not split over "
                                 f"{world.size} ranks; use pad_to_multiple")
            blk = len(v) // world.size
            v = v[world.rank * blk: (world.rank + 1) * blk]
        if v.dtype == bool or k in ("rev_flag", "edge_mask"):
            dtype = torch.bool
        elif np.issubdtype(v.dtype, np.integer):
            dtype = torch.int64
        else:
            dtype = torch.float32
        out[k] = torch.tensor(v, dtype=dtype, device=device)
    return out


def dmp_layer(params: Mapping[str, torch.Tensor], node: torch.Tensor,
              table: torch.Tensor, e: torch.Tensor, senders: torch.Tensor,
              receivers: torch.Tensor, rev: torch.Tensor,
              edge_mask: torch.Tensor, d: torch.Tensor,
              world: Optional[World] = None):
    """One DMP layer (edge_partition.py:73-106, halo.py:262-301) ->
    (n_out, e_out). node [N, H]: the rows the layer updates, into which
    the edges' messages sum at `receivers` (those >= N dropped);
    table [T, H]: the rows the edges' endpoints index (node itself, or
    the halo layer's composite table); e [E, H] the edge stream; rev and
    edge_mask [E] bool; d [E, 1] log2(1 + out-degree) of each edge's
    receiver. The aggregation sums over the ranks of `world` (none: it
    is local)."""
    hw_src = table @ params["src_weight"]
    hw_dst = table @ params["dst_weight"]
    edge_msg = (GatherRows.apply(hw_dst, torch.where(rev, senders, receivers))
                - GatherRows.apply(hw_src, torch.where(rev, receivers,
                                                       senders)))
    node_msg = torch.where(rev[:, None], e @ params["out_weight"],
                           -(e @ params["in_weight"]))
    node_msg = torch.where(edge_mask[:, None], node_msg, 0.0)
    agg = all_reduce_sum(
        SegmentSumRows.apply(node_msg, receivers, node.shape[0]), world)

    n_out = node @ params["nloop_weight"] + agg
    if "nbias" in params:
        n_out = n_out + params["nbias"]
    n_out = F.leaky_relu(n_out, LEAKY_RELU_A)

    add = 2.0 * (1.0 + d) * (
        e @ (params["src_weight"] - params["dst_weight"]))
    e_out = e @ params["eloop_weight"] + edge_msg + add
    if "ebias" in params:
        e_out = e_out + params["ebias"]
    return n_out, F.leaky_relu(e_out, LEAKY_RELU_A)


def edge_parallel_dmp_apply(params: Params, node_feat: torch.Tensor,
                            edge_feat: torch.Tensor, senders: torch.Tensor,
                            receivers: torch.Tensor, rev_flag: torch.Tensor,
                            edge_mask: torch.Tensor, num_nodes: int,
                            world: Optional[World] = None,
                            activation: str = "tanh_between"):
    """The edge-partitioned multi-layer DMP forward
    (make_edge_parallel_dmp_apply, edge_partition.py:50-127): node_feat
    [V, H] replicated, this rank's edge rows (shard_flat_edges) ->
    (node_out [V, H], the same on every rank; edge_out, this rank's
    rows). The pad edges' rows are computed as JAX computes them (their
    endpoints are node 0), not zeroed."""
    with torch.no_grad():
        partial = segment_sum_unsorted(edge_mask.float()[:, None], senders,
                                       num_nodes)
    out_deg = all_reduce_sum(partial, world)[:, 0]
    d = torch.log2(1.0 + out_deg).index_select(0, receivers)[:, None]
    h, e = node_feat, edge_feat
    for i, p in enumerate(params):
        h, e = dmp_layer(p, h, h, e, senders, receivers, rev_flag, edge_mask,
                         d, world)
        if activation == "tanh_between" and i < len(params) - 1:
            h, e = torch.tanh(h), torch.tanh(e)
    return h, e


def distmult_bce(h: torch.Tensor, w_relation: torch.Tensor,
                 samples: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean BCE of the DistMult scores of samples [S, 3] (src, rel,
    dst) against labels [S] (edge_partition.py:181-188); the three
    gathers' backward is K3."""
    # each column contiguous: K3 takes a contiguous index
    src, rel, dst = samples.t().contiguous()
    s = GatherRows.apply(h, src)
    r = GatherRows.apply(w_relation, rel)
    o = GatherRows.apply(h, dst)
    score = (s * r * o).sum(1)
    bce = (score.clamp_min(0) - score * labels
           + torch.log1p(torch.exp(-score.abs())))
    return bce.mean()


def edge_parallel_grads(params: Params, w_relation: torch.Tensor,
                        node_feat, edge_feat, senders, receivers, rev_flag,
                        edge_mask, samples, labels, num_nodes: int,
                        world: Optional[World] = None):
    """The DistMult BCE of the forward's node rows and its gradients with
    respect to the layer parameters and w_relation, the one-device
    gradients on every rank (parallel/dist.py's convention: each rank
    seeds its backward with 1 / size, the gradients are summed over the
    ranks) -> (loss, [per-layer dicts of gradients], w_relation's). The
    last layer's edge weights do not reach the loss: their gradients are
    zero, as JAX's."""
    leaves = [{k: v.detach().requires_grad_() for k, v in p.items()}
              for p in params]
    w = w_relation.detach().requires_grad_()
    h, _ = edge_parallel_dmp_apply(leaves, node_feat, edge_feat, senders,
                                   receivers, rev_flag, edge_mask, num_nodes,
                                   world)
    loss = distmult_bce(h, w, samples, labels)
    (loss / world.size if world is not None else loss).backward()
    flat = [t for p in leaves for t in p.values()] + [w]
    for t in flat:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    if world is not None:
        all_reduce_grads(flat, world)
    return (loss.detach(), [{k: v.grad for k, v in p.items()} for p in leaves],
            w.grad)


def make_edge_parallel_train_step(world: Optional[World], num_nodes: int,
                                  num_layers: int,
                                  lr: float = 1e-2) -> Callable:
    """The edge-partitioned DistMult training step
    (edge_partition.py:159-202) -> train_step(params, w_relation,
    node_feat, edge_feat, senders, receivers, rev_flag, edge_mask,
    samples, labels) -> (params, w_relation, loss): the new parameters
    (fresh tensors; the arguments are not changed) and the loss before
    the update, the same on every rank. Gradients go to the layer
    parameters and w_relation only (edge_parallel_grads); the update is
    SGD with rate lr."""

    def train_step(params, w_relation, *inputs):
        if len(params) != num_layers:
            raise ValueError(f"{len(params)} layers of parameters for a "
                             f"{num_layers}-layer step")
        loss, grads, g_rel = edge_parallel_grads(params, w_relation, *inputs,
                                                 num_nodes, world)
        with torch.no_grad():
            new = [{k: v - lr * g[k] for k, v in p.items()}
                   for p, g in zip(params, grads)]
            return new, w_relation - lr * g_rel, loss

    return train_step
