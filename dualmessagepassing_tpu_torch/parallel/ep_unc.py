"""Edge-partitioned execution of the UNC model
(dualmessagepassing_tpu/parallel/ep_unc.py): the whole UNCTrainModel —
every backbone, the update MLPs and their BatchNorms, the edge norm, the
DistMult loss and its three regularisers — with the edge stream split
over the ranks of a World and the node state replicated, the right
layout when V is much smaller than E.

Each rank holds an even share of the real edges of the receiver-sorted,
padded edge arrays, padded to e_max / size (shard_sub; EDGE_KEYS), and
its own K1/K2 plans over that share (attach_ep_csr_plans). The model
completes over the ranks, inside parallel/dist.split_rows, what the JAX
model psums over its 'ep' axis
(unc/model.py): the [V, H] aggregation of each layer, the out-degrees
where the batch does not carry them, the per-relation means, the
BatchNorm statistics and the regularisers' sums and counts. Every rank
then computes the same, replicated loss; make_ep_train_step seeds each
backward with 1 / size and sums the gradients over the ranks before the
update (parallel/dist.py), so the parameters stay equal on every rank.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..ops.segment_kernel import attach_csr_plan
from ..unc.model import UNCTrainModel, apply_unc_forward
from .dist import World, all_reduce_grads, split_rows

# the per-edge arrays of a padded subgraph, split over the ranks; every
# other entry (node arrays, samples, out_deg) is replicated
EDGE_KEYS = ("senders", "receivers", "edge_type", "rev_flag", "edge_mask",
             "edge_norm")


def pad_e_max(e_max: int, n_ranks: int) -> int:
    """The edge envelope rounded up to a multiple of the rank count."""
    return -(-e_max // n_ranks) * n_ranks


def shard_sub(padded: Dict[str, np.ndarray], world: World
              ) -> Dict[str, np.ndarray]:
    """This rank's part of a padded subgraph (unc/data.pad_subgraph):
    e_max / size rows of every EDGE_KEYS array, every other entry whole.
    The rank's rows are its even share of the real edges, in order (a
    receiver-sorted stream, its real edges a prefix), then pad rows from
    the pad tail up to e_max / size. The JAX package cuts the padded
    arrays into contiguous slices instead, which puts the pad tail on the
    last ranks: a PubMed batch fills about half its envelope, so at two
    ranks every real edge would land on rank 0. The sums over the ranks
    are the same either way. The edge envelope must divide the rank
    count (pad_e_max), as the JAX package's shard_sub demands
    (ep_unc.py:65-83)."""
    e = len(padded["senders"])
    if e % world.size:
        raise ValueError(f"e_max={e} not divisible by {world.size} ranks; "
                         f"use pad_e_max")
    k = e // world.size
    mask = np.asarray(padded["edge_mask"])
    n_real = int(mask.sum())
    if not mask[:n_real].all():
        raise ValueError("edge_mask must mark a prefix (pad_subgraph order)")
    per = -(-n_real // world.size)
    lo = min(world.rank * per, n_real)
    hi = min(lo + per, n_real)
    # the ranks before this one took `lo` real rows and r * k - lo pads
    pad = n_real + world.rank * k - lo
    rows = np.concatenate([np.arange(lo, hi),
                           np.arange(pad, pad + k - (hi - lo))])
    return {key: (np.asarray(v)[rows] if key in EDGE_KEYS else v)
            for key, v in padded.items()}


def attach_ep_csr_plans(shard: Dict[str, np.ndarray],
                        sender_plan: bool = False) -> Dict[str, np.ndarray]:
    """The K1/K2 plan of one rank's share (shard_sub's), the counterpart
    of the JAX package's attach_ep_scatter_plans (ep_unc.py:86-150).

    The share is a run of the receiver-sorted stream followed by pads,
    so attach_csr_plan's receiver plan over the full node range applies
    as it is: sk_rowptr [V+1] over the share's real edges, n_real their
    count. sender_plan=True (training) adds the sender plan of the share
    from a local stable sort of its real senders: a global sender order
    means nothing per rank (the JAX package's train_unc samples these
    batches with send_keys=False)."""
    shard = dict(shard)
    shard.pop("send_order", None)
    shard.pop("senders_sorted", None)
    if sender_plan:
        n_real = int(np.asarray(shard["edge_mask"]).sum())
        shard["send_order"] = np.argsort(
            np.asarray(shard["senders"])[:n_real], kind="stable"
        ).astype(np.int64)
    return attach_csr_plan(shard, sender_plan=sender_plan)


def make_ep_apply(model: UNCTrainModel, world: World,
                  amp: bool = False) -> Callable:
    """sub (this rank's planned shard, tensors on its device) -> the
    output tuple of an eval-mode forward: the node rows (and DMPNN's
    per-relation means) whole on every rank, the edge stream this
    rank's share (ep_unc.py:169-193)."""

    def fwd(sub):
        with torch.inference_mode(), split_rows(model, world):
            return apply_unc_forward(model, sub, amp=amp, train=False)

    return fwd


def make_ep_train_step(model: UNCTrainModel, optimizer, world: World,
                       amp: bool = False, generator=None) -> Callable:
    """sub -> loss, as unc/driver.make_unc_train_step, edge-partitioned
    (ep_unc.py:196-237): the full unsupervised loss (DistMult BCE plus
    reg_param times the regularisers), the same on every rank; each
    rank's backward seeded with 1 / world.size, the gradients summed
    over the ranks, then the optimizer's update. amp as
    apply_unc_forward's. Dropout acts on the replicated node rows: each
    rank's generator must draw what the others draw (the same seed)."""

    def step(sub):
        optimizer.zero_grad()
        with split_rows(model, world):
            out = apply_unc_forward(model, sub, amp=amp, train=True,
                                    generator=generator)
            loss = model.unsupervised_loss(
                out, sub["edge_type"], sub["edge_mask"], sub["samples"],
                sub["labels"], sub["sample_mask"], sub["node_mask"])
            (loss / world.size).backward()
        all_reduce_grads(optimizer.params, world)
        optimizer.step()
        return loss.detach()

    return step
