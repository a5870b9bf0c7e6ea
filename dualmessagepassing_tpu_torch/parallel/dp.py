"""Data parallelism over (pattern, graph) pair batches
(dualmessagepassing_tpu/parallel/dp.py:21-56).

The JAX package commits every batch leaf to a 'dp' axis-0 sharding and
the state replicated; GSPMD then runs the one logical program over the
whole batch. Here each rank collates and computes its own rows
(shard_rows, shard_batch) and the model completes what couples the rows
over the ranks (parallel/dist.py); replicate is rank 0's state written
to every rank.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .dist import World


def shard_rows(n: int, world: World, chunks: int = 1) -> Optional[np.ndarray]:
    """This rank's rows of an n-row batch, or None where n does not split
    into world.size equal shares of each of `chunks` equal microbatches
    (the batch is then computed whole on every rank, as the JAX package
    replicates a ragged batch). With chunks = 1 the rank's rows are its
    contiguous share of axis 0; with chunks = k > 1 they are its share of
    each microbatch, so that microbatch c of every rank together is the
    JAX step's microbatch c, rows c * n / k to (c + 1) * n / k."""
    if n % (world.size * chunks):
        return None
    m = n // chunks
    share = m // world.size
    lo = world.rank * share
    return np.concatenate([np.arange(c * m + lo, c * m + lo + share)
                           for c in range(chunks)])


def shard_batch(world: World, *batches):
    """Each batch (a GraphBatch, an EdgeSeqBatch or a tensor, batch on
    axis 0) cut to this rank's contiguous share of axis 0."""
    out = []
    for b in batches:
        n = b.shape[0] if torch.is_tensor(b) else b.batch_size
        if n % world.size:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{world.size} ranks")
        share = n // world.size
        rows = slice(world.rank * share, (world.rank + 1) * share)
        out.append(b[rows] if torch.is_tensor(b) else b.slice(rows))
    return tuple(out) if len(out) > 1 else out[0]


def replicate(world: World, tensors: Iterable[torch.Tensor]) -> None:
    """Rank 0's values of `tensors` (the same list on every rank) written
    in place on every rank."""
    for t in tensors:
        dist.broadcast(t.data, 0)
