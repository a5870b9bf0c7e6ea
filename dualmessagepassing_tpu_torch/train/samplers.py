"""Bucket and curriculum batch samplers, host side
(dualmessagepassing_tpu/train/samplers.py, copied as numpy; the index
orders equal the JAX package's for the same seed and epoch).

Reference: SubgraphCountingMatching/utils/sampler.py:10-151.
  * BucketSampler — pad the index list to a multiple of batch_size with
    random extra samples, stable-sort by the group_by keys with a random
    tiebreak (re-seeded per epoch), slice consecutive batches, optionally
    shuffle the batch order.
  * CurriculumSampler — sort by learning_by, keep the easiest
    ceil(used_ratio * n), then bucket-sort the survivors.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class BucketSampler:
    def __init__(self, sizes: List[Dict[str, int]], group_by: Sequence[str],
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.sizes = sizes
        self.group_by = [group_by] if isinstance(group_by, str) else list(group_by)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        n = len(sizes)
        if drop_last:
            self.num_samples = max(0, math.ceil((n - batch_size) / batch_size)) * batch_size
        else:
            self.num_samples = math.ceil(n / batch_size) * batch_size

    def set_epoch(self, epoch: int = -1):
        self.epoch = self.epoch + 1 if epoch == -1 else epoch

    def __len__(self):
        return self.num_samples // self.batch_size

    @property
    def full_len(self) -> int:
        """Batches per epoch ignoring any curriculum subsetting — the
        reference's len(data_loader) (sampler.py:76-77), which its scalar
        schedules use as the per-epoch step clock (train.py:451-452)."""
        return self.num_samples // self.batch_size

    def _padded_indices(self, rng) -> np.ndarray:
        n = len(self.sizes)
        ind = np.arange(n)
        if not self.drop_last:
            pad = self.num_samples - n
            while pad > n:
                ind = np.concatenate([ind, np.arange(n)])
                pad -= n
            if pad > 0:
                ind = np.concatenate([ind, rng.permutation(n)[:pad]])
        else:
            ind = ind[: self.num_samples]
        return ind

    def _sort_keys(self, ind: np.ndarray, rng, keys: Sequence[str]) -> np.ndarray:
        cols = [np.asarray([self.sizes[i][k] for i in ind], np.float32)
                for k in keys]
        rand = rng.random(len(ind)).astype(np.float32)
        # np.lexsort sorts by the LAST key first
        return np.lexsort(tuple([rand] + cols[::-1]))

    def __iter__(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed + self.epoch)
        ind = self._padded_indices(rng)
        order = self._sort_keys(ind, rng, self.group_by)
        batches = [order[i: i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.shuffle:
            batches = [batches[i] for i in rng.permutation(len(batches))]
        for b in batches:
            yield ind[b]


class CurriculumSampler(BucketSampler):
    def __init__(self, sizes, learning_by, used_ratio: float, batch_size: int,
                 group_by=None, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        learning_by = ([learning_by] if isinstance(learning_by, str)
                       else list(learning_by))
        if group_by is None:
            group_by = learning_by
        super().__init__(sizes, group_by, batch_size, shuffle, seed, drop_last)
        self.learning_by = learning_by
        self.used_ratio = used_ratio

    def _curriculum_aligned(self) -> bool:
        """True when the learning keys are a prefix of the grouping keys —
        the curriculum cut then happens directly on the bucket order
        (ceil keep-count); otherwise a separate learn-sort precedes the
        bucket sort (int keep-count). Shared by __len__ and __iter__ so
        len(sampler) can never drift from the yielded batch count (the
        schedule clocks consume it)."""
        return (self.learning_by == self.group_by
                or self.learning_by == self.group_by[: len(self.learning_by)])

    def __len__(self):
        """Number of batches actually yielded under used_ratio.

        The reference inherits BucketSampler.__len__, which ignores
        used_ratio — but nothing there consumes len() for scheduling (its
        LR scheduler steps per yielded batch); our epoch loop does, so the
        honest count matters. The full-clock value remains available as
        .full_len for the reference's scalar-schedule step formula."""
        if self._curriculum_aligned():
            kept = math.ceil(self.used_ratio * self.num_samples)
        else:
            kept = int(self.used_ratio * self.num_samples)
        return math.ceil(kept / self.batch_size)

    def __iter__(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed + self.epoch)
        ind = self._padded_indices(rng)
        if self._curriculum_aligned():
            order = self._sort_keys(ind, rng, self.group_by)
            order = order[: math.ceil(self.used_ratio * len(order))]
        else:
            learn = self._sort_keys(ind, rng, self.learning_by)
            learn = learn[: int(self.used_ratio * len(learn))]
            sub = ind[learn]
            cols = [np.asarray([self.sizes[i][k] for i in sub], np.float32)
                    for k in self.group_by]
            rand = rng.random(len(sub)).astype(np.float32)
            order = learn[np.lexsort(tuple([rand] + cols[::-1]))]
        batches = [order[i: i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.shuffle:
            batches = [batches[i] for i in rng.permutation(len(batches))]
        for b in batches:
            yield ind[b]
