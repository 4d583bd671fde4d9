"""Frame-budget batch sampler: the JAX package's
``data/sampler.py:DistributedBatchSampler`` at one replica (the port trains
on one card).

Items are shuffled per epoch, sorted by size on a frame grid, packed into
batches capped by frames and items (:func:`~..utils.batch_by_size`), and
the batch count made a multiple of ``required_batch_count_multiple`` by
repeating batches.  Everything is drawn from
``numpy.random.default_rng(seed + epoch)``, so for every ``(seed, epoch)``
the batches equal those of the JAX sampler's single replica.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..utils import batch_by_size


class BatchSampler:
    def __init__(self, dataset, max_batch_frames: int, max_batch_size: int,
                 required_batch_count_multiple: int = 1, sort_by_similar_size: bool = True,
                 shuffle_sample: bool = True, frame_count_grid: int = 6, seed: int = 0,
                 allow_empty: bool = False):
        """``allow_empty``: an empty dataset gives no batch (validation)
        instead of raising (training)."""
        self.dataset = dataset
        self.max_batch_frames = max_batch_frames
        self.max_batch_size = max_batch_size
        self.required_batch_count_multiple = required_batch_count_multiple
        self.sort_by_similar_size = sort_by_similar_size
        self.shuffle_sample = shuffle_sample
        self.frame_count_grid = frame_count_grid
        self.seed = seed
        self.allow_empty = allow_empty
        self.epoch = 0
        self.batches: Optional[List[List[int]]] = None
        self._formed = None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._form_batches()

    def _form_batches(self) -> None:
        if self._formed == (self.epoch, self.seed):
            return
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.shuffle_sample:
            indices = rng.permutation(len(self.dataset))
            if self.sort_by_similar_size:
                grid = self.frame_count_grid
                sizes = (np.round(np.asarray(self.dataset.sizes)[indices] / grid) * grid
                         ).clip(grid, None)
                indices = indices[np.argsort(sizes, kind="mergesort")]
            indices = indices.tolist()
        else:
            indices = list(range(len(self.dataset)))
        batches = batch_by_size(indices, self.dataset.num_frames,
                                max_batch_frames=self.max_batch_frames,
                                max_batch_size=self.max_batch_size)
        if not batches and not self.allow_empty:
            raise RuntimeError("There is not enough batch to assign to each node.")
        order = list(range(len(batches)))
        multiple = self.required_batch_count_multiple
        if multiple > 1 and len(order) % multiple:
            n = len(batches)
            for i in range(math.ceil(n / multiple) * multiple - n):
                order.append((i + self.epoch * multiple) % n)
        self.batches = [list(batches[i]) for i in order]
        self._formed = (self.epoch, self.seed)

    def __iter__(self):
        self._form_batches()
        return iter(self.batches)

    def __len__(self) -> int:
        self._form_batches()
        return len(self.batches)
