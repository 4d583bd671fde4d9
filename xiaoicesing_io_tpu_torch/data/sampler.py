"""Frame-budget batch sampler with per-rank assignment: the JAX package's
``data/sampler.py:DistributedBatchSampler``.

Items are shuffled per epoch, sorted by size on a frame grid and packed
into batches capped by frames and items (:func:`~..utils.batch_by_size`).
The batches are dealt round-robin to ``num_replicas`` ranks; the leftover
batches go one each to the first ranks, and every other rank repeats one of
its own (``pad_batch_assignment``) so that all ranks take the same number
of steps, or the leftovers are dropped (``drop_last``).  Each rank's count
is then made a multiple of ``required_batch_count_multiple`` by repeating
batches.  Everything is drawn from ``numpy.random.default_rng(seed +
epoch)``, so for every ``(seed, epoch)`` each rank's batches equal those of
the JAX sampler's same rank, and every process can compute every rank's
batches (:meth:`BatchSampler.batches_at_step`) without communication.  At
one replica the batches are the whole epoch's.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..utils import batch_by_size


class BatchSampler:
    def __init__(self, dataset, max_batch_frames: int, max_batch_size: int,
                 num_replicas: int = 1, rank: int = 0,
                 required_batch_count_multiple: int = 1, sort_by_similar_size: bool = True,
                 shuffle_sample: bool = True, shuffle_batch: bool = False,
                 frame_count_grid: int = 6, seed: int = 0, drop_last: bool = False,
                 disallow_empty_batch: bool = True, pad_batch_assignment: bool = True):
        if rank >= num_replicas or rank < 0:
            raise ValueError(f"Invalid rank {rank} for num_replicas {num_replicas}")
        self.dataset = dataset
        self.max_batch_frames = max_batch_frames
        self.max_batch_size = max_batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.required_batch_count_multiple = required_batch_count_multiple
        self.sort_by_similar_size = sort_by_similar_size
        self.shuffle_sample = shuffle_sample
        self.shuffle_batch = shuffle_batch
        self.frame_count_grid = frame_count_grid
        self.seed = seed
        self.drop_last = drop_last
        self.disallow_empty_batch = disallow_empty_batch
        self.pad_batch_assignment = pad_batch_assignment
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
        if len(batches) < self.num_replicas and self.disallow_empty_batch:
            raise RuntimeError("There is not enough batch to assign to each node.")

        replicas = self.num_replicas
        floored_total = len(batches) // replicas * replicas
        if self.drop_last and len(batches) > floored_total:
            batches = batches[:floored_total]
            leftovers = []
        elif self.shuffle_batch:
            leftovers = (rng.permutation(len(batches) - floored_total) + floored_total).tolist()
        else:
            leftovers = list(range(floored_total, len(batches)))
        matrix = np.arange(floored_total).reshape(-1, replicas).transpose()
        if self.shuffle_batch:
            matrix = rng.permuted(matrix, axis=0)

        # every rank's assignment, on every process: the trainer's shape
        # agreement needs the other ranks' batches of each step
        multiple = self.required_batch_count_multiple
        assignments: List[List[int]] = []
        for rank in range(replicas):
            assignment = matrix[rank].tolist()
            floored = len(assignment)
            if rank < len(leftovers):
                assignment.append(leftovers[rank])
                floored += 1
            elif leftovers and self.pad_batch_assignment:
                if not assignment:  # an error only on the rank that has nothing
                    if rank == self.rank:
                        raise RuntimeError("Cannot pad empty batch assignment.")
                    assignments.append([])
                    continue
                assignment.append(assignment[self.epoch % floored])
            if multiple > 1 and len(assignment) % multiple:
                for i in range(math.ceil(len(assignment) / multiple) * multiple
                               - len(assignment)):
                    assignment.append(assignment[(i + self.epoch * multiple) % floored])
            assignments.append(assignment)
        self._all_batches = batches
        self._assignments = assignments
        self.batches = [list(batches[i]) for i in assignments[self.rank]]
        self._formed = (self.epoch, self.seed)

    def batches_at_step(self, step_idx: int) -> List[List[int]]:
        """Every rank's items at iteration ``step_idx`` (``[]`` for a rank
        past its end), the same on every process."""
        self._form_batches()
        return [list(self._all_batches[a[step_idx]]) if step_idx < len(a) else []
                for a in self._assignments]

    def __iter__(self):
        self._form_batches()
        return iter(self.batches)

    def __len__(self) -> int:
        self._form_batches()
        return len(self.batches)
