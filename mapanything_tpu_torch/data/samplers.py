"""Batched samplers: one (aspect-ratio, num-views) feature shared by a batch.

Counterpart of ``mapanything_tpu/data/samplers.py`` (:1-184), after the
reference's ``mapanything/datasets/base/batched_sampler.py``:
BatchedRandomSampler (:33), BatchedMultiFeatureRandomSampler (:134) and
DynamicBatchedMultiFeatureRandomSampler (:244, the batch size of each batch
from a num-views -> images-per-device map). Each epoch draws from
``np.random.default_rng(epoch + 777)`` in the JAX package's order, so both
packages give the same index stream for every epoch, world size and rank.

They are ``torch.utils.data.Sampler``s (the dynamic one a batch sampler,
yielding lists of index tuples). ``world_size`` and ``rank`` come from the
caller, or, when they are None, from ``torch.distributed`` where a process
group is initialised (1 and 0 without one).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils.data import Sampler


def round_by(total: int, multiple: int, up: bool = False) -> int:
    if up:
        total = total + multiple - 1
    return (total // multiple) * multiple


def world_and_rank(world_size: Optional[int] = None, rank: Optional[int] = None) -> Tuple[int, int]:
    """The caller's world size and rank, else the initialised process group's, else (1, 0)."""
    group = torch.distributed.is_available() and torch.distributed.is_initialized()
    if world_size is None:
        world_size = torch.distributed.get_world_size() if group else 1
    if rank is None:
        rank = torch.distributed.get_rank() if group else 0
    return int(world_size), int(rank)


class BatchedRandomSampler(Sampler):
    """Yield (sample_idx, feat_idx) with the feature shared per batch (:33)."""

    def __init__(self, dataset, batch_size, pool_size, world_size=None, rank=None, drop_last=True):
        world_size, rank = world_and_rank(world_size, rank)
        self.batch_size = batch_size
        self.pool_size = pool_size
        self.len_dataset = n = len(dataset)
        self.total_size = round_by(n, batch_size * world_size) if drop_last else n
        assert world_size == 1 or drop_last
        self.world_size = world_size
        self.rank = rank
        self.epoch: Optional[int] = None

    def __len__(self):
        return self.total_size // self.world_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        seed = (self.epoch + 777) if self.epoch is not None else np.random.SeedSequence().entropy % (2**32)
        rng = np.random.default_rng(seed=seed)

        sample_idxs = np.arange(self.total_size)
        rng.shuffle(sample_idxs)

        n_batches = (self.total_size + self.batch_size - 1) // self.batch_size
        feat_idxs = rng.integers(self.pool_size, size=n_batches)
        feat_idxs = np.broadcast_to(feat_idxs[:, None], (n_batches, self.batch_size))
        feat_idxs = feat_idxs.ravel()[: self.total_size]
        idxs = np.c_[sample_idxs, feat_idxs]

        size_per_proc = self.batch_size * (
            (self.total_size + self.world_size * self.batch_size - 1)
            // (self.world_size * self.batch_size)
        )
        idxs = idxs[self.rank * size_per_proc : (self.rank + 1) * size_per_proc]
        yield from (tuple(int(v) for v in row) for row in idxs)


class BatchedMultiFeatureRandomSampler(Sampler):
    """Multiple per-batch shared features (:134): yields
    (sample_idx, feat_idx_1, ..., feat_idx_k)."""

    def __init__(self, dataset, batch_size, pool_sizes: Sequence[int],
                 world_size=None, rank=None, drop_last=True):
        world_size, rank = world_and_rank(world_size, rank)
        self.batch_size = batch_size
        self.pool_sizes = list(pool_sizes)
        self.len_dataset = n = len(dataset)
        self.total_size = round_by(n, batch_size * world_size) if drop_last else n
        assert world_size == 1 or drop_last
        self.world_size = world_size
        self.rank = rank
        self.epoch: Optional[int] = None

    def __len__(self):
        return self.total_size // self.world_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        seed = (self.epoch + 777) if self.epoch is not None else np.random.SeedSequence().entropy % (2**32)
        rng = np.random.default_rng(seed=seed)

        sample_idxs = np.arange(self.total_size)
        rng.shuffle(sample_idxs)

        n_batches = (self.total_size + self.batch_size - 1) // self.batch_size
        cols = [sample_idxs]
        for pool in self.pool_sizes:
            f = rng.integers(pool, size=n_batches)
            f = np.broadcast_to(f[:, None], (n_batches, self.batch_size))
            cols.append(f.ravel()[: self.total_size])
        idxs = np.stack(cols, axis=1)

        size_per_proc = self.batch_size * (
            (self.total_size + self.world_size * self.batch_size - 1)
            // (self.world_size * self.batch_size)
        )
        idxs = idxs[self.rank * size_per_proc : (self.rank + 1) * size_per_proc]
        yield from (tuple(int(v) for v in row) for row in idxs)


class DynamicBatchedMultiFeatureRandomSampler(Sampler):
    """Batch size chosen per batch from the scaling feature (:244).

    Yields lists of index tuples (whole batches: a ``batch_sampler``),
    dealt round-robin across processes.
    """

    def __init__(
        self,
        dataset,
        pool_sizes: Sequence[int],
        scaling_feature_idx: int = 0,
        feature_to_batch_size_map: Union[Dict[int, int], Callable, None] = None,
        world_size: Optional[int] = None,
        rank: Optional[int] = None,
        drop_last: bool = True,
    ):
        world_size, rank = world_and_rank(world_size, rank)
        self.pool_sizes = list(pool_sizes)
        self.scaling_feature_idx = scaling_feature_idx
        if not (0 <= scaling_feature_idx < len(self.pool_sizes)):
            raise ValueError("scaling_feature_idx out of range")
        self.feature_to_batch_size_map = feature_to_batch_size_map or {
            i: 1 for i in range(self.pool_sizes[scaling_feature_idx])
        }
        self.len_dataset = self.total_size = len(dataset)
        self.world_size = world_size
        self.rank = rank
        self.epoch: Optional[int] = None
        self.drop_last = drop_last

    def _batch_size_for(self, feat: int) -> int:
        m = self.feature_to_batch_size_map
        bs = m(feat) if callable(m) else m.get(feat, 1)
        return max(1, bs)

    def __len__(self):
        sizes = [
            self._batch_size_for(i)
            for i in range(self.pool_sizes[self.scaling_feature_idx])
        ]
        max_bs = max(sizes)
        total = self.total_size // max_bs
        if not self.drop_last and self.total_size % max_bs > 0:
            total += 1
        return total // self.world_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        seed = (self.epoch + 777) if self.epoch is not None else np.random.SeedSequence().entropy % (2**32)
        rng = np.random.default_rng(seed=seed)

        sample_idxs = np.arange(self.total_size)
        rng.shuffle(sample_idxs)

        target = len(self)
        yielded = 0
        idx = 0
        batch_idx = 0
        while idx < len(sample_idxs) and yielded < target:
            feat_idxs = [int(rng.integers(p)) for p in self.pool_sizes]
            bs = self._batch_size_for(feat_idxs[self.scaling_feature_idx])
            remaining = len(sample_idxs) - idx
            if remaining < bs:
                if self.drop_last:
                    break
                bs = remaining
            batch = [
                tuple([int(sample_idxs[idx + i])] + feat_idxs) for i in range(bs)
            ]
            idx += bs
            if batch and batch_idx % self.world_size == self.rank:
                yield batch
                yielded += 1
            batch_idx += 1
