"""Data loaders: batched sampling, loading in worker processes, collation.

Counterpart of ``mapanything_tpu/data/loader.py`` (:1-182), after the
reference's ``mapanything/datasets/__init__.py`` (get_test_data_loader :29,
get_train_data_loader :140 with the dynamic batch sampler), on
``torch.utils.data.DataLoader``:

- ``batch_sampler`` is the dynamic sampler (the train loader) and
  ``collate_fn`` is ``collate_views``: each batch is a dict of stacked
  (B, V, ...) numpy arrays, as the JAX loader yields;
- ``num_workers`` worker processes (the JAX package's thread pool would hold
  the GIL through the port's Python PNG and JPEG decoders), forked at each
  epoch's ``iter``: they are not persistent, so the epoch that ``set_epoch``
  gives the dataset in this process reaches their copies. They run numpy and
  CPU torch only, never CUDA (the ``Trainer`` may have initialised it here);
- batches come out in the sampler's order, as from the JAX package's FIFO
  prefetcher, and a worker's exception is raised again here.
"""

from __future__ import annotations

from torch.utils.data import DataLoader

from mapanything_tpu_torch.data.base_dataset import collate_views
from mapanything_tpu_torch.data.samplers import (
    BatchedMultiFeatureRandomSampler,
    DynamicBatchedMultiFeatureRandomSampler,
)


def default_images_per_device_budget(max_views: int, images_per_batch: int, min_views: int = 2):
    """num-views feature -> batch size map keeping the images a device takes constant
    (the reference's images-per-GPU budget, e.g. 48 images: 24 views -> B=2, 4 views ->
    B=12). Feature idx 0 is ``min_views`` views: 2 for a variable view count (2 up to
    the dataset's), the count itself for a fixed one. The JAX package always takes 2,
    so a fixed 4 views there gets twice the images asked for."""

    def batch_size_for(num_views_idx: int) -> int:
        num_views = num_views_idx + min_views
        return max(1, images_per_batch // num_views)

    return batch_size_for


class _Items:
    """The dataset as the DataLoader indexes it: a sampler tuple (scene, aspect
    ratio, num views) cut to what the dataset takes (no num-views index for a
    fixed view count), as the JAX loader's ``_load_batch``."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, tup):
        if isinstance(self.dataset.num_views, int):
            tup = (tup[0], tup[1])
        return self.dataset[tup]


class MultiViewDataLoader:
    """Train loader: the dynamic batch sampler (``images_per_batch`` images a batch:
    B = images_per_batch // V), ``num_workers`` worker processes (0: load in this
    process; two batches in flight a worker), ``collate_views``. Yields dicts of
    stacked (B, V, ...) numpy arrays."""

    def __init__(
        self,
        dataset,
        images_per_batch: int = 8,
        num_workers: int = 4,
        world_size=None,
        rank=None,
    ):
        self.dataset = dataset
        num_ars = len(dataset._resolutions)
        views = [dataset.num_views] if isinstance(dataset.num_views, int) else list(dataset.num_views)
        self.sampler = DynamicBatchedMultiFeatureRandomSampler(
            dataset,
            pool_sizes=[num_ars, len(views)],
            scaling_feature_idx=1,
            feature_to_batch_size_map=default_images_per_device_budget(max(views), images_per_batch, min(views)),
            world_size=world_size,
            rank=rank,
        )
        self.num_workers = num_workers
        self.epoch = 0

    def __len__(self):
        return len(self.sampler)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.sampler.set_epoch(epoch)
        self.dataset.set_epoch(epoch)

    def __iter__(self):
        workers = dict(num_workers=self.num_workers, multiprocessing_context="fork") if self.num_workers else {}
        return iter(DataLoader(_Items(self.dataset), batch_sampler=self.sampler, collate_fn=collate_views,
                               **workers))


class _TestLoader:
    """Fixed-size batches with a per-batch shared aspect ratio (the reference's :29, :65)."""

    def __init__(self, dataset, batch_size: int, num_workers: int, world_size, rank):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.sampler = BatchedMultiFeatureRandomSampler(
            dataset, batch_size, [len(dataset._resolutions)], world_size=world_size, rank=rank
        )

    def __len__(self):
        return len(self.sampler) // self.batch_size

    def set_epoch(self, epoch):
        self.sampler.set_epoch(epoch)
        self.dataset.set_epoch(epoch)

    def __iter__(self):
        workers = dict(num_workers=self.num_workers, multiprocessing_context="fork") if self.num_workers else {}
        return iter(DataLoader(self.dataset, sampler=self.sampler, batch_size=self.batch_size, drop_last=True,
                               collate_fn=collate_views, **workers))


def get_test_data_loader(dataset, batch_size: int, num_workers: int = 4, world_size=None, rank=None):
    """Fixed-batch test loader with a per-batch shared aspect ratio: every full
    batch of ``batch_size`` samples in the sampler's order, collated."""
    return _TestLoader(dataset, batch_size, num_workers, world_size, rank)

