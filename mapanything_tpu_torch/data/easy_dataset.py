"""Dataset composition DSL: ``ds1 + ds2``, ``N * ds``, ``N @ ds``.

A copy of ``mapanything_tpu/data/easy_dataset.py`` (:1-174), after the
reference's ``mapanything/datasets/base/easy_dataset.py:33-67`` (CatDataset
:365, MulDataset :172, ResizedDataset :246): concatenation, repetition, and
resize with resampling, all keeping the (scene, aspect-ratio, num-views)
tuple index that the batched samplers yield. ``ResizedDataset`` draws its
epoch's order from ``np.random.default_rng(epoch + 777)``, as the JAX package.
"""

from __future__ import annotations

import numpy as np


class EasyDataset:
    """Base providing the composition operators."""

    def __add__(self, other: "EasyDataset") -> "CatDataset":
        return CatDataset([self, other])

    def __rmul__(self, factor: int) -> "MulDataset":
        return MulDataset(factor, self)

    def __rmatmul__(self, factor: int) -> "ResizedDataset":
        return ResizedDataset(factor, self)

    def set_epoch(self, epoch: int):
        pass

    def set_seed_offset(self, offset: int):
        pass


class MulDataset(EasyDataset):
    """Artificially repeat a dataset ``multiplicator`` times (reference :172)."""

    def __init__(self, multiplicator: int, dataset: EasyDataset):
        assert multiplicator > 0 and len(dataset) > 0
        self.multiplicator = multiplicator
        self.dataset = dataset

    def __len__(self):
        return self.multiplicator * len(self.dataset)

    def __repr__(self):
        return f"{self.multiplicator}*{self.dataset!r}"

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            other = idx[1:]
            idx = idx[0]
            new_idx = (idx // self.multiplicator, *other)
            return self.dataset[new_idx]
        return self.dataset[idx // self.multiplicator]

    @property
    def _resolutions(self):
        return self.dataset._resolutions

    @property
    def num_views(self):
        return self.dataset.num_views

    def set_epoch(self, epoch: int):
        self.dataset.set_epoch(epoch)

    def set_seed_offset(self, offset: int):
        self.dataset.set_seed_offset(offset)


class ResizedDataset(EasyDataset):
    """Resize to ``new_size`` items by shuffled resampling (reference :246).

    Indices are re-randomized per epoch via set_epoch; repeated scenes get
    increasing seed offsets so repeated visits sample new view sets.
    """

    def __init__(self, new_size: int, dataset: EasyDataset):
        assert new_size > 0 and len(dataset) > 0
        self.new_size = new_size
        self.dataset = dataset
        self._idxs = None
        self.set_epoch(0)

    def __len__(self):
        return self.new_size

    def __repr__(self):
        size_str = str(self.new_size)
        for i in range((len(size_str) - 1) // 3):
            size_str = size_str[: -4 * i - 3] + "_" + size_str[-4 * i - 3 :]
        return f"{size_str} @ {self.dataset!r}"

    def set_epoch(self, epoch: int):
        rng = np.random.default_rng(seed=epoch + 777)
        base = len(self.dataset)
        n_repeats = (self.new_size + base - 1) // base
        idxs = np.concatenate(
            [rng.permutation(base) for _ in range(n_repeats)]
        )[: self.new_size]
        self._idxs = idxs
        self.dataset.set_epoch(epoch)

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            other = idx[1:]
            i = idx[0]
            # seed offset = repeat count, so repeated scenes differ
            self.dataset.set_seed_offset(i // len(self.dataset))
            return self.dataset[(self._idxs[i], *other)]
        self.dataset.set_seed_offset(idx // len(self.dataset))
        return self.dataset[self._idxs[idx]]

    @property
    def _resolutions(self):
        return self.dataset._resolutions

    @property
    def num_views(self):
        return self.dataset.num_views


class CatDataset(EasyDataset):
    """Concatenation of datasets (reference :365)."""

    def __init__(self, datasets):
        flat = []
        for ds in datasets:
            if isinstance(ds, CatDataset):
                flat.extend(ds.datasets)
            else:
                flat.append(ds)
        self.datasets = flat
        self._cum = np.cumsum([len(d) for d in flat])

    def __len__(self):
        return int(self._cum[-1])

    def __repr__(self):
        return " + ".join(repr(d) for d in self.datasets)

    def set_epoch(self, epoch: int):
        for d in self.datasets:
            d.set_epoch(epoch)

    def set_seed_offset(self, offset: int):
        for d in self.datasets:
            d.set_seed_offset(offset)

    def __getitem__(self, idx):
        other = ()
        if isinstance(idx, tuple):
            other = idx[1:]
            idx = idx[0]
        if not (0 <= idx < len(self)):
            raise IndexError()
        db_idx = int(np.searchsorted(self._cum, idx, "right"))
        prev = self._cum[db_idx - 1] if db_idx > 0 else 0
        local = int(idx - prev)
        ds = self.datasets[db_idx]
        return ds[(local, *other)] if other else ds[local]

    @property
    def _resolutions(self):
        r = self.datasets[0]._resolutions
        assert all(ds._resolutions == r for ds in self.datasets)
        return r

    @property
    def num_views(self):
        n = self.datasets[0].num_views
        assert all(
            np.array_equal(ds.num_views, n) for ds in self.datasets
        )
        return n
