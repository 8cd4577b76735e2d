"""Training data provisioning: epoch = local partition, mini-batch = block.

Counterpart of ``harmony_tpu/dolphin/data.py``, kept byte-identical in what it
yields: both draw their shuffles from numpy ``default_rng(seed)``, so the same
arrays, batch count and seed give the same batches in the same order in both
packages. Batches are host numpy arrays; the worker moves them to the device.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np


class TrainingDataProvider:
    """Splits an in-memory dataset into per-epoch mini-batches."""

    def __init__(
        self,
        arrays: Sequence[np.ndarray],
        num_mini_batches: int,
        shuffle_each_epoch: bool = False,
        seed: int = 0,
    ) -> None:
        if not arrays:
            raise ValueError("need at least one data array")
        n = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n:
                raise ValueError("all data arrays must share leading dim")
        if num_mini_batches <= 0 or num_mini_batches > n:
            raise ValueError(f"bad num_mini_batches={num_mini_batches} for n={n}")
        # trim to an equal split so every batch has the same shape
        self.batch_size = n // num_mini_batches
        self.num_mini_batches = num_mini_batches
        self._arrays = [a[: self.batch_size * num_mini_batches] for a in arrays]
        self._shuffle = shuffle_each_epoch
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    @property
    def num_examples(self) -> int:
        return self.batch_size * self.num_mini_batches

    def epoch_batches(self) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield ``num_mini_batches`` tuples of per-batch arrays. A shuffling
        epoch permutes each array once, then slices views."""
        if self._shuffle:
            idx = np.arange(self.num_examples)
            self._rng.shuffle(idx)
            epoch_arrays = [a[idx] for a in self._arrays]
        else:
            epoch_arrays = self._arrays
        for b in range(self.num_mini_batches):
            sl = slice(b * self.batch_size, (b + 1) * self.batch_size)
            yield tuple(a[sl] for a in epoch_arrays)
