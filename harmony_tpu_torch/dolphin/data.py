"""Training data provisioning: epoch = local partition, mini-batch = block.

Counterpart of ``harmony_tpu/dolphin/data.py``, kept byte-identical in what it
yields: both draw their shuffles from numpy ``default_rng(seed)``, so the same
arrays, batch count and seed give the same batches in the same order in both
packages. Batches are host numpy arrays; the worker moves them to the device.
"""
from __future__ import annotations

import threading
from typing import Iterator, List, Sequence, Tuple

import numpy as np


class TrainingDataProvider:
    """Splits an in-memory dataset into per-epoch mini-batches."""

    def __init__(
        self,
        arrays: Sequence[np.ndarray],
        num_mini_batches: int,
        shuffle_each_epoch: bool = False,
        seed: int = 0,
        dataset_key: "tuple | None" = None,
    ) -> None:
        # Identity of the DATA SOURCE (generator path + args + worker slice),
        # set by the job entity: stable batches with a key take part in the
        # process-level device cache (data/devcache.py), so a resubmitted job
        # reuses the device-resident copies. None: private data.
        self.dataset_key = dataset_key if not shuffle_each_epoch else None
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
        # Replay cursor of epoch_permutation: (next epoch, rng) of a SEPARATE
        # generator advanced only by explicit-epoch reads, so in-order reads
        # cost one draw each and the sequential iterator's rng is untouched.
        # One lock guards every shuffle draw: a prefetch producer thread and
        # the training thread must never interleave two draws.
        self._replay = (0, np.random.default_rng(seed))
        self._replay_lock = threading.Lock()

    @property
    def num_examples(self) -> int:
        return self.batch_size * self.num_mini_batches

    @property
    def is_shuffling(self) -> bool:
        return self._shuffle

    def _batches(self, epoch_arrays) -> Iterator[Tuple[np.ndarray, ...]]:
        for b in range(self.num_mini_batches):
            sl = slice(b * self.batch_size, (b + 1) * self.batch_size)
            yield tuple(a[sl] for a in epoch_arrays)

    def epoch_batches(self) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield ``num_mini_batches`` tuples of per-batch arrays. A shuffling
        epoch permutes each array once, then slices views; a stable epoch
        yields views of the dataset (consumers never write a batch)."""
        if self._shuffle:
            idx = np.arange(self.num_examples)
            with self._replay_lock:
                self._rng.shuffle(idx)
            epoch_arrays = [a[idx] for a in self._arrays]
        else:
            epoch_arrays = self._arrays
        yield from self._batches(epoch_arrays)

    def array_specs(self) -> List[Tuple[tuple, np.dtype]]:
        """Per-array (trailing shape, dtype): the batch structure without the
        batch axis."""
        return [(tuple(a.shape[1:]), a.dtype) for a in self._arrays]

    def first_rows(self, k: int) -> Tuple[np.ndarray, ...]:
        """The first ``k`` rows of each array in stable storage order (the
        comm probe's sample batch: real values, not shapes)."""
        return tuple(a[:k] for a in self._arrays)

    def epoch_permutation(self, epoch: int) -> np.ndarray:
        """The permutation ``epoch_batches()`` draws on its ``epoch``-th call
        (0-based), WITHOUT advancing the sequential iterator's rng: a pure
        function of ``(seed, epoch)``. In-order reads cost one draw each
        through the replay cursor; a backward read replays from the seed."""
        if not self._shuffle:
            raise ValueError("epoch_permutation is undefined without shuffle")
        with self._replay_lock:
            nxt, rng = self._replay
            if epoch < nxt:  # backward: replay from scratch
                nxt, rng = 0, np.random.default_rng(self.seed)
            idx = np.arange(self.num_examples)
            while True:
                perm = idx.copy()
                rng.shuffle(perm)
                nxt += 1
                if nxt > epoch:
                    break
            self._replay = (nxt, rng)
            return perm

    def epoch_batches_at(self, epoch: int) -> Iterator[Tuple[np.ndarray, ...]]:
        """``epoch_batches()`` for an EXPLICIT epoch index: the batch sequence
        of the sequential iterator's ``epoch``-th call, leaving the sequential
        rng untouched."""
        if self._shuffle:
            perm = self.epoch_permutation(epoch)
            epoch_arrays = [a[perm] for a in self._arrays]
        else:
            epoch_arrays = self._arrays
        yield from self._batches(epoch_arrays)

    def batch_at(self, b: int) -> Tuple[np.ndarray, ...]:
        """Batch ``b`` of the STABLE epoch order, defined only for providers
        that do not shuffle (a shuffled order lives in the epoch's draw)."""
        if self._shuffle:
            raise ValueError("batch_at is undefined for shuffling providers")
        if not 0 <= b < self.num_mini_batches:
            raise IndexError(f"batch {b} out of range")
        sl = slice(b * self.batch_size, (b + 1) * self.batch_size)
        return tuple(a[sl] for a in self._arrays)
