"""Lightweight phase timing.

Counterpart of ``harmony_tpu/metrics/tracer.py`` (the reference's Dolphin
``Tracer``: start/record/avg), which ``dolphin/accessor.py`` uses for its pull
and push timers and ``FusedSparseStep`` for its step. Device work is enqueued
asynchronously, so ``record`` can first wait for the tensors a phase produced,
charging their device time to that phase: where the reference blocks on a jax
array, this waits for the CUDA stream of each tensor's card.
"""
from __future__ import annotations

import time
from typing import Any, Optional

from harmony_tpu_torch.utils.platform import hard_sync


class Tracer:
    def __init__(self, instrument: Optional[str] = None) -> None:
        #: the phase's name (the reference also feeds a metrics registry's
        #: histogram with it; the port has no registry yet)
        self.instrument = instrument
        self._t0: Optional[float] = None
        self.total_sec = 0.0
        self.count = 0
        self.elem_count = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def record(self, num_elems: int = 1, block_on: Any = None) -> float:
        """Stop the stopwatch; returns this span's seconds. ``block_on``: a
        tensor, or a tuple, list or dict of them, to wait for first, so that
        their device work counts in this phase and not the next."""
        if self._t0 is None:
            raise RuntimeError("record() without start()")
        if block_on is not None:
            hard_sync(block_on)
        dt = time.perf_counter() - self._t0
        self.total_sec += dt
        self.count += 1
        self.elem_count += num_elems
        self._t0 = None
        return dt

    def avg_sec(self) -> float:
        return self.total_sec / self.count if self.count else 0.0

    def throughput(self) -> float:
        """Elements per second over all recorded spans."""
        return self.elem_count / self.total_sec if self.total_sec > 0 else 0.0

    def reset(self) -> None:
        self.__init__(self.instrument)
