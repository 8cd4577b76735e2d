"""StageRing — the bounded staging ring of the input pipelines.

Counterpart of ``harmony_tpu/data/loader.py``'s ``StageRing``. The split
prefetch loader beside it is not ported: ``load_dataset`` and
``TableHandle.load`` read their splits in order with ``fetch_split``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Optional


class StageRing:
    """Bounded single-producer/single-consumer staging ring.

    ``cap_fn`` is re-evaluated on every put so the depth can track a live
    signal (the worker's in-flight cap); a cap decrease applies to new puts
    while already-staged items drain normally. ``close()`` (consumer side)
    unblocks the producer (its next put returns False) and drops staged
    items; a producer-side exception recorded with ``set_error`` re-raises at
    the consumer's ``get()`` AFTER the staged prefix drains, as an in-line
    iterator would fail mid-epoch.

    Counters (read after the run): ``producer_idle_sec``, producer time
    blocked on a full ring (the pipeline outran the consumer: good);
    ``consumer_stall_sec``, consumer time blocked on an empty ring (the
    pipeline is the bottleneck: bad); ``max_depth``, the high-water mark;
    ``staged``, total items that entered the ring.
    """

    DONE = object()  # returned by get() once the producer is done or closed

    def __init__(self, cap_fn: Callable[[], int]) -> None:
        self._cap_fn = cap_fn
        self._cond = threading.Condition()
        self._items: deque = deque()
        self._closed = False
        self._finished = False
        self._error: Optional[BaseException] = None
        self.producer_idle_sec = 0.0
        self.consumer_stall_sec = 0.0
        self.max_depth = 0
        self.staged = 0

    def _space(self) -> bool:
        return self._closed or len(self._items) < max(1, int(self._cap_fn()))

    def put(self, item: Any) -> bool:
        """Stage one item; blocks while the ring is at its cap. Returns False
        once the consumer closed the ring (stop producing)."""
        with self._cond:
            if not self._space():
                t0 = time.perf_counter()
                self._cond.wait_for(self._space)
                self.producer_idle_sec += time.perf_counter() - t0
            if self._closed:
                return False
            self._items.append(item)
            self.staged += 1
            self.max_depth = max(self.max_depth, len(self._items))
            self._cond.notify_all()
            return True

    def get(self) -> Any:
        """Next staged item, ``StageRing.DONE`` at end of stream, or the
        producer's exception re-raised (after the staged items drained)."""
        with self._cond:
            if not self._items and not (self._finished or self._closed):
                t0 = time.perf_counter()
                self._cond.wait_for(
                    lambda: self._items or self._finished or self._closed)
                self.consumer_stall_sec += time.perf_counter() - t0
            if self._items:
                item = self._items.popleft()
                self._cond.notify_all()
                return item
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            return self.DONE

    def finish(self) -> None:
        """Producer side: end of stream."""
        with self._cond:
            self._finished = True
            self._cond.notify_all()

    def set_error(self, exc: BaseException) -> None:
        """Producer side: record a failure for the consumer to re-raise."""
        with self._cond:
            self._error = exc
            self._finished = True
            self._cond.notify_all()

    def close(self) -> None:
        """Consumer side: abort the stream (early stop, worker teardown)."""
        with self._cond:
            self._closed = True
            self._items.clear()
            self._cond.notify_all()

    def apply(self, fn: Callable[[Any], None]) -> int:
        """Run ``fn`` over every staged item under the lock; returns the
        count."""
        with self._cond:
            for item in self._items:
                fn(item)
            return len(self._items)

    def depth(self) -> int:
        with self._cond:
            return len(self._items)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed
