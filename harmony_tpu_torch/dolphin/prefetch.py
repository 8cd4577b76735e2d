"""The asynchronous host-to-device input pipeline of the training loop.

Counterpart of ``harmony_tpu/dolphin/prefetch.py``. Input production is taken
off the training thread:

  * a PRODUCER thread owns one epoch of ``epoch_batches()``: the epoch's
    shuffle draw and the per-batch assembly run off the training thread, in
    the order of the synchronous path, so a fixed seed gives the same batch
    sequence bit for bit;
  * each assembled batch is STAGED: on the card, copied into a pinned host
    buffer from a small reusable pool, then sent to the device with a
    non-blocking copy on a copy stream of its own, with an event recorded
    behind it; on the CPU the same code copies into a host tensor;
  * staged batches wait in a bounded :class:`~harmony_tpu_torch.data.loader.
    StageRing` whose depth follows the worker's in-flight cap.

The consumer (:meth:`StagedBatch.take`) makes its stream wait on the
batch's event and marks the staged tensors as used on its stream
(``record_stream``), so the caching allocator does not hand their memory out
while a step may still read it. A pinned buffer is refilled only after the
copy that last read it has completed. Under a JobServer a single-worker job's
staging copies ride the TaskUnit fair queue as NET units (``net_scope``).
A reshard that moves the table's compute device demotes the epoch's pipeline
to host-only (:meth:`PrefetchPipeline.stop_staging`, called by the worker's
layout listener): the copies staged for the old device are dropped.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from harmony_tpu_torch.data.loader import StageRing
from harmony_tpu_torch.runtime.taskunit import TaskUnitAborted


@dataclasses.dataclass
class StagedBatch:
    """One prefetched batch: the host tuple plus (optionally) its staged
    device copy and the event its copy recorded (None on the CPU)."""

    index: int
    host: Tuple[np.ndarray, ...]
    device: Optional[Tuple[torch.Tensor, ...]]
    ready: Optional[torch.cuda.Event] = None

    def take(self) -> Optional[Tuple[torch.Tensor, ...]]:
        """The staged device copy, ordered before whatever the consumer's
        current stream runs next; None when the batch was not staged (the
        consumer places ``host`` itself)."""
        device = self.device
        if device is None or self.ready is None:
            return device
        stream = torch.cuda.current_stream(device[0].device)
        stream.wait_event(self.ready)
        for t in device:
            # allocated on the copy stream, read on the consumer's
            t.record_stream(stream)
        return device


class _PinnedSlot:
    """One reusable set of staging buffers and the event of the copy that
    last read them."""

    def __init__(self) -> None:
        self.buffers: Optional[List[torch.Tensor]] = None
        self.copied: Optional[torch.cuda.Event] = None

    def fill(self, host: Tuple[np.ndarray, ...], pin: bool) -> List[torch.Tensor]:
        if self.copied is not None:
            # the device copy that last read these buffers must have landed
            # before they are written again
            self.copied.synchronize()
        srcs = [torch.from_numpy(np.ascontiguousarray(a)) for a in host]
        if self.buffers is None:  # an epoch's batches share shapes and dtypes
            self.buffers = [torch.empty(s.shape, dtype=s.dtype, pin_memory=pin)
                            for s in srcs]
        for b, s in zip(self.buffers, srcs):
            b.copy_(s)
        return self.buffers


class PrefetchPipeline:
    """One epoch's background input producer.

    Construction starts the producer thread; iterate the pipeline to consume
    staged batches in order; ``close()`` (idempotent, also run when the
    worker's epoch stream ends) stops the producer and joins it.

    ``depth_fn`` is read on every put, so the ring tracks the worker's
    in-flight cap; ``net_scope`` (optional) is called with an abort predicate
    (true once the ring is closed) and returns a context manager: each
    staging copy runs in a NET unit whose admission wait stays interruptible,
    so teardown never hangs on a grant that cannot arrive; ``skip_stage_fn``
    (optional) suppresses the copy for
    batches that are already device-resident (an evicted cache entry must not
    re-send the whole epoch): those flow through host-only and the consumer's
    cache lookup serves them.
    """

    JOIN_TIMEOUT = 10.0
    # pinned buffer sets in rotation: enough for the copy of one batch to
    # overlap the filling of the next
    POOL = 2

    def __init__(
        self,
        provider: Any,
        device: torch.device,
        depth_fn: Callable[[], int],
        *,
        epoch: int = 0,
        job_id: str = "",
        net_scope: Optional[Callable[[Callable[[], bool]], Any]] = None,
        skip_stage_fn: Optional[Callable[[int], bool]] = None,
    ) -> None:
        self._provider = provider
        self._device = torch.device(device)
        self._net_scope = net_scope
        self._skip_stage_fn = skip_stage_fn
        self._ring = StageRing(depth_fn)
        self._host_only = False  # see stop_staging()
        cuda = self._device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self._device) if cuda else None
        self._pool = [_PinnedSlot() for _ in range(self.POOL)]
        self.produce_sec = 0.0  # host assembly (gather, slicing) seconds
        self.stage_sec = 0.0    # pinned fill and copy enqueue seconds
        self.dropped = 0        # staged device copies dropped before use
        self._thread = threading.Thread(
            target=self._produce, name=f"prefetch-{job_id or 'job'}-e{epoch}",
            daemon=True)
        self._thread.start()

    # -- producer side ---------------------------------------------------

    def _stage(self, idx: int, host: Tuple[np.ndarray, ...]) -> StagedBatch:
        slot = self._pool[idx % len(self._pool)]
        cuda = self._copy_stream is not None
        buffers = slot.fill(host, pin=cuda)
        scope = (torch.cuda.stream(self._copy_stream) if cuda
                 else contextlib.nullcontext())
        with scope:
            # copy=True: on the CPU the staged tensor must not alias the
            # buffer the next fill of this slot overwrites
            device = tuple(b.to(self._device, non_blocking=True, copy=True)
                           for b in buffers)
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
                slot.copied = ready
        return StagedBatch(idx, host, device, ready)

    def _produce(self) -> None:
        ring = self._ring
        try:
            it = enumerate(self._provider.epoch_batches())
            while True:
                t0 = time.perf_counter()
                nxt = next(it, None)
                self.produce_sec += time.perf_counter() - t0
                if nxt is None:
                    break
                idx, host = nxt
                if self._host_only or (self._skip_stage_fn is not None
                                       and self._skip_stage_fn(idx)):
                    # host-only: demoted (assembly goes on: it owns the
                    # epoch's draw) or already device-resident
                    if not ring.put(StagedBatch(idx, host, None)):
                        return
                    continue
                scope = (self._net_scope(self._closed) if self._net_scope is not None
                         else contextlib.nullcontext())
                t0 = time.perf_counter()
                with scope:
                    staged = self._stage(idx, host)
                self.stage_sec += time.perf_counter() - t0
                if not ring.put(staged):
                    return  # the consumer closed the epoch early
        except TaskUnitAborted:
            return  # the ring closed during an admission wait: quiet teardown
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
            ring.set_error(e)
        else:
            ring.finish()

    def _closed(self) -> bool:
        """The abort predicate of the NET admission wait."""
        return self._ring.closed

    # -- consumer side ---------------------------------------------------

    def __iter__(self) -> Iterator[StagedBatch]:
        while True:
            item = self._ring.get()
            if item is StageRing.DONE:
                return
            yield item

    def stop_staging(self) -> int:
        """Demote to host-only production: the producer keeps assembling
        batches (it owns the epoch's draw, so abandoning it would advance a
        seeded shuffle twice) but stops staging copies, and the copies
        already staged are dropped; the consumer places every batch itself.
        Returns the number of staged batches in the ring."""
        self._host_only = True
        box = [0]

        def drop(item: StagedBatch) -> None:
            if item.device is not None:
                box[0] += 1
            item.device = None
            item.ready = None

        n = self._ring.apply(drop)
        self.dropped += box[0]
        return n

    def close(self) -> None:
        """Stop the producer (idempotent) and join it: no thread is left
        behind. Safe at any point on the consumer's thread."""
        self._ring.close()
        self._thread.join(timeout=self.JOIN_TIMEOUT)

    @property
    def thread_alive(self) -> bool:
        return self._thread.is_alive()

    def stats(self) -> dict:
        r = self._ring
        return {
            "staged": r.staged,
            "max_depth": r.max_depth,
            "producer_idle_sec": r.producer_idle_sec,
            "consumer_stall_sec": r.consumer_stall_sec,
            "produce_sec": self.produce_sec,
            "stage_sec": self.stage_sec,
            "dropped_batches": self.dropped,
        }
