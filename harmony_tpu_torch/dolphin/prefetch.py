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
    StageRing` whose depth follows the worker's in-flight cap;
  * on a mesh with data rows (``rows``: each row's compute device) a batch
    is staged cut over the rows, each row's part copied to its own device on
    that device's copy stream (a :class:`~harmony_tpu_torch.dolphin.rows.
    RowBatch`), so the step copies no batch between cards; on a pod only
    this process's rows (a row of another process has no device here).

The consumer (:meth:`StagedBatch.take`) makes its stream wait on the
batch's event and marks the staged tensors as used on its stream
(``record_stream``), so the caching allocator does not hand their memory out
while a step may still read it. A pinned buffer is refilled only after the
copy that last read it has completed. Under a JobServer a single-worker job's
staging copies ride the TaskUnit fair queue as NET units (``net_scope``).
A reshard that moves the table's compute device demotes the epoch's pipeline
to host-only (:meth:`PrefetchPipeline.stop_staging`, called by the worker's
layout listener): the copies staged for the old device are dropped, and
counted in the registry's ``harmony_input_dropped_total{reason="demote"}``.
At its close an epoch's pipeline reports an ``InputPipelineMetrics``
(:meth:`PrefetchPipeline.report`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from harmony_tpu_torch.data.loader import StageRing
from harmony_tpu_torch.dolphin.rows import RowBatch, row_bounds
from harmony_tpu_torch.metrics.collector import InputPipelineMetrics
from harmony_tpu_torch.runtime.taskunit import TaskUnitAborted


@dataclasses.dataclass
class StagedBatch:
    """One prefetched batch: the host tuple plus (optionally) its staged
    device copy (a tuple, or a RowBatch cut over the data rows) and the
    events its copies recorded, one a device (None on the CPU)."""

    index: int
    host: Tuple[np.ndarray, ...]
    device: Optional[Any]
    ready: Optional[List[torch.cuda.Event]] = None

    def take(self) -> Optional[Any]:
        """The staged device copy, ordered before whatever the consumers'
        current streams run next; None when the batch was not staged (the
        consumer places ``host`` itself)."""
        device = self.device
        if device is None or self.ready is None:
            return device
        parts = ([p for p in device.parts if p is not None] if isinstance(device, RowBatch)
                 else [device])
        for part, ready in zip(parts, self.ready):
            stream = torch.cuda.current_stream(part[0].device)
            stream.wait_event(ready)
            for t in part:
                # allocated on the copy stream, read on the consumer's
                t.record_stream(stream)
        return device


class _PinnedSlot:
    """One reusable set of staging buffers and the events of the copies that
    last read them."""

    def __init__(self) -> None:
        self.buffers: Optional[List[torch.Tensor]] = None
        self.copied: List[torch.cuda.Event] = []

    def fill(self, host: Tuple[np.ndarray, ...], pin: bool) -> List[torch.Tensor]:
        for ev in self.copied:
            # the device copies that last read these buffers must have landed
            # before they are written again
            ev.synchronize()
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
        rows: Optional[Sequence[torch.device]] = None,
    ) -> None:
        self._provider = provider
        self._device = torch.device(device)
        # each data row's compute device, None for a row of another process
        # (None: whole batches on ``device``)
        self._rows = list(rows) if rows else None
        self._net_scope = net_scope
        self._skip_stage_fn = skip_stage_fn
        self._ring = StageRing(depth_fn)
        self._host_only = False  # see stop_staging()
        cuda = self._device.type == "cuda"
        targets = [d for d in self._rows if d is not None] if self._rows else [self._device]
        # a copy stream on each device a batch is staged on
        self._copy_streams = ({d: torch.cuda.Stream(d) for d in targets}
                              if cuda else None)
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
        cuda = self._copy_streams is not None
        buffers = slot.fill(host, pin=cuda)
        n = buffers[0].shape[0]
        if self._rows is None:
            cuts = [(self._device, buffers)]
        else:
            bounds = row_bounds(n, len(self._rows))
            cuts = [(d, [b[bounds[r]:bounds[r + 1]] for b in buffers])
                    for r, d in enumerate(self._rows)]
        parts, ready = [], [] if cuda else None
        for dev, bufs in cuts:
            if dev is None:
                parts.append(None)
                continue
            scope = (torch.cuda.stream(self._copy_streams[dev]) if cuda
                     else contextlib.nullcontext())
            with scope:
                # copy=True: on the CPU the staged tensor must not alias the
                # buffer the next fill of this slot overwrites
                parts.append(tuple(b.to(dev, non_blocking=True, copy=True) for b in bufs))
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record(self._copy_streams[dev])
                    ready.append(ev)
        if cuda:
            slot.copied = ready
        device = parts[0] if self._rows is None else RowBatch(parts, n, lambda: host)
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
        already staged are dropped; the consumer places every batch itself,
        on the rows of the layout it steps on (a staged :class:`RowBatch`
        holds this process's rows of the old one, and its host arrays).
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
        if box[0]:
            try:
                from harmony_tpu_torch.metrics.registry import get_registry

                get_registry().counter(
                    "harmony_input_dropped_total",
                    "Staged input batches whose device copies were "
                    "dropped before use, by reason (reshard "
                    "invalidation / host-only demotion)",
                    ("reason",),
                ).labels(reason="demote").inc(box[0])
            except Exception:
                pass  # metrics are an observer, never a dependency
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

    def report(self, job_id: str, worker_id: str, epoch: int, hits: int,
               misses: int) -> InputPipelineMetrics:
        """This epoch's input-pipeline record from :meth:`stats`, with the
        consumer's prefetch ``hits`` and ``misses`` (staged copies taken, and
        staged batches placed anew)."""
        s = self.stats()
        return InputPipelineMetrics(
            job_id=job_id, worker_id=worker_id, epoch_idx=epoch,
            staged_batches=s["staged"], prefetch_hits=hits, prefetch_misses=misses,
            max_depth=s["max_depth"], produce_sec=s["produce_sec"],
            stage_sec=s["stage_sec"], producer_idle_sec=s["producer_idle_sec"],
            consumer_stall_sec=s["consumer_stall_sec"],
            dropped_batches=s["dropped_batches"])
