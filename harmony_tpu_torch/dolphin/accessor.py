"""ModelAccessor — the push/pull facade over a model table, with phase timing.

Counterpart of ``harmony_tpu/dolphin/accessor.py`` (the reference's
ModelAccessor / ETModelAccessor): pull = getOrInit against the model table,
push = update, with pull and push tracers. It serves the host-driven path:
callers that drive a table outside WorkerTasklet. :meth:`ModelAccessor.fused_step`
and :meth:`ModelAccessor.async_step` hand the same cycle to
``dolphin/worker.py``'s :class:`FusedSparseStep` and
:func:`accessor_async_step`, whose phases the accessor's tracers do not see
(a fused step has no separable phases; the async driver measures its own).

:class:`CachedModelAccessor` is the worker-side model cache (the reference's
CachedModelAccessor): pulls hit a local cache, pushes apply to the cache and
to the table, and a refresher thread re-pulls every cached key each period.
Per-key write versions keep a refresh that raced a push from overwriting the
pushed value (read-your-own-push).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Sequence

import numpy as np
import torch

from harmony_tpu_torch.metrics.tracer import Tracer


class ModelAccessor:
    def __init__(self, table) -> None:
        self._table = table
        self.pull_tracer = Tracer(instrument="accessor.pull")
        self.push_tracer = Tracer(instrument="accessor.push")

    def pull(self, keys: Sequence[int]) -> np.ndarray:
        self.pull_tracer.start()
        vals = self._table.multi_get_or_init(keys)
        self.pull_tracer.record(len(keys))
        return vals

    def pull_all(self) -> np.ndarray:
        self.pull_tracer.start()
        out = self._table.pull_array().cpu().numpy()
        self.pull_tracer.record(out.shape[0])
        return out

    def push(self, keys: Sequence[int], deltas: np.ndarray) -> None:
        self.push_tracer.start()
        self._table.multi_update(keys, deltas)
        self.push_tracer.record(len(keys))

    def fused_step(self, compute_fn, **kw) -> Any:
        """This accessor's pull -> compute -> push cycle as one fused step
        (``dolphin.worker.FusedSparseStep``); keyword arguments pass through.
        The whole step is charged to the step's own ``comp_tracer``; this
        accessor's pull and push tracers stay at zero."""
        from harmony_tpu_torch.dolphin.worker import FusedSparseStep

        return FusedSparseStep(self._table, compute_fn, **kw)

    def async_step(self, compute_fn, *, staleness_bound: int = 0,
                   signature: Any = None) -> Any:
        """The bounded-staleness variant (``dolphin.worker.accessor_async_step``):
        the driver's ``submit(*operands)`` computes against a published view
        while the previous step's push and pull run on a comm thread, waiting
        only when the lag would pass ``staleness_bound`` (0 is bit-identical to
        the synchronous cycle). ``drain()`` is the fence before any host read
        of the table. The driver measures its phases; this accessor's tracers
        stay at zero."""
        from harmony_tpu_torch.dolphin.worker import accessor_async_step

        return accessor_async_step(self._table, compute_fn,
                                   staleness_bound=staleness_bound, signature=signature)

    def get_and_reset_times(self) -> tuple:
        pull, push = self.pull_tracer.total_sec, self.push_tracer.total_sec
        self.pull_tracer.reset()
        self.push_tracer.reset()
        return pull, push


class CachedModelAccessor(ModelAccessor):
    """A model cache with a background refresh.

    Pulls hit the cache and load misses from the table; a push applies to the
    cache at once (the update fn's ``apply``) and to the table; every
    ``refresh_period_sec`` (0: never; call :meth:`refresh_now`) a refresher
    thread re-pulls every cached key, so cached values follow other writers'
    pushes. Reads between refreshes can miss other writers' pushes: the
    bounded staleness SSP already admits."""

    def __init__(self, table, refresh_period_sec: float = 0.5) -> None:
        super().__init__(table)
        self._cache: Dict[int, np.ndarray] = {}
        # Per-key write version: a refresh installs a fetched value only if no
        # local push landed between its table read and its install; else a
        # pre-push snapshot would overwrite the pushed cache entry.
        self._versions: Dict[int, int] = {}
        self._cache_lock = threading.Lock()
        self._refresh_period = refresh_period_sec
        self._stop = threading.Event()
        self._refresher: "threading.Thread | None" = None
        if refresh_period_sec > 0:
            self._refresher = threading.Thread(
                target=self._refresh_loop, name="model-cache-refresh", daemon=True)
            self._refresher.start()

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self._refresh_period):
            self.refresh_now()

    def refresh_now(self) -> None:
        """Re-pull every cached key (a deterministic refresh point)."""
        with self._cache_lock:
            keys = sorted(self._cache)
            versions = {k: self._versions.get(k, 0) for k in keys}
        if not keys:
            return
        fresh = self._table.multi_get_or_init(keys)
        with self._cache_lock:
            for k, v in zip(keys, fresh):
                if self._versions.get(k, 0) == versions[k]:
                    self._cache[k] = v
                # else a push raced this refresh: keep the newer local value;
                # the next refresh reads it back from the table

    def close(self) -> None:
        self._stop.set()
        if self._refresher is not None:
            self._refresher.join(timeout=2.0)

    def pull(self, keys: Sequence[int]) -> np.ndarray:
        self.pull_tracer.start()
        keys = [int(k) for k in keys]
        if not keys:
            out = np.asarray(self._table.multi_get_or_init([]))
            self.pull_tracer.record(0)
            return out
        with self._cache_lock:
            missing = [k for k in keys if k not in self._cache]
            versions = {k: self._versions.get(k, 0) for k in missing}
        overlay = {}
        if missing:
            loaded = self._table.multi_get_or_init(missing)
            with self._cache_lock:
                for k, v in zip(missing, loaded):
                    # a push that raced the load may postdate the loaded value:
                    # serve it to this call only and leave the key uncached
                    if self._versions.get(k, 0) == versions[k]:
                        self._cache[k] = v
                    else:
                        overlay[k] = v
        with self._cache_lock:
            out = np.stack([overlay[k] if k in overlay else self._cache[k] for k in keys])
        self.pull_tracer.record(len(keys))
        return out

    def push(self, keys: Sequence[int], deltas: np.ndarray) -> None:
        self.push_tracer.start()
        keys = [int(k) for k in keys]
        apply = self._table.spec.update_fn.apply
        with self._cache_lock:   # the local apply first: the cache sees its own push
            for k, d in zip(keys, np.asarray(deltas)):
                self._versions[k] = self._versions.get(k, 0) + 1
                if k in self._cache:
                    self._cache[k] = apply(torch.as_tensor(self._cache[k]),
                                           torch.as_tensor(d)).numpy()
        self._table.multi_update(keys, deltas)   # then the table, the authoritative copy
        self.push_tracer.record(len(keys))


def make_accessor(table, model_cache_enabled: bool = False,
                  refresh_period_sec: float = 0.5) -> ModelAccessor:
    """The accessor for a job's ``model_cache_enabled`` setting."""
    if model_cache_enabled:
        return CachedModelAccessor(table, refresh_period_sec)
    return ModelAccessor(table)
