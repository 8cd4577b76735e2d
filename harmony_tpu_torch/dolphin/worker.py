"""WorkerTasklet — the training hot loop.

Counterpart of ``harmony_tpu/dolphin/worker.py``: per epoch, per mini-batch
one step

    PULL  (the batch's rows, or the whole model)
    COMP  (the trainer's compute: loss, gradient, delta)
    PUSH  (fold the delta into the table)

run through ``DenseTable.apply_step`` (or ``apply_step_with`` beside a
worker-local table), so the step and its commit happen under the table lock
while the push updates the storage in place. Three step modes:

  * fused (``TrainerParams.fused_step``, the default): PULL, COMP and PUSH are
    enqueued back to back with no host sync (``_step_core``);
  * unfused (:class:`_UnfusedStep`): three phases with the model traffic
    round-tripping through host memory and a sync at each boundary, with
    measured phase seconds; bit-identical losses;
  * async (:class:`AsyncStepDriver`, dense ``pull_mode="all"`` only): a comm
    thread runs PUSH and the next PULL while the training thread computes
    on the previous view, within ``staleness_bound`` deltas.

The epoch loop is the reference's. A stable epoch on the fused path runs from
a device-resident stack of the whole dataset (``_ensure_stacked_cache``,
uploaded once, kept in the process-level device cache under the data source):
each epoch enqueues every batch of the stack, epochs chain in windows of up
to ``EPOCH_WINDOW`` (``_epoch_window_len``: cut at comm-probe epochs, opened
only for a windowable trainer hook) with the hook run between them, and the
window makes ONE drain. Every other epoch (unfused, async, shuffling) is the
batched epoch: batches come from the device batch cache, the prefetch
pipeline (``dolphin/prefetch.py``) or the provider in line, at most
``MAX_INFLIGHT`` steps in flight. The comm probe (``_probe_comm``) times the
table's PULL and PULL+PUSH on the fused path at the first epoch and every
``8 x comm_probe_period`` epochs.

A hash-backed model table (``DeviceHashTable``) takes the keyed core
``_hash_pull_push``: getOrInit pull (K1 at the resolved slots), compute, the
trainer's ``mask_delta``, and the hash push (duplicates folded by K2), beside
a dense worker-local table where the trainer has one (sparse LDA). Its step
counts the keys the table refused in a ``_dropped`` metric, which stays on
the device and is drained into ``table.overflow_count`` with the epoch's
other metrics. A dense keyed table's ``mxu_auto`` route is resolved once by
the measured autotune (``table/autotune.py``).

Multi-tenancy and multi-worker jobs, as in the reference: a worker run by a
JobServer holds a ``TaskUnitClient`` (``runtime/taskunit.py``), so it takes
the batched epoch (``_use_fused_epoch``): each batch group runs in a COMP
unit (``_units_per_scope``), each metric drain in a NET unit, global init in
a CPU unit, and tenants interleave batch by batch; under contention at most
``CONTENDED_INFLIGHT`` steps are in flight (``_inflight_cap``). A COMP unit
gates the host's admission of a step's launches, not the card's occupancy.
A worker of a multi-worker job checks its SSP gate (``batch_barrier``, a
``dolphin/master.py::MiniBatchController``) before each batch; one worker
(the chief) runs the trainer's global init and the others wait for it at
``post_init_barrier``; under ``force_lockstep`` every dispatch happens in the
worker's turn of a ``DispatchTurnstile`` (``dispatch_turn``). A worker with
none of these, outside a JobServer, keeps the fused windows.

Per-batch primary metrics ("loss", else the trainer's ``objective_metric``)
stay on the device until the drain. Also here, for callers that drive a table
outside the worker (the ModelAccessor path): :class:`FusedSparseStep` and
:func:`accessor_async_step`. Not ported yet: a CUDA graph of the step or the
epoch, per-job streams, and the cross-epoch pre-spawn of the next epoch's
pipeline.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from harmony_tpu_torch.data import devcache
from harmony_tpu_torch.data.loader import StageRing
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.prefetch import PrefetchPipeline, StagedBatch
from harmony_tpu_torch.dolphin.trainer import Trainer, TrainerContext
from harmony_tpu_torch.metrics.tracer import Tracer
from harmony_tpu_torch.table import autotune
from harmony_tpu_torch.table.hashtable import DeviceHashTable
from harmony_tpu_torch.table.table import DenseTable
from harmony_tpu_torch.utils.platform import full_f32_matmuls, hard_sync


def _env_flag(var: str, default: bool) -> bool:
    """A 0/1 operator knob: unset keeps ``default``; "0", "false" and "off"
    turn it off, anything else on (the reference's reading)."""
    val = os.environ.get(var)
    if val is None:
        return bool(default)
    return val.strip().lower() not in ("0", "false", "off")


def _env_int(var: str, default: int) -> int:
    val = os.environ.get(var)
    if val is None:
        return int(default)
    try:
        return int(val.strip())
    except ValueError:
        return int(default)


def _sync(device: torch.device) -> None:
    """Wait for the work enqueued so far on the current stream (no-op on the
    CPU, whose operations finish before they return)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _dropped(token) -> torch.Tensor:
    """The keys a hash step's table refused, as an f32 device scalar."""
    return (~token[2]).sum().to(torch.float32)


def _roundtrip(value: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host round-trip of one phase boundary: a copy in host memory, then a
    copy back on ``device``. Always a new tensor, also on the CPU, so the
    result is a snapshot and never a view of a table's storage."""
    return value.detach().to("cpu", copy=True).to(device)


class _UnfusedStep:
    """The host-driven per-phase step (``TrainerParams.fused_step=False``).

    PULL, COMP and PUSH run as three separate phases with the MODEL traffic
    round-tripping through host memory between them, the reference's
    ModelAccessor shape (pull -> host -> compute -> host -> push). A
    worker-local table stays on the device. It is a callable with the fused
    step's signature, so it runs through the same apply_step/commit path. On
    a hash table (``is_hash``) PULL returns the new state, the rows and the
    token, PUSH the new state and the refused-key count, which joins the
    metrics as ``_dropped``.

    Phase seconds are measured on the host clock around each phase, which
    ends in a sync, and exposed by :meth:`mean_phase_seconds`. The FIRST call
    is left out of the means: it carries one-time work (kernel builds, the
    allocator's first blocks) inside the timed regions.
    """

    def __init__(self, pull_p: Callable, comp_p: Callable, push_p: Callable, *,
                 device: torch.device, uses_local: bool, keys_push: bool,
                 is_hash: bool = False) -> None:
        self._pull_p = pull_p
        self._comp_p = comp_p
        self._push_p = push_p
        self._device = device
        self._uses_local = uses_local
        self._keys_push = keys_push
        self._is_hash = is_hash
        self.pull_sec = 0.0
        self.comp_sec = 0.0
        self.push_sec = 0.0
        self.steps = 0
        self.timed_steps = 0

    def mean_phase_seconds(self) -> Tuple[float, float, float]:
        """(pull, comp, push) mean seconds a steady-state step, the round
        trips outside them (the first call left out)."""
        n = max(self.timed_steps, 1)
        return self.pull_sec / n, self.comp_sec / n, self.push_sec / n

    def _record(self, p_t: float, c_t: float, u_t: float) -> None:
        if self.steps > 0:
            self.pull_sec += p_t
            self.comp_sec += c_t
            self.push_sec += u_t
            self.timed_steps += 1
        self.steps += 1

    def _call_hash(self, state, larr, batch, hyper):
        dev = self._device
        t0 = time.perf_counter()
        if self._uses_local:
            state2, rows, token, lmodel = self._pull_p(state, larr, batch)
        else:
            state2, rows, token = self._pull_p(state, batch)
        _sync(dev)
        p_t = time.perf_counter() - t0
        rows_d = _roundtrip(rows, dev)
        t0 = time.perf_counter()
        if self._uses_local:
            delta, new_l, metrics = self._comp_p(rows_d, lmodel, batch, hyper)
        else:
            delta, metrics = self._comp_p(rows_d, batch, hyper)
        _sync(dev)
        c_t = time.perf_counter() - t0
        delta_d = _roundtrip(delta, dev)
        t0 = time.perf_counter()
        if self._uses_local:
            new, dropped = self._push_p(state2, larr, token, delta_d, new_l)
        else:
            new, dropped = self._push_p(state2, token, delta_d)
        _sync(dev)
        u_t = time.perf_counter() - t0
        self._record(p_t, c_t, u_t)
        return new, dict(metrics, _dropped=dropped)

    def __call__(self, *args):
        dev = self._device
        if self._uses_local:
            arr, larr, batch, hyper = args
        else:
            (arr, batch, hyper), larr = args, None
        if self._is_hash:
            return self._call_hash(arr, larr, batch, hyper)
        t0 = time.perf_counter()
        if self._uses_local:
            model, lmodel = self._pull_p(arr, larr)
        elif self._keys_push:
            model = self._pull_p(arr, batch)
        else:
            model = self._pull_p(arr)
        _sync(dev)
        p_t = time.perf_counter() - t0
        model_d = _roundtrip(model, dev)
        t0 = time.perf_counter()
        if self._uses_local:
            delta, new_l, metrics = self._comp_p(model_d, lmodel, batch, hyper)
        else:
            delta, metrics = self._comp_p(model_d, batch, hyper)
        _sync(dev)
        c_t = time.perf_counter() - t0
        delta_d = _roundtrip(delta, dev)
        t0 = time.perf_counter()
        if self._uses_local:
            new = self._push_p(arr, larr, delta_d, new_l)
        elif self._keys_push:
            new = self._push_p(arr, batch, delta_d)
        else:
            new = self._push_p(arr, delta_d)
        _sync(dev)
        u_t = time.perf_counter() - t0
        self._record(p_t, c_t, u_t)
        return new, metrics


class AsyncStepDriver:
    """Bounded-staleness async aggregation (``TrainerParams.async_step``).

    Runs the unfused phases (same math, same host round-trips: see
    :class:`_UnfusedStep`) but moves PUSH and the next PULL onto a comm
    thread, so they overlap the NEXT step's COMP on the training thread::

        train thread:  COMP(k) on view v_k -> submit delta_k -> COMP(k+1)
        comm thread:   PUSH(delta_k) ; PULL -> publish view k+1

    Deltas ride a FIFO :class:`~harmony_tpu_torch.data.loader.StageRing` with
    one consumer, so the table's update sequence is submission order.
    ``staleness_bound`` caps the lag a compute step may see: COMP of step k
    waits until the published view reflects at least ``k - bound`` applied
    deltas. Bound 0 serializes the pipeline and is bit-identical to the
    unfused step.

    The published view is a SNAPSHOT: the model through a host round-trip
    and a worker-local table as a device clone, never the live storage, which
    the comm thread's in-place push changes while COMP reads the view. The
    comm thread runs on the stream the training thread had when the driver
    was built (a new thread would start on the default stream), so the
    device orders the two threads' work on one stream by enqueue order, and
    no cross-stream event or device-wide synchronize is needed.

    ``drain()`` is the fence at every epoch end: it blocks until every
    submitted delta is applied and the view after it published, re-raising a
    comm-thread failure. ``max_lag`` and ``exposed_wait_sec`` (the compute
    thread's wait, past the first cycles) are kept.
    """

    JOIN_TIMEOUT = 10.0

    def __init__(self, inner: _UnfusedStep, *, bound: int, model_table,
                 local_table=None, job_id: str = "") -> None:
        if inner._keys_push:
            raise ValueError(
                "async step mode drives dense pull_mode='all' tables only (a "
                "keys-mode pull depends on the batch, and the published-view "
                "pipeline has no batch yet when it pulls)")
        self._pull_p = inner._pull_p
        self._comp_p = inner._comp_p
        self._push_p = inner._push_p
        self._uses_local = inner._uses_local
        self._device = inner._device
        self._bound = max(0, int(bound))
        self._table = model_table
        self._local = local_table
        self._job_id = job_id
        self._stream = (torch.cuda.current_stream(self._device)
                        if self._device.type == "cuda" else None)
        # _version counts deltas REFLECTED in the published view, _applied
        # those the comm thread has pushed; one condition guards both, the
        # view and the error slot
        self._cond = threading.Condition()
        self._version = -1  # -1: the initial view is not published yet
        self._applied = 0
        self._submitted = 0
        self._view: Optional[Tuple[Any, Any]] = None
        self._err: Optional[BaseException] = None
        self._ring = StageRing(cap_fn=lambda: self._bound + 1)
        self._thread: Optional[threading.Thread] = None
        self.pull_sec = 0.0
        self.comp_sec = 0.0
        self.push_sec = 0.0
        self.steps = 0
        self.timed_steps = 0
        self._comm_steps = 0
        self.max_lag = 0
        self.exposed_wait_sec = 0.0

    def _snapshot(self, model, lmodel):
        return (_roundtrip(model, self._device),
                None if lmodel is None else lmodel.clone())

    def _raise_pending(self) -> None:
        with self._cond:
            err = self._err
        if err is not None:
            raise RuntimeError(
                "async step comm thread failed; the in-flight window is lost")\
                from err

    def _publish_initial(self) -> None:
        """View v0: one PULL of the live table, where the synchronous step's
        first pull happens, on the training thread before the comm thread
        starts, under the table lock."""
        if self._uses_local:
            def init_fn(arr, larr):
                return (arr, larr), self._snapshot(*self._pull_p(arr, larr))

            view = self._table.apply_step_with(self._local, init_fn)
        else:
            def init_fn(arr):
                return arr, self._snapshot(self._pull_p(arr), None)

            view = self._table.apply_step(init_fn)
        with self._cond:
            self._version = 0
            self._view = view
            self._cond.notify_all()

    def _ensure_started(self) -> None:
        if self._thread is None:
            self._publish_initial()
            self._thread = threading.Thread(
                target=self._comm_loop, name=f"async-step-{self._job_id}",
                daemon=True)
            self._thread.start()

    def submit(self, *operands) -> Dict[str, torch.Tensor]:
        """One training step: staleness gate, COMP against the published
        view, the delta queued for the comm thread. ``operands`` follow the
        view in COMP's call: ``(batch, hyper)`` for the worker. Returns the
        step's metrics (device tensors: the epoch's drain reads them)."""
        self._raise_pending()
        self._ensure_started()
        k = self._submitted
        floor = k - self._bound  # the view must reflect >= this many applies
        t0 = time.perf_counter()
        view = None
        with self._cond:
            while self._err is None and self._version < max(floor, 0):
                self._cond.wait(0.05)
            if self._err is None:
                self.max_lag = max(self.max_lag, k - self._version)
                view = self._view
        wait_t = time.perf_counter() - t0
        self._raise_pending()
        if k > 1:
            # k = 1 waits out cycle 0's one-time work, left out as the
            # unfused step leaves out its first call
            self.exposed_wait_sec += wait_t
        model_d, lmodel = view
        t0 = time.perf_counter()
        if self._uses_local:
            delta, new_l, metrics = self._comp_p(model_d, lmodel, *operands)
        else:
            (delta, metrics), new_l = self._comp_p(model_d, *operands), None
        _sync(self._device)
        c_t = time.perf_counter() - t0
        if self.steps > 0:
            self.comp_sec += c_t
            self.timed_steps += 1
        self.steps += 1
        self._submitted = k + 1
        if not self._ring.put((k, delta, new_l)):
            self._raise_pending()
            raise RuntimeError("async step ring closed mid-training")
        return metrics

    def _comm_loop(self) -> None:
        scope = (torch.cuda.stream(self._stream) if self._stream is not None
                 else contextlib.nullcontext())
        try:
            with scope, torch.no_grad():
                while True:
                    item = self._ring.get()
                    if item is StageRing.DONE:
                        return
                    k, delta, new_l = item
                    delta_d = _roundtrip(delta, self._device)
                    timings: Dict[str, float] = {}

                    def timed(name, fn, *args):
                        t1 = time.perf_counter()
                        out = fn(*args)
                        _sync(self._device)
                        timings[name] = time.perf_counter() - t1
                        return out

                    if self._uses_local:
                        def cycle(arr, larr):
                            new = timed("push", self._push_p, arr, larr, delta_d,
                                        new_l)
                            pulled = timed("pull", self._pull_p, *new)
                            return new, self._snapshot(*pulled)

                        view = self._table.apply_step_with(self._local, cycle)
                    else:
                        def cycle(arr):
                            new_arr = timed("push", self._push_p, arr, delta_d)
                            pulled = timed("pull", self._pull_p, new_arr)
                            return new_arr, self._snapshot(pulled, None)

                        view = self._table.apply_step(cycle)
                    with self._cond:
                        self._applied = self._version = k + 1
                        self._view = view
                        if k > 0:
                            # cycle 0 carries one-time work: left out
                            self.push_sec += timings["push"]
                            self.pull_sec += timings["pull"]
                            self._comm_steps += 1
                        self._cond.notify_all()
        except BaseException as e:  # noqa: BLE001 - re-raised on submit/drain
            with self._cond:
                self._err = e
                self._cond.notify_all()
            # unblock a producer parked in ring.put
            self._ring.close()

    def mean_phase_seconds(self) -> Tuple[float, float, float]:
        """(pull, comp, push) mean seconds a steady-state step: the comm
        means measured on the comm thread (overlapping compute), comp on the
        training thread."""
        with self._cond:
            n_comm = max(self._comm_steps, 1)
            n_comp = max(self.timed_steps, 1)
            return (self.pull_sec / n_comm, self.comp_sec / n_comp,
                    self.push_sec / n_comm)

    def staleness_stats(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "bound": self._bound,
                "max_lag": int(self.max_lag),
                "exposed_wait_sec": self.exposed_wait_sec,
                "overlapped_comm_sec": self.pull_sec + self.push_sec,
                "applied": int(self._applied),
                "submitted": int(self._submitted),
            }

    def drain(self) -> None:
        """The fence: block until every submitted delta is APPLIED and the
        view after it published; re-raise a comm failure. Re-entrant."""
        if self._thread is None:
            self._raise_pending()
            return
        with self._cond:
            while self._err is None and self._applied < self._submitted:
                self._cond.wait(0.05)
        self._raise_pending()

    def shutdown(self) -> None:
        """Best-effort teardown: never raises."""
        t = self._thread
        self._thread = None
        self._ring.finish()
        self._ring.close()
        if t is not None:
            t.join(self.JOIN_TIMEOUT)


def accessor_async_step(table, compute_fn: Callable, *, staleness_bound: int = 0,
                        signature: Optional[Any] = None) -> AsyncStepDriver:
    """The bounded-staleness driver for ModelAccessor users (the host-driven
    path outside WorkerTasklet). Builds the dense pull_all / compute /
    push_all phases of ``table`` and returns an :class:`AsyncStepDriver`
    whose ``submit(*operands)`` computes against the published view while
    the previous step's PUSH and PULL run on the comm thread, within
    ``staleness_bound``. ``compute_fn(model, *operands)`` returns the delta,
    or ``(delta, metrics_dict)``. ``drain()`` is the fence. ``signature``
    names the compute's behaviour in the reference's program cache; the port
    compiles nothing, so it is accepted and unused."""
    if isinstance(table, DeviceHashTable):
        raise TypeError(
            "async step drives DenseTable workloads; hash-backed tables keep the "
            "synchronous keyed step")
    if not isinstance(table, DenseTable):
        raise TypeError(f"need a DenseTable, got {type(table).__name__}")
    spec = table.spec

    def comp_fn(model, *operands):
        out = compute_fn(model, *operands)
        if not (isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict)):
            out = (out, {})
        delta, metrics = out
        return delta, dict(metrics)

    inner = _UnfusedStep(spec.pull_all, comp_fn, spec.push_all, device=table.device,
                         uses_local=False, keys_push=False)
    return AsyncStepDriver(inner, bound=staleness_bound, model_table=table)


class WorkerTasklet:
    """Drives the training loop for one job on its table's device."""

    # Max epochs a window dispatches before its one drain.
    EPOCH_WINDOW = 8
    # Bound on steps a batched epoch enqueues without a device sync.
    MAX_INFLIGHT = 32
    # The bound under multi-tenant contention (see _inflight_cap).
    CONTENDED_INFLIGHT = 2
    # Target span of one contended COMP unit, seconds (see _units_per_scope).
    UNIT_SPAN_TARGET = 0.06
    # Calls of each probe program a probe makes: one warm-up, then the samples.
    PROBE_SAMPLES = 3

    def __init__(
        self,
        job_id: str,
        ctx: TrainerContext,
        trainer: Trainer,
        data: TrainingDataProvider,
        global_init: bool = True,
        batch_barrier: Optional[Callable[[int], bool]] = None,
        taskunit: Optional[Any] = None,
        post_init_barrier: Optional[Callable[[], Any]] = None,
        dispatch_turn: Optional[Callable[[], Any]] = None,
        epoch_callback: Optional[Callable[[int], None]] = None,
    ) -> None:
        self.job_id = job_id
        self.ctx = ctx
        self.trainer = trainer
        self.data = data
        self.device = ctx.model_table.device
        # exactly one worker of a job (the chief) runs the trainer's global
        # init: it writes the shared table, and N additive inits would add up
        # N-fold; post_init_barrier makes the others wait for it
        self.global_init = global_init
        self.post_init_barrier = post_init_barrier
        # batch_barrier(global_batch_idx) -> stop flag: the SSP gate of a
        # multi-worker job (MiniBatchController.make_barrier)
        self.batch_barrier = batch_barrier
        # TaskUnitClient under a JobServer (runtime/taskunit.py), else None
        self.taskunit = taskunit
        # a callable returning this worker's turnstile turn (lockstep jobs)
        self.dispatch_turn = dispatch_turn
        # host accounting after each epoch's drain, in epoch order (the
        # entity's progress tracker); it reads no table state, so windows
        # may defer it
        self.epoch_callback = epoch_callback
        self._pending_probe = False  # a probe deferred into the first batch turn
        self._global_batch_idx = 0
        # this worker's EWMA seconds a batch, sizing its batch groups
        self._own_batch_cost: Optional[float] = None
        params = ctx.params
        # the comm/comp split probe: first use, then every 8 x period epochs
        self.comm_probe_every = params.comm_probe_period
        self._next_probe = 0
        self._probe_pull: Optional[Callable] = None
        self._probe_pp: Optional[Callable] = None
        self._comm_probe_times = (0.0, 0.0)
        self._probes = 0
        # device copies of stable batches kept across epochs
        self.cache_device_batches = not data.is_shuffling
        self._batch_cache: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self._stacked_cache: Optional[Tuple[torch.Tensor, ...]] = None
        self._prefetch_on = bool(params.input_prefetch)
        # the process-wide operator knobs override the job's params
        self._fused_on = _env_flag("HARMONY_FUSED_STEP", params.fused_step)
        self._async_on = _env_flag("HARMONY_ASYNC_STEP", params.async_step)
        self._staleness_bound = max(
            0, _env_int("HARMONY_STALENESS_BOUND", params.staleness_bound))
        self._step: Any = None
        self._push_route: Optional[str] = None
        self._hyper_scalars: Dict[str, torch.Tensor] = {}
        self._input = {"prefetch_hits": 0, "prefetch_misses": 0, "pipelines": 0,
                       "staged": 0, "max_depth": 0, "producer_idle_sec": 0.0,
                       "consumer_stall_sec": 0.0, "produce_sec": 0.0,
                       "stage_sec": 0.0}

    # -- step construction ----------------------------------------------

    def _step_core(self, push_route: str) -> Callable:
        """The fused PULL/COMP/PUSH body, ``step(arr, batch, hyper) -> (arr,
        metrics)`` for ``DenseTable.apply_step``. The push updates ``arr`` in
        place.

        The reference pins an ``optimization_barrier`` between the phases so
        that XLA cannot fuse across them (``_phase_boundary``); eager PyTorch
        runs each phase as its own operations, so there is nothing to pin."""
        spec = self.ctx.model_table.spec
        trainer = self.trainer
        if self._is_hash():
            return self._hash_step_core()
        self._check_dense_layout()
        if trainer.uses_local_table:
            local_spec = self.ctx.local_table.spec

            def _step(arr, local, batch, hyper):
                model, lmodel = spec.pull_all(arr), local_spec.pull_all(local)  # PULL
                delta, new_local, metrics = trainer.compute_with_local(
                    model, lmodel, batch, hyper)                               # COMP
                return (spec.push_all(arr, delta),                             # PUSH
                        local_spec.write_all(local, new_local)), metrics

        elif trainer.pull_mode == "all":

            def _step(arr, batch, hyper):
                model = spec.pull_all(arr)                              # PULL
                delta, metrics = trainer.compute(model, batch, hyper)   # COMP
                return spec.push_all(arr, delta), metrics               # PUSH

        else:

            def _step(arr, batch, hyper):
                keys = trainer.pull_keys(batch)
                model = spec.pull(arr, keys)                            # PULL
                delta, metrics = trainer.compute(model, batch, hyper)   # COMP
                return spec.push(arr, keys, delta, via=push_route), metrics  # PUSH

        return _step

    def _is_hash(self) -> bool:
        return isinstance(self.ctx.model_table, DeviceHashTable)

    def _check_dense_layout(self) -> None:
        if self.trainer.uses_local_table and self.trainer.pull_mode != "all":
            raise ValueError(
                "a keyed pull beside a worker-local table needs a hash-backed model "
                "table (TableConfig.sparse)")

    def _hash_step_core(self) -> Callable:
        """The fused step on a hash-backed model table. The keyed core
        ``_hash_pull_push`` is getOrInit PULL, COMP, the trainer's
        ``mask_delta`` and the token PUSH; its metrics gain ``_dropped``, the
        keys the table refused (drained into ``table.overflow_count`` at the
        window's end, never read per step). Beside a worker-local table (sparse
        LDA: hash-backed topic-word counts, dense per-document assignments) the
        local table is pulled whole and written back."""
        spec = self.ctx.model_table.spec
        trainer = self.trainer
        if trainer.pull_mode != "keys":
            raise ValueError("hash-backed model tables need pull_mode='keys' "
                             "(pull_all over an unbounded key domain is undefined)")

        def _hash_pull_push(state, batch, compute):
            state, rows, token = spec.pull(state, trainer.pull_keys(batch))   # PULL
            delta, aux, metrics = compute(rows)                                # COMP
            delta = trainer.mask_delta(delta, token[2])
            state = spec.push(state, token, delta)                             # PUSH
            return state, aux, dict(metrics, _dropped=_dropped(token))

        if trainer.uses_local_table:
            local_spec = self.ctx.local_table.spec

            def _step(state, local, batch, hyper):
                lmodel = local_spec.pull_all(local)
                state, new_local, metrics = _hash_pull_push(
                    state, batch,
                    lambda rows: trainer.compute_with_local(rows, lmodel, batch, hyper))
                return (state, local_spec.write_all(local, new_local)), metrics

            return _step

        def _step(state, batch, hyper):
            def compute(rows):
                delta, metrics = trainer.compute(rows, batch, hyper)
                return delta, None, metrics

            state, _, metrics = _hash_pull_push(state, batch, compute)
            return state, metrics

        return _step

    def _build_hash_unfused(self) -> _UnfusedStep:
        """The per-phase step on a hash-backed model table: PULL returns the
        new state, the rows and the token; PUSH takes the token (no second
        probe) and returns the refused-key count with the new state."""
        spec = self.ctx.model_table.spec
        trainer = self.trainer
        if trainer.pull_mode != "keys":
            raise ValueError("hash-backed model tables need pull_mode='keys'")
        if trainer.uses_local_table:
            local_spec = self.ctx.local_table.spec

            def pull_fn(state, larr, batch):
                state2, rows, token = spec.pull(state, trainer.pull_keys(batch))
                return state2, rows, token, local_spec.pull_all(larr)

            comp_fn = trainer.compute_with_local

            def push_fn(state, larr, token, delta, new_l):
                state = spec.push(state, token, trainer.mask_delta(delta, token[2]))
                return (state, local_spec.write_all(larr, new_l)), _dropped(token)

        else:
            def pull_fn(state, batch):
                return spec.pull(state, trainer.pull_keys(batch))

            comp_fn = trainer.compute

            def push_fn(state, token, delta):
                state = spec.push(state, token, trainer.mask_delta(delta, token[2]))
                return state, _dropped(token)

        return _UnfusedStep(pull_fn, comp_fn, push_fn, device=self.device,
                            uses_local=trainer.uses_local_table, keys_push=True,
                            is_hash=True)

    def _build_unfused(self, push_route: str) -> _UnfusedStep:
        """The per-phase step: the fused step's three phases as separate
        callables (same math, other boundaries)."""
        if self._is_hash():
            return self._build_hash_unfused()
        self._check_dense_layout()
        spec = self.ctx.model_table.spec
        trainer = self.trainer
        keys_push = False
        if trainer.uses_local_table:
            local_spec = self.ctx.local_table.spec

            def pull_fn(arr, larr):
                return spec.pull_all(arr), local_spec.pull_all(larr)

            comp_fn = trainer.compute_with_local

            def push_fn(arr, larr, delta, new_l):
                return spec.push_all(arr, delta), local_spec.write_all(larr, new_l)

        elif trainer.pull_mode == "all":
            pull_fn = spec.pull_all
            comp_fn = trainer.compute
            push_fn = spec.push_all
        else:
            keys_push = True

            def pull_fn(arr, batch):
                return spec.pull(arr, trainer.pull_keys(batch))

            comp_fn = trainer.compute

            def push_fn(arr, batch, delta):
                return spec.push(arr, trainer.pull_keys(batch), delta, via=push_route)

        return _UnfusedStep(pull_fn, comp_fn, push_fn, device=self.device,
                            uses_local=trainer.uses_local_table,
                            keys_push=keys_push)

    def _resolve_push_route(self) -> Optional[str]:
        """The keyed push route of a dense table, ``mxu_auto`` resolved once by
        the measured autotune at this job's push size (on the card; the
        static gate on the CPU). None for a hash table, whose push has one
        route."""
        if self._is_hash():
            return None
        table = self.ctx.model_table
        via = table.push_via
        if via != "mxu_auto" or self.trainer.pull_mode != "keys":
            return via
        sample = tuple(torch.as_tensor(np.ascontiguousarray(a))
                       for a in self.data.first_rows(self.data.batch_size))
        nkeys = int(self.trainer.pull_keys(sample).shape[0])
        return autotune.choose_push_route(table.spec, table.device, nkeys, table=table)

    def _build_step(self) -> None:
        table = self.ctx.model_table
        if self._push_route is None:
            self._push_route = self._resolve_push_route()
        if self._async_mode():
            self._step = AsyncStepDriver(
                self._build_unfused(self._push_route), bound=self._staleness_bound,
                model_table=table, local_table=self.ctx.local_table,
                job_id=self.job_id)
        elif self._fused_on:
            self._step = self._step_core(self._push_route)
        else:
            self._step = self._build_unfused(self._push_route)

    def _fused_mode(self) -> bool:
        """Whether the step is the fused one (the async driver runs the
        unfused phases by construction and takes precedence)."""
        return self._fused_on and not self._async_mode()

    def _async_capable(self) -> bool:
        """Whether the async step can drive this job: dense pull_mode='all'
        tables only. A keyed or hash step pulls per-batch rows, and the
        published-view pipeline has no batch when it pulls."""
        if self._is_hash():
            return False
        return self.trainer.pull_mode == "all"

    def _async_mode(self) -> bool:
        """Whether the step runs the async driver; a job that asks for it but
        cannot keeps its step."""
        return self._async_on and self._async_capable()

    def _use_fused_epoch(self) -> bool:
        """A whole epoch runs from the device-resident stack only with no
        between-batch host decision (no SSP gate, no TaskUnit admission),
        stable batches and the fused step. Under a TaskUnit scheduler the
        batched epoch is kept so tenants interleave batch by batch (a fused
        window would hand one tenant the schedule for whole epochs)."""
        return (self.batch_barrier is None
                and self.taskunit is None
                and not self.data.is_shuffling
                and self._fused_mode())

    def _dispatch(self, batch: Tuple[torch.Tensor, ...],
                  hyper: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step on one device batch; returns its metrics (device
        tensors)."""
        step = self._step
        if isinstance(step, AsyncStepDriver):
            return step.submit(batch, hyper)
        table = self.ctx.model_table
        if self.trainer.uses_local_table:
            return table.apply_step_with(self.ctx.local_table, step, batch, hyper)
        return table.apply_step(step, batch, hyper)

    def _to_device(self, batch: Tuple[np.ndarray, ...]) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.as_tensor(np.ascontiguousarray(a), device=self.device)
                     for a in batch)

    def _hyper(self) -> Dict[str, torch.Tensor]:
        """The trainer's host hyper-parameters as float32 scalars on the device.
        The scalars persist and are set with ``fill_``, which passes the value
        as a kernel argument: no copy from the host, so no wait for the
        device. The fill is ordered after the steps already enqueued that read
        the old value."""
        out = {}
        for k, v in self.trainer.hyperparams().items():
            t = self._hyper_scalars.get(k)
            if t is None:
                t = self._hyper_scalars[k] = torch.empty(
                    (), dtype=torch.float32, device=self.device)
            out[k] = t.fill_(float(v))
        return out

    def _primary_key(self, metrics: Dict[str, torch.Tensor]) -> Optional[str]:
        """The one metric that is this job's progress scalar: "loss", else the
        trainer's ``objective_metric`` (LDA's "log_likelihood"), else none."""
        if "loss" in metrics:
            return "loss"
        om = self.trainer.objective_metric
        return om if om and om in metrics else None

    def _drain(self, epochs: List[List[Dict[str, torch.Tensor]]]) -> List[List[float]]:
        """The per-batch primary metrics of a run of epochs as host floats
        (0.0 for a trainer that reports none): ONE device read, which also
        waits for their device work to finish. A hash step's ``_dropped``
        counts ride the same read into ``table.overflow_count``."""
        flat = [m for ms in epochs for m in ms]
        key = self._primary_key(flat[0]) if flat else None
        drops = [m["_dropped"] for m in flat if "_dropped" in m]
        cols = ([m[key].detach().float() for m in flat] if key is not None else []) + drops
        if not cols:
            _sync(self.device)
            host: List[float] = []
        else:
            host = torch.stack(cols).cpu().tolist()
        values = host[:len(flat)] if key is not None else [0.0] * len(flat)
        dropped = int(sum(host[len(host) - len(drops):])) if drops else 0
        if dropped:
            self.ctx.model_table.count_dropped(dropped)
        out, off = [], 0
        for ms in epochs:
            out.append(values[off:off + len(ms)])
            off += len(ms)
        return out

    # -- the comm probe ---------------------------------------------------

    def _build_comm_probe(self) -> None:
        """PULL alone and PULL+PUSH of a zero delta, mirroring the step's
        table traffic; the step time less both is compute. The reference's
        probe programs do not donate the table, so the live buffer survives
        them. Here ``pull_all`` is a view and ``push_all`` adds in place, and
        a zero push is not a no-op (-0.0 + 0.0 is +0.0), so the PULL probe
        materializes a copy (as the reference's program writes its output)
        and the PULL+PUSH probe runs on a clone of the table (the reference's
        non-donating program writes a new table of the same size)."""
        spec = self.ctx.model_table.spec
        trainer = self.trainer
        if self._is_hash():
            # a hash pull inserts the keys it misses: both probes run on a copy
            # of the state (the size of the reference's non-donating output)
            def pull_fn(state, batch):
                scratch = tuple(t.clone() for t in state)
                return spec.pull(scratch, trainer.pull_keys(batch))[1]

            def pp_fn(state, batch):
                scratch = tuple(t.clone() for t in state)
                scratch, rows, token = spec.pull(scratch, trainer.pull_keys(batch))
                return spec.push(scratch, token, torch.zeros_like(rows))
        elif trainer.pull_mode == "all":
            def pull_fn(arr, batch):
                return spec.pull_all(arr).clone()

            def pp_fn(arr, batch):
                scratch = arr.clone()
                return spec.push_all(scratch, torch.zeros_like(spec.pull_all(scratch)))
        else:
            via = self._push_route

            def pull_fn(arr, batch):
                return spec.pull(arr, trainer.pull_keys(batch))

            def pp_fn(arr, batch):
                scratch = arr.clone()
                keys = trainer.pull_keys(batch)
                rows = spec.pull(scratch, keys)
                return spec.push(scratch, keys, torch.zeros_like(rows), via=via)

        self._probe_pull, self._probe_pp = pull_fn, pp_fn

    def _probe_batch(self) -> Tuple[torch.Tensor, ...]:
        """The probe's sample batch, the provider's first rows in stable
        order: batch 0 of the device-resident stack on the fused-epoch path
        (no upload), else a copy of ``first_rows``."""
        if self._use_fused_epoch():
            self._ensure_stacked_cache()
            return tuple(a[0] for a in self._stacked_cache)
        return self._to_device(self.data.first_rows(self.data.batch_size))

    def _probe_comm(self) -> None:
        """Time the probe programs on one batch under the table lock: one
        warm-up call, then the minimum of ``PROBE_SAMPLES`` calls, each
        ended by a sync. Stores ``(pull_s, push_s)``."""
        if self._probe_pull is None:
            self._build_comm_probe()
        batch = self._probe_batch()
        table = self.ctx.model_table

        def timed(fn, arr) -> float:
            def once() -> float:
                t0 = time.perf_counter()
                fn(arr, batch)
                _sync(self.device)
                return time.perf_counter() - t0

            once()  # warm-up
            return min(once() for _ in range(self.PROBE_SAMPLES))

        with table._lock:
            arr = table._step_state
            t_pull = timed(self._probe_pull, arr)
            t_pp = timed(self._probe_pp, arr)
        self._comm_probe_times = (t_pull, max(t_pp - t_pull, 0.0))
        self._probes += 1

    # -- windows ---------------------------------------------------------

    def _epoch_window_len(self, epoch: int, num_epochs: int) -> int:
        """How many consecutive epochs may dispatch before the next drain.

        >1 only on the fused path (an unfused or async step syncs every
        phase, so a window would only batch the drain) and with a windowable
        trainer hook (``Trainer._epoch_hook_windowable``). A window never
        crosses a comm-probe epoch: the probe measures the live table between
        dispatches. An SSP gate decides per batch: no window."""
        if self.batch_barrier is not None:
            return 1
        if not self._fused_mode():
            return 1
        if not Trainer._epoch_hook_windowable(self.trainer):
            return 1
        w = min(self.EPOCH_WINDOW, num_epochs - epoch)
        if self.comm_probe_every and self.global_init:
            if self._probe_pull is None:
                w = min(w, 1)  # a probe is due at this epoch boundary
            else:
                until = self._next_probe - epoch
                if until > 0:
                    w = min(w, until)
        return max(1, w)

    # -- the fused epoch ---------------------------------------------------

    def _devcache_key(self, tag) -> "tuple | None":
        """Key into the process-level device cache: None unless the provider
        carries a data-source identity."""
        if self.data.dataset_key is None:
            return None
        return (self.data.dataset_key, tag, str(self.device))

    def _ensure_stacked_cache(self) -> None:
        """The whole epoch on the device, ``[num_batches, batch, ...]`` for
        each array, uploaded once (or found in the device cache under the data
        source)."""
        if self._stacked_cache is not None:
            return
        gkey = self._devcache_key("stacked")
        hit = devcache.get(gkey)
        if hit is not None:
            self._stacked_cache = hit
            return
        batches = list(self.data.epoch_batches())
        self._stacked_cache = tuple(
            torch.as_tensor(np.stack([b[i] for b in batches])).to(self.device)
            for i in range(len(batches[0])))
        devcache.put(gkey, self._stacked_cache)

    def _enqueue_fused_window(self, first_epoch: int, k: int
                              ) -> List[List[Dict[str, torch.Tensor]]]:
        """Enqueue ``k`` epochs over the device-resident stack with no host
        sync: every batch a view ``stacked[i][b]``, the windowable trainer
        hook between epochs, the hyper-parameters set on the device."""
        stacked = self._stacked_cache
        out = []
        for j in range(k):
            hyper = self._hyper()
            out.append([self._dispatch(tuple(a[b] for a in stacked), hyper)
                        for b in range(self.data.num_mini_batches)])
            if j + 1 < k:
                self.trainer.on_epoch_finished(self.ctx, first_epoch + j)
        return out

    def _run_fused_epochs(self, first_epoch: int, k: int
                          ) -> Tuple[List[List[float]], float]:
        """``k`` fused epochs and ONE drain; returns each epoch's per-batch
        metrics and the window's seconds split evenly over its epochs. The
        stack is uploaded before the timer starts."""
        self._ensure_stacked_cache()
        t0 = time.perf_counter()
        losses = self._drain(self._enqueue_fused_window(first_epoch, k))
        return losses, (time.perf_counter() - t0) / k

    # -- the batched epoch ---------------------------------------------------

    def _prefetch_usable(self) -> bool:
        """Whether background staging may run: ``input_prefetch``. The
        reference also turns it off under pod turnstiles and on meshes that
        span processes, neither of which the port has."""
        return self._prefetch_on

    def _devcache_epoch_ready(self) -> bool:
        """True when EVERY batch of the (stable) epoch already has a
        device-resident copy: the epoch then skips host assembly and staging."""
        if not self.cache_device_batches:
            return False
        nb = self.data.num_mini_batches
        if len(self._batch_cache) == nb:
            return True
        return all(i in self._batch_cache or devcache.contains(self._devcache_key(i))
                   for i in range(nb))

    def _epoch_batch_stream(self, epoch: int):
        """One epoch's input as (batch_idx, host_batch | None, StagedBatch |
        None), the three input regimes behind one iterator:

          * device-cache hit: every batch is device-resident; no host work;
          * prefetched: a PrefetchPipeline assembles and stages the batches;
          * synchronous (``input_prefetch`` off): the provider in line.

        The caller closes the generator, which tears the producer down."""
        if self._devcache_epoch_ready():
            for i in range(self.data.num_mini_batches):
                yield i, None, None
            return
        if not self._prefetch_usable():
            for i, b in enumerate(self.data.epoch_batches()):
                yield i, b, None
            return
        pipeline = self._make_pipeline(epoch)
        try:
            for staged in pipeline:
                yield staged.index, staged.host, staged
        finally:
            pipeline.close()
            stats = pipeline.stats()
            inp = self._input
            inp["pipelines"] += 1
            inp["max_depth"] = max(inp["max_depth"], stats["max_depth"])
            for k in ("staged", "producer_idle_sec", "consumer_stall_sec",
                      "produce_sec", "stage_sec"):
                inp[k] += stats[k]

    def _make_pipeline(self, epoch: int) -> PrefetchPipeline:
        net_scope = None
        if self.taskunit is not None and self.ctx.num_workers == 1:
            # staging copies ride the fair queue as NET units, with an
            # interruptible admission wait (teardown must not hang on a grant
            # that can no longer arrive); single-worker jobs only: the quorum
            # matches per-worker unit sequences, and units timed by a producer
            # thread would misalign them across a multi-worker job's workers
            net_scope = lambda abort: self.taskunit.scope(  # noqa: E731
                "NET", abort=abort)
        skip = None
        if self.cache_device_batches:
            # a partly cached epoch stages only what is missing
            skip = lambda i: (  # noqa: E731
                i in self._batch_cache or devcache.contains(self._devcache_key(i)))
        return PrefetchPipeline(self.data, self.device, self._inflight_cap,
                                epoch=epoch, job_id=self.job_id, net_scope=net_scope,
                                skip_stage_fn=skip)

    def _host_batch(self, batch_idx: int, batch):
        """``batch`` when the stream carried it, else re-materialized from the
        provider (a stable epoch served by the caches)."""
        return batch if batch is not None else self.data.batch_at(batch_idx)

    def _cached_batch(self, batch_idx: int, batch) -> Tuple[torch.Tensor, ...]:
        """Device copy of one stable batch: the per-worker cache, then the
        process-level cache under the data source, else one upload into both.
        The per-worker cache is always kept, so a dataset over the global
        budget still uploads at most once a worker."""
        batch_dev = self._batch_cache.get(batch_idx)
        if batch_dev is not None:
            return batch_dev
        gkey = self._devcache_key(batch_idx)
        batch_dev = devcache.get(gkey)
        if batch_dev is None:
            batch_dev = self._to_device(self._host_batch(batch_idx, batch))
            devcache.put(gkey, batch_dev)
        self._batch_cache[batch_idx] = batch_dev
        return batch_dev

    def _dispatch_batch(self, batch_idx: int, batch, hyper,
                        staged: Optional[StagedBatch]) -> Dict[str, torch.Tensor]:
        batch_dev = staged.take() if staged is not None else None
        if batch_dev is not None:
            self._input["prefetch_hits"] += 1
            if self.cache_device_batches and batch_idx not in self._batch_cache:
                # later epochs (and resubmissions) skip host work
                self._batch_cache[batch_idx] = batch_dev
                devcache.put(self._devcache_key(batch_idx), batch_dev)
        else:
            if staged is not None:
                self._input["prefetch_misses"] += 1
            if self.cache_device_batches:
                batch_dev = self._cached_batch(batch_idx, batch)
            else:
                batch_dev = self._to_device(self._host_batch(batch_idx, batch))
        return self._dispatch(batch_dev, hyper)

    def _mark(self) -> Optional[torch.cuda.Event]:
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    # -- admission ---------------------------------------------------------

    def _taskunit_scope(self, kind: str):
        if self.taskunit is None:
            return contextlib.nullcontext()
        return self.taskunit.scope(kind)

    def _turn(self):
        """This worker's turnstile turn (lockstep jobs), else a no-op."""
        if self.dispatch_turn is None:
            return contextlib.nullcontext()
        return self.dispatch_turn()

    def _balanced_turns(self) -> bool:
        """True when this worker must take no-op turns to keep the cyclic
        turnstile's rotation aligned with a sibling's chief-only turns."""
        return self.dispatch_turn is not None and self.ctx.num_workers > 1

    def _inflight_cap(self) -> int:
        """Steps a batched epoch keeps in flight. Under contention a deep
        queue is the unfairness: another tenant's next unit would wait behind
        this job's whole backlog, so contended jobs keep it shallow."""
        if self.taskunit is not None and self.taskunit.contended():
            return self.CONTENDED_INFLIGHT
        return self.MAX_INFLIGHT

    def _units_per_scope(self) -> int:
        """Batches one COMP unit admits. One under an SSP gate (the gate is
        per batch) and for an uncontended tenant; under contention the group
        grows until a unit spans about ``UNIT_SPAN_TARGET`` seconds, stretched
        toward the largest peer unit (at most 0.5 s), at most 8 batches: a
        tenant pays about one peer unit's wait per own unit, so a cheap job
        crosses the schedule fewer times."""
        if self.batch_barrier is not None:
            return 1
        if self.taskunit is None or not self.taskunit.contended():
            return 1
        c = self._own_batch_cost
        if c is None:
            return 1
        target = self.UNIT_SPAN_TARGET
        peer = self.taskunit.peer_unit_cost()
        if peer:
            target = max(target, min(peer, 0.5))
        return max(1, min(8, int(target / max(c, 1e-6))))

    def _dispatch_epoch_batches(self, epoch: int
                                ) -> Tuple[List[Dict[str, torch.Tensor]], bool]:
        """One epoch's steps, enqueued with no drain. Before each batch the
        SSP gate (``batch_barrier``); each batch group in a COMP unit, whose
        scope admits the group's launches (the grant wait is not timed: its
        in-scope seconds are reported as the unit's cost); past
        ``_inflight_cap()`` outstanding steps each dispatch waits for the
        oldest one. Returns the steps' metrics and the gate's stop flag."""
        hyper = self._hyper()
        pending: List[Dict[str, torch.Tensor]] = []
        marks: List[Optional[torch.cuda.Event]] = []
        stop = False
        it = self._epoch_batch_stream(epoch)
        try:
            nxt = next(it, None)
            while nxt is not None and not stop:
                with self._turn():
                    if self._pending_probe:
                        # lockstep: the chief probes inside its first batch turn
                        self._pending_probe = False
                        self._probe_comm()
                    if self.batch_barrier is not None:
                        stop = self.batch_barrier(self._global_batch_idx)
                        if stop:
                            break
                    group = self._units_per_scope()
                    with self._taskunit_scope("COMP"):
                        t_scope = time.perf_counter()
                        done = 0
                        while nxt is not None and done < group:
                            batch_idx, batch, staged = nxt
                            t0 = time.perf_counter()
                            pending.append(
                                self._dispatch_batch(batch_idx, batch, hyper, staged))
                            marks.append(self._mark())
                            cap = self._inflight_cap()
                            if len(marks) >= cap and marks[len(marks) - cap] is not None:
                                marks[len(marks) - cap].synchronize()
                            dt = time.perf_counter() - t0
                            self._own_batch_cost = (
                                dt if self._own_batch_cost is None
                                else 0.5 * self._own_batch_cost + 0.5 * dt)
                            self._global_batch_idx += 1
                            done += 1
                            nxt = next(it, None) if done < group else None
                        if self.taskunit is not None:
                            self.taskunit.report_unit_cost(time.perf_counter() - t_scope)
                if not stop:
                    nxt = next(it, None)
        finally:
            it.close()
        return pending, stop

    def _run_batched_epochs(self, first_epoch: int, k: int
                            ) -> Tuple[List[List[float]], float, bool]:
        """``k`` batched epochs with the trainer hook between them and ONE
        drain, in a NET unit; the async driver's fence closes every epoch.
        Returns each epoch's per-batch metrics, the seconds split evenly and
        whether the SSP gate stopped the job."""
        t0 = time.perf_counter()
        epochs = []
        stop = False
        for j in range(k):
            pending, stop = self._dispatch_epoch_batches(first_epoch + j)
            epochs.append(pending)
            if isinstance(self._step, AsyncStepDriver):
                # every submitted delta applies before anything host-side
                # observes the table
                self._step.drain()
            if stop:
                break
            if j + 1 < k:
                self.trainer.on_epoch_finished(self.ctx, first_epoch + j)
        # the drain is a transfer: a NET unit under tenancy (taken only when
        # there is something to drain, as every worker of a job does alike)
        scope = (self._taskunit_scope("NET") if any(epochs)
                 else contextlib.nullcontext())
        with self._turn(), scope:
            losses = self._drain(epochs)
        return losses, (time.perf_counter() - t0) / max(len(epochs), 1), stop

    # -- the loop ---------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        ctx = self.ctx
        full_f32_matmuls()
        if self.global_init:
            # the chief resolves the keyed push route first: its timed pushes
            # run before any sibling dispatches (the siblings wait at the
            # post-init barrier, then find the route in the autotune's cache).
            # Outside any unit: on the card a unit would not keep a
            # co-tenant's kernels out of the measurement anyway
            self._push_route = self._resolve_push_route()
            # global init writes the shared table: a CPU unit under tenancy
            with self._turn(), self._taskunit_scope("CPU"):
                self.trainer.init_global_settings(ctx)
        elif self._balanced_turns() or self.taskunit is not None:
            # siblings take the SAME unit with an empty body: the quorum needs
            # every worker to wait on each (seq, kind), and the turnstile
            # matching turn counts
            with self._turn(), self._taskunit_scope("CPU"):
                pass
        if self.post_init_barrier is not None:
            self.post_init_barrier()
        self.trainer.on_training_start(ctx, 0)
        self._build_step()
        try:
            with torch.no_grad():  # compute takes its own gradient
                return self._run_epoch_loop()
        finally:
            if isinstance(self._step, AsyncStepDriver):
                self._step.shutdown()

    def _run_epoch_loop(self) -> Dict[str, Any]:
        ctx, params = self.ctx, self.ctx.params
        epoch_losses: List[float] = []
        batch_losses: List[float] = []
        epoch_seconds: List[float] = []
        windows: List[int] = []
        started = time.perf_counter()
        epoch = 0
        stop = False
        while epoch < params.num_epochs and not stop:
            if (self.comm_probe_every and self.global_init and self._fused_mode()
                    and (self._probe_pull is None or epoch >= self._next_probe)):
                self._next_probe = epoch + 8 * self.comm_probe_every
                if self.dispatch_turn is not None and not self._use_fused_epoch():
                    # lockstep: inside the first batch turn (a separate
                    # chief-only turn would skew the turnstile's rotation)
                    self._pending_probe = True
                else:
                    # a CPU unit in single-worker jobs only: the probe is
                    # chief-only, and a chief-only unit would misalign a
                    # multi-worker quorum's unit sequences
                    scope = (self._taskunit_scope("CPU") if ctx.num_workers == 1
                             else contextlib.nullcontext())
                    with self._turn(), scope:
                        self._probe_comm()
            window = self._epoch_window_len(epoch, params.num_epochs)
            if self._use_fused_epoch():
                losses, secs = self._run_fused_epochs(epoch, window)
            else:
                losses, secs, stop = self._run_batched_epochs(epoch, window)
                if stop and not losses[-1]:
                    losses.pop()  # stopped before any batch: not an epoch at all
            if losses:
                windows.append(len(losses))
            for epoch_batches in losses:
                batch_losses.extend(epoch_batches)
                epoch_losses.append(epoch_batches[-1] if epoch_batches else 0.0)
                epoch_seconds.append(secs)
            if losses:
                # the window's last hook runs after its drain
                self.trainer.on_epoch_finished(ctx, epoch + len(losses) - 1)
            for e in range(epoch, epoch + len(losses)):
                if self.epoch_callback is not None:
                    with self._turn():
                        self.epoch_callback(e)
                elif self._balanced_turns():
                    with self._turn():
                        pass
            epoch += window
        finished = time.perf_counter()
        self.trainer.cleanup(ctx)
        step = self._step
        mode = ("async" if isinstance(step, AsyncStepDriver)
                else "fused" if self._fused_on else "unfused")
        result = {
            "job_id": self.job_id,
            "epochs_run": len(epoch_losses),
            "losses": epoch_losses,
            "batch_losses": batch_losses,
            # a window's seconds split evenly over its epochs
            "epoch_seconds": epoch_seconds,
            # perf_counter at the first epoch's start and the last epoch's end
            "train_span": [started, finished],
            "step_mode": mode,
            # epochs of each drain, in order
            "windows": windows,
            "comm_probe": {"pull_s": self._comm_probe_times[0],
                           "push_s": self._comm_probe_times[1],
                           "probes": self._probes},
            "input": dict(self._input),
            # the keyed push's route (None: all-mode, or a hash table's one route)
            "push_route": self._push_route,
            # stopped by the SSP controller's stop broadcast
            "stopped_early": stop,
            # True: fused windows over the device stack; False: per-batch
            # epochs (TaskUnit admission, an SSP gate, or a step or provider
            # that needs them)
            "fused_epochs": self._use_fused_epoch(),
        }
        if self._is_hash():
            result["overflow_count"] = ctx.model_table.overflow_count
        if mode != "fused":
            result["phase_seconds"] = dict(zip(("pull", "comp", "push"),
                                               step.mean_phase_seconds()))
        if mode == "async":
            result["staleness"] = step.staleness_stats()
        return result

    # -- evaluation --------------------------------------------------------

    def evaluate(self, batch: Tuple[np.ndarray, ...]) -> Dict[str, float]:
        if self._is_hash():
            raise NotImplementedError(
                "full-model evaluate is undefined over an unbounded key domain; "
                "evaluate a sparse model through its keyed pull "
                "(FMTrainer.evaluate_sparse) or train with a dense table")
        model = self.ctx.model_table.pull_array()
        with torch.no_grad():
            metrics = self.trainer.evaluate(model, self._to_device(batch))
        return {k: float(v) for k, v in metrics.items()}


class FusedSparseStep:
    """One host-driven keyed pull -> compute -> push cycle on a ``DenseTable``,
    enqueued back to back with no host round trip.

    The ModelAccessor path (callers driving a table outside WorkerTasklet)
    pulls rows to the host, computes and pushes the delta back; this runs the
    cycle as the worker's fused step does, under ``DenseTable.apply_step``:
    the PULL is ``gather_rows`` (K1) and the PUSH folds duplicate keys by the
    table's route (K3 under ``mxu_auto`` and ``mxu``, K2 under ``sparse``).
    ``compute_fn(rows, *extra) -> (delta, aux)``.

    ``donate=True`` (the reference donates the table buffer) updates the
    storage in place; ``donate=False`` computes into a copy and commits it,
    so the pre-step tensor survives unchanged. Keys and extra operands are
    only read. ``signature`` names the compute's behaviour in the reference's
    program cache; the port compiles nothing, so it is accepted and unused.

    Phase charging is the accessor's fused contract: the whole step is COMP
    (``comp_tracer``)."""

    #: steps in flight before run_batches waits for the oldest
    MAX_INFLIGHT = 8

    def __init__(self, table, compute_fn: Callable, *, signature: Optional[Any] = None,
                 donate: bool = True, push_via: Optional[str] = None) -> None:
        if isinstance(table, DeviceHashTable):
            raise TypeError("FusedSparseStep drives DenseTable workloads; hash-backed "
                            "tables already fuse through WorkerTasklet's keyed step")
        if not isinstance(table, DenseTable):
            raise TypeError(f"need a DenseTable, got {type(table).__name__}")
        self.table = table
        self.push_route = push_via if push_via is not None else table.push_via
        self.donate = bool(donate)
        spec, route, donate = table.spec, self.push_route, self.donate

        def _step(arr, keys, *extra):
            target = arr if donate else arr.clone()
            rows = spec.pull(target, keys)                          # PULL
            delta, aux = compute_fn(rows, *extra)                   # COMP
            return spec.push(target, keys, delta, via=route), aux   # PUSH

        self._fn = _step
        self.comp_tracer = Tracer(instrument="accessor.comp")

    def _stage(self, batch: Tuple) -> Tuple[torch.Tensor, ...]:
        """One host batch ``(keys, *extra)`` on the table's device (keys as
        int32). Staged tensors are only read by the step."""
        keys, *extra = batch
        dev = self.table.device
        k = (keys.to(dev, torch.int32) if isinstance(keys, torch.Tensor)
             else torch.as_tensor(np.asarray(keys, dtype=np.int32), device=dev))
        return (k, *(torch.as_tensor(a, device=dev) for a in extra))

    def step(self, keys, *extra):
        """One fused step, committed; returns compute_fn's aux. Waits for the
        aux (the accessor's per-op shape), so the tracer charges the step's
        device time to COMP."""
        staged = self._stage((keys, *extra))
        self.comp_tracer.start()
        aux = self.table.apply_step(self._fn, *staged)
        self.comp_tracer.record(int(staged[0].shape[0]), block_on=aux)
        return aux

    def run_batches(self, batches, *, inflight: Optional[int] = None) -> List[Any]:
        """Drive host batches ``(keys, *extra)`` through the fused step, batch
        k+1 staged on a producer thread while batch k runs (at most
        ``inflight`` staged ahead, default 2), at most ``MAX_INFLIGHT`` steps
        in flight. Returns the per-batch aux, their device work finished."""
        cap = int(inflight) if inflight else 2
        ring = StageRing(lambda: cap)
        dev = self.table.device
        # a new thread starts on the default stream: stage on the caller's
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

        def produce() -> None:
            scope = (torch.cuda.stream(stream) if stream is not None
                     else contextlib.nullcontext())
            try:
                with scope:
                    for b in batches:
                        if not ring.put(self._stage(b)):
                            return
                ring.finish()
            except BaseException as e:  # noqa: BLE001 - raised at the consumer's get
                ring.set_error(e)

        t = threading.Thread(target=produce, daemon=True, name="fused-sparse-stage")
        t.start()
        auxes: List[Any] = []
        marks: List[Optional[torch.cuda.Event]] = []
        try:
            while True:
                item = ring.get()
                if item is StageRing.DONE:
                    break
                auxes.append(self.table.apply_step(self._fn, *item))
                if stream is not None:
                    ev = torch.cuda.Event()
                    ev.record(stream)
                    marks.append(ev)
                    if len(marks) >= self.MAX_INFLIGHT:
                        marks[len(marks) - self.MAX_INFLIGHT].synchronize()
        finally:
            ring.close()
            t.join(timeout=5.0)
        return hard_sync(auxes)
