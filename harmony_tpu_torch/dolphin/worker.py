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
``8 x comm_probe_period`` epochs. The epoch callback runs after its epoch's
drain, in epoch order; one that must see each epoch's own table (a
checkpoint chain, ``defer_epoch_callback=False``) keeps every window at one
epoch. A run resumed from a chain starts at ``starting_epoch``.

A hash-backed model table (``DeviceHashTable``) takes the keyed core
``_hash_pull_push``: getOrInit pull (K1 at the resolved slots), compute, the
trainer's ``mask_delta``, and the hash push (duplicates folded by K2), beside
a dense worker-local table where the trainer has one (sparse LDA). Its step
counts the keys the table refused in a ``_dropped`` metric, which stays on
the device and is drained into ``table.overflow_count`` with the epoch's
other metrics. A dense keyed table's ``mxu_auto`` route is resolved once by
the measured autotune (``table/autotune.py``).

A model table over a mesh of several slots (a ``ShardedArray``) takes the
same steps, its pulls and pushes going shard by shard, and computes on the
mesh's first slot; on a mesh with a data axis > 1 the step is
:class:`_DataParallelStep` (the batch split over the data rows, each row's
part staged on its row's compute slot by the device caches and the prefetch
ring: a ``dolphin/rows.py::RowBatch``), beside a worker-local table too.

The table may be resharded while the worker trains (``TableHandle.move_blocks``
from the job's optimizer loop or a plan). Every step runs under the table lock
on the layout the table holds then (:meth:`WorkerTasklet._layout_step`): a
step built for another compute device, number of data rows or placement of
the rows over a pod's processes is rebuilt there, and a batch staged on
another device (or for other data rows) is copied to the new one; a row
this process never staged comes from the batch's host arrays
(``RowBatch.restage``). The worker listens to the table's announcements:
when the target computes on another device, or its data rows on others, the
epoch's prefetch pipeline stops staging (its staged copies are dropped) and,
at the next dispatch, the worker's device caches follow the table and
re-stage by the new rows (``_follow_layout``). The result's ``data_rows``
lists the rows this process computed, by epoch once a move changed them.

Under a JobServer the worker has a ``MetricCollector``: each drain emits one
``BatchMetrics`` a batch, at the window's seconds smeared over its batches
(the clock the drain already reads: no sync is added) with the comm probe's
pull/push split (the unfused phases' measured split where they run), and
``op_stats`` counts its pulls, pushes and pulled bytes for the entity's
``ServerMetrics``.

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

On a table whose mesh spans the processes of a pod (the reference's
multi-process branches; a data axis > 1 included, each process computing
and staging only its own rows, the rows' results crossing in
``_DataParallelStep``'s row exchange): every dispatch region (global init,
the probe, each fused epoch, each batch group of 8 batches, each drain and
epoch callback) runs in the job's pod unit (``dispatch_turn``), so that
every process enters its collectives in the same order as its peers; the
step stays fused and never runs the async driver; the probe is skipped when several workers
dispatch with no turnstile; a contended grant (``pod_contended``, read at a
unit's exit, the same in every process) shrinks the windows to one epoch and
the batch groups to one batch; and ``mxu_auto`` is resolved by the static
size gate, not by the measured autotune (a timing in each process could pick
two routes).

The ``worker.step`` fault site (``faults/plan.py``; keys ``job``, ``worker``,
``batch`` and ``proc``) comes before every step's dispatch, on the fused and
the batched route alike: a ``crash`` rule there kills the process mid-epoch,
as the pod's recovery tests and ``chip_smoke.py`` arm it.

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

from harmony_tpu_torch import faults
from harmony_tpu_torch.data import devcache
from harmony_tpu_torch.data.loader import StageRing
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.prefetch import PrefetchPipeline, StagedBatch
from harmony_tpu_torch.dolphin.rows import (
    RowBatch,
    RowExchange,
    RowInput,
    row_bounds,
    row_devices,
    run_split,
    stage_rows,
    stage_stack_rows,
)
from harmony_tpu_torch.dolphin.trainer import Trainer, TrainerContext
from harmony_tpu_torch.jobserver.elastic import attempt_key
from harmony_tpu_torch.metrics import accounting, phases
from harmony_tpu_torch.metrics.collector import BatchMetrics, MetricCollector
from harmony_tpu_torch.metrics.registry import (
    EPOCH_TIME_BUCKETS,
    STEP_TIME_BUCKETS,
    get_registry,
)
from harmony_tpu_torch.parallel import multihost
from harmony_tpu_torch.parallel.collectives import counted_as
from harmony_tpu_torch.parallel.mesh import mesh_spans_processes
from harmony_tpu_torch.metrics.tracer import Tracer
from harmony_tpu_torch.table import autotune
from harmony_tpu_torch.table.hashtable import DeviceHashTable
from harmony_tpu_torch.table.table import DenseTable, ShardedArray, on_device
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


class _DataParallelStep:
    """The step of a table whose mesh has D > 1 data rows, the reference's
    batch placed ``P(DATA_AXIS)`` (``harmony_tpu/dolphin/worker.py:720``).

    The batch splits contiguously over the rows, as that placement cuts it;
    the worker stages it so (a :class:`RowBatch`, each row's part on its
    row's compute slot), and a batch staged for another layout is cut here
    (the worker's ``input["restaged_batches"]`` counts those steps). Row ``r`` pulls from its own replica
    (``ShardedArray.at_row``: K1 on the shards of its row) and computes on
    its own slot, in one of the two ways ``dolphin/trainer.py`` describes:

      * ``Trainer.batch_reduction``: each row runs ``compute`` on its part;
        "mean" weights row ``r``'s delta and metrics by its share of the
        examples, "sum" adds them. Keyed deltas combine by concatenating the
        rows' keys and deltas, which the push folds in that order; whole-
        model deltas add up in row order;
      * the split contract (``rows.run_split``): the rows' statistics add up
        in row order on the first row's slot, where the finish makes the
        delta and the metrics. Beside a worker-local table (every row reads
        its own replica) the local rows the parts write are gathered in row
        order and written into EVERY replica, so the replicas stay alike.

    Either way the delta is pushed ONCE, into every replica. The sums run in
    another order than the one-slot step's, so the result agrees with it to
    rounding, not bit for bit; it is the same from run to run. A hash table
    admits the whole batch's keys on every replica first (one ``ensure``, so
    the replicas stay alike), and each row then reads its own keys' rows.

    On a pod whose rows lie in different processes (``BlockSharding.
    rows_apart``) each process computes only its own rows (those holding its
    slots), and what the other rows computed reaches it through the step's
    :class:`~harmony_tpu_torch.dolphin.rows.RowExchange` unchanged: the
    rows' keys (a hash table's, before the ``ensure`` of the whole batch's
    keys; a keyed pull's, with its delta), deltas, metrics, split
    statistics and local writes. Every process then adds, concatenates and
    pushes them in row order on its own first row's slot, into its own
    replicas: the operations of the one-process step on the same operands,
    so every process keeps the bits of that step on the same mesh."""

    def __init__(self, spec, trainer: Trainer, *, push_route: Optional[str],
                 is_hash: bool, local_spec=None,
                 counters: Optional[Dict[str, Any]] = None) -> None:
        self._split = trainer.splits_rows
        if not self._split and trainer.batch_reduction not in ("mean", "sum"):
            note = getattr(trainer, "data_axis_note", "")
            raise ValueError(
                f"{type(trainer).__name__} declares neither how its per-row deltas "
                "combine (Trainer.batch_reduction) nor a split (Trainer.row_part, "
                f"row_finish); a data axis > 1 needs one{note}")
        if spec.update_fn.scatter_mode != "add":
            raise ValueError("a data axis > 1 needs an additive update fn")
        if trainer.uses_local_table and not self._split:
            raise ValueError(
                f"{type(trainer).__name__} keeps a worker-local table: on a data "
                "axis > 1 it needs a split (Trainer.row_part, row_finish)")
        self._spec = spec
        self._local_spec = local_spec
        self._trainer = trainer
        self._route = push_route
        self._hash = is_hash
        # hyper-parameter scalars of the rows' devices other than the
        # worker's, set with fill_ from the trainer's host values (no copy)
        self._hyper_by_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        # "restaged_batches": steps whose batch was not staged for their rows
        self._counters = counters if counters is not None else {"restaged_batches": 0}

    def _row_hyper(self, dev: torch.device, hyper: Dict[str, torch.Tensor]):
        if all(v.device == dev for v in hyper.values()):
            return hyper
        scalars = self._hyper_by_device.setdefault(dev, {})
        out = {}
        for k, v in self._trainer.hyperparams().items():
            t = scalars.get(k)
            if t is None:
                t = scalars[k] = torch.empty((), dtype=torch.float32, device=dev)
            out[k] = t.fill_(float(v))
        return out

    def _parts(self, sh, batch, hyper):
        """This process's rows, each as (row, slot device, batch part,
        hyper-parameters) on the layout ``sh`` the table holds now, the part
        and the hyper-parameters on the row's slot; every row's weight; and
        the batch's examples."""
        devs = row_devices(sh.mesh)
        if not (isinstance(batch, RowBatch) and batch.devices == devs):
            # a batch staged before a move: the rows this process now
            # computes, each from its host arrays where this process never
            # staged that row
            self._counters["restaged_batches"] += 1
            batch = (batch.restage(devs) if isinstance(batch, RowBatch)
                     else stage_rows(batch, devs))
        n = batch.n
        bounds = row_bounds(n, len(devs))
        mean = self._trainer.batch_reduction == "mean"
        weights = [(bounds[r + 1] - bounds[r]) / n if mean else 1.0 for r in range(len(devs))]
        parts = [(r, dev, p, self._row_hyper(dev, hyper))
                 for r, (dev, p) in enumerate(zip(devs, batch.parts)) if p is not None]
        return parts, weights, n

    @staticmethod
    def _combine_metrics(metrics_by_row, weights, dev):
        return {k: sum(on_device(m[k], dev) * w for m, w in zip(metrics_by_row, weights))
                for k in metrics_by_row[0]}

    def _hash_keys(self, state, parts, dev, exchange):
        """One ``ensure`` of the whole batch's keys (every row's, in row
        order) on every replica; each row's keys and its slice of the token,
        on its slot (another process's rows' on ``dev``)."""
        mine = {r: [self._trainer.pull_keys(b).reshape(-1).to(torch.int32)]
                for r, _, b, _ in parts}
        keys = [k for (k,) in exchange(mine)]
        state, token = self._spec.ensure(state, torch.cat([on_device(k, dev) for k in keys]))
        devs = {r: rdev for r, rdev, _, _ in parts}
        toks, lo = [], 0
        for r, k in enumerate(keys):
            rdev = devs.get(r, dev)
            toks.append(tuple(on_device(t[lo:lo + k.shape[0]], rdev) for t in token))
            lo += k.shape[0]
        return state, token, keys, toks

    def __call__(self, state, *rest):
        local, (batch, hyper) = (rest[0], rest[1:]) if len(rest) == 3 else (None, rest)
        parts, weights, n = self._parts(state.sharding, batch, hyper)
        dev = state.device
        exchange = RowExchange(state.sharding, dev)
        if self._split:
            return self._split_step(state, local, parts, n, exchange)
        spec, trainer = self._spec, self._trainer
        keyed = trainer.pull_mode != "all"
        mine, names = {}, None
        if self._hash:
            state, token, keys, toks = self._hash_keys(state, parts, dev, exchange)
        for r, rdev, b, h in parts:
            w = weights[r]
            if self._hash:
                delta, m = trainer.compute(spec.read(state.at_row(r), keys[r], toks[r]), b, h)
                out = [trainer.mask_delta(delta, toks[r][2]) * w]
            elif not keyed:
                delta, m = trainer.compute(spec.pull_all(state.at_row(r)), b, h)
                out = [delta * w]
            else:
                k = trainer.pull_keys(b)
                delta, m = trainer.compute(spec.pull(state.at_row(r), k), b, h)
                out = [delta * w, k]
            names = list(m)
            mine[r] = out + [m[name] for name in names]
        every = exchange(mine)
        deltas = [on_device(t[0], dev) for t in every]
        width = len(every[0]) - len(names)
        metrics = self._combine_metrics([dict(zip(names, t[width:])) for t in every],
                                        weights, dev)
        if self._hash:
            state = spec.push(state, token, torch.cat(deltas))
            return state, dict(metrics, _dropped=_dropped(token))
        if not keyed:
            return spec.push_all(state, sum(deltas[1:], deltas[0])), metrics
        return spec.push(state, torch.cat([on_device(t[1], dev) for t in every]),
                         torch.cat(deltas), via=self._route), metrics

    def _split_step(self, state, local, parts, n, exchange):
        """The split contract: this process's rows' parts and the finish
        (``rows.run_split``), one push of the delta, and the local writes
        into every replica of the local table."""
        spec, trainer = self._spec, self._trainer
        dev = state.device
        token = toks = keys = None
        if self._hash:
            state, token, keys, toks = self._hash_keys(state, parts, dev, exchange)
        rows = []
        for r, rdev, b, h in parts:
            if self._hash:
                model = spec.read(state.at_row(r), keys[r], toks[r])
            elif trainer.pull_mode == "all":
                model = spec.pull_all(state.at_row(r))
            else:
                model = spec.pull(state.at_row(r), trainer.pull_keys(b))
            lmodel = (None if local is None
                      else self._local_spec.pull_all(local.at_row(r)))
            rows.append(RowInput(rdev, model, b, h, lmodel, row=r))
        if trainer.pull_mode != "all" and not self._hash:
            # a keyed pull's keys, for the push of every row's delta
            keys = [k for (k,) in exchange({r: [trainer.pull_keys(b)] for r, _, b, _ in parts})]
        delta, metrics, local_writes, results = run_split(trainer, rows, n, exchange)
        if self._hash:
            deltas = [on_device(trainer.mask_delta(res.delta, tok[2]), dev)
                      for res, tok in zip(results, toks)]
            state = spec.push(state, token, torch.cat(deltas))
            metrics = dict(metrics, _dropped=_dropped(token))
        elif trainer.pull_mode == "all":
            state = spec.push_all(state, delta)
        else:
            state = spec.push(state, torch.cat([on_device(k, dev) for k in keys]),
                              torch.cat([on_device(res.delta, dev) for res in results]),
                              via=self._route)
        if local is None:
            return state, metrics
        writes = [(res.local_keys, res.local_rows) for res in results
                  if res.local_keys is not None]
        if local_writes is not None:
            writes.append(local_writes)
        if writes:
            # each write's storage rows, made where its keys lie: the rows'
            # writes travel as (storage row, values), never as a batch array
            lspec = self._local_spec
            flat = [lspec._flat_index(*lspec.partitioner.locate(k.reshape(-1)))
                    for k, _ in writes]
            self._write_local(local, torch.cat([on_device(f, dev) for f in flat]),
                              torch.cat([on_device(v, dev) for _, v in writes]))
        return (state, local), metrics

    def _write_local(self, local, flat: torch.Tensor, rows: torch.Tensor) -> None:
        """Set the local table's storage rows ``flat`` to ``rows`` in every
        replica, with no host sync: on each slot the rows of other shards go
        to a sink row past the shard's end, the values land in a scratch copy
        and a mask of the rows written picks them (no row repeats: the worker
        refuses such a batch)."""
        spec, sh = self._local_spec, local.sharding
        per = spec._rows_per_shard(sh)
        m, at = spec._shard_rows(flat, sh)
        flat_rows = rows.reshape(flat.shape[0], -1)
        for slot, t in local.shards.items():
            d = t.device
            idx = on_device(torch.where(m == sh.shard_of(slot), at, per).long(), d)
            tv = t.view(per, -1)
            buf = torch.empty((per + 1, tv.shape[1]), dtype=t.dtype, device=d)
            buf.index_put_((idx,), on_device(flat_rows, d).to(t.dtype))
            hit = torch.zeros(per + 1, dtype=torch.bool, device=d)
            hit.index_put_((idx,), torch.ones_like(idx, dtype=torch.bool))
            tv.copy_(torch.where(hit[:per, None], buf[:per], tv))


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
        starting_epoch: int = 0,
        defer_epoch_callback: bool = False,
        collector: Optional[MetricCollector] = None,
        pod_contended: Optional[Callable[[], bool]] = None,
        pending_plan_epoch: Optional[Callable[[], Optional[int]]] = None,
        attempt: int = 0,
    ) -> None:
        self.job_id = job_id
        # the elastic attempt this run is (jobserver/elastic.py; 0 for any
        # other job), echoed in the result, and its key in the tenant ledger
        self.attempt = attempt
        self.attempt_key = attempt_key(job_id, attempt)
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
        # a callable returning this worker's turnstile turn (lockstep jobs),
        # or its pod unit, or both composed
        self.dispatch_turn = dispatch_turn
        # the contended flag of the job's last pod unit (pod jobs only)
        self.pod_contended = pod_contended
        # called after each epoch's drain, in epoch order. Deferrable (the
        # entity's progress tracker: host accounting only): windows may run
        # it after a multi-epoch window drains. Not deferrable (a checkpoint
        # chain, which snapshots the table AT its epoch): windows stay at one
        # epoch, so the hook sees each epoch's own state
        self.epoch_callback = epoch_callback
        self.defer_epoch_callback = defer_epoch_callback
        # the first epoch this run trains (a resume continues a chain there;
        # the reference's StartingEpochIdx)
        self.starting_epoch = starting_epoch
        # the epoch of the job's next scheduled pod plan, or None (the
        # chief's; jobserver/podplan.py): a window ends at that epoch, so the
        # move lands right after its dispatches, alike in every process
        self.pending_plan_epoch = pending_plan_epoch
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
                       "stage_sec": 0.0, "dropped_batches": 0, "restaged_batches": 0}
        # the (compute device, data rows, the rows' processes) the step was
        # built for
        self._step_layout: Optional[Tuple[Any, ...]] = None
        # the data rows this process computed in each epoch run, and those
        # of the layout the last step ran on
        self._rows_by_epoch: List[List[int]] = []
        self._step_rows: List[int] = list(ctx.model_table.sharding.local_rows)
        # the compute device of each data row the batches are staged for
        # (None: one row, whole batches on ``device``)
        self._rows = row_devices(ctx.model_table.mesh)
        # stable batches whose local writes were checked (_check_local_rows)
        self._local_rows_ok: set = set()
        self._pipeline: Optional[PrefetchPipeline] = None  # the epoch's, if any
        # the metric sink's collector (under a JobServer) and this worker's
        # op counters (the entity's ServerMetrics read them)
        self.collector = collector
        self.op_stats: Dict[str, int] = {"pulls": 0, "pushes": 0, "pull_bytes": 0}
        self._pull_bytes: Optional[int] = None
        # the job's throughput SLO (metrics/accounting.py): the env knob
        # overrides the job's param for every tenant. The chief checks it at
        # each epoch's end (_check_slo)
        target = accounting.slo_target_from_env()
        if target is None and params.target_samples_per_sec > 0:
            target = float(params.target_samples_per_sec)
        self._slo_target: Optional[float] = target
        self._slo_below = 0
        self._slo_fired = False
        # the step-phase budget (metrics/phases.py): host seconds of batch
        # placement, summed on the training thread and taken at each epoch's
        # end, and each epoch's input-wait seconds (its pipeline's consumer
        # stall), both read by the drain's report
        self._phase_dispatch_acc = 0.0
        self._phase_dispatch: Dict[int, float] = {}
        self._phase_input_wait: Dict[int, float] = {}
        self._step_hist = None

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
        if self.dispatch_turn is not None or self._spans_processes():
            return via  # the static gate, the same in every process
        sample = tuple(torch.as_tensor(np.ascontiguousarray(a))
                       for a in self.data.first_rows(self.data.batch_size))
        nkeys = int(self.trainer.pull_keys(sample).shape[0])
        return autotune.choose_push_route(table.spec, table.device, nkeys, table=table)

    def _data_rows(self) -> int:
        """Data rows of the model table's mesh (1 but for ``data_axis`` > 1)."""
        return self.ctx.model_table.sharding.data_rows

    def _build_step(self, rows: Optional[int] = None) -> None:
        """The step for the worker's device and ``rows`` data rows (the
        table's, when not given)."""
        table = self.ctx.model_table
        if self._push_route is None:
            self._push_route = self._resolve_push_route()
        rows = self._data_rows() if rows is None else rows
        self._step_layout = (self.device, rows, self._row_processes(table.sharding, rows))
        if rows > 1:
            local = self.ctx.local_table
            self._step = _DataParallelStep(table.spec, self.trainer,
                                           push_route=self._push_route,
                                           is_hash=self._is_hash(),
                                           local_spec=None if local is None else local.spec,
                                           counters=self._input)
        elif self._async_mode():
            self._step = AsyncStepDriver(
                self._build_unfused(self._push_route), bound=self._staleness_bound,
                model_table=table, local_table=self.ctx.local_table,
                job_id=self.job_id)
        elif self._fused_mode():
            self._step = self._step_core(self._push_route)
        else:
            self._step = self._build_unfused(self._push_route)
        self._bind_ledger()

    def _spans_processes(self) -> bool:
        """Whether the model table's mesh spans the processes of a pod."""
        return mesh_spans_processes(self.ctx.model_table.mesh)

    def _fused_mode(self) -> bool:
        """Whether the step is the fused one (the async driver runs the
        unfused phases by construction and takes precedence). A mesh over
        several processes keeps the fused step whatever the knob says."""
        if self._async_mode():
            return False
        return self._fused_on or self._spans_processes()

    def _async_capable(self) -> bool:
        """Whether the async step can drive this job: dense pull_mode='all'
        tables only. A keyed or hash step pulls per-batch rows, and the
        published-view pipeline has no batch when it pulls."""
        if self._is_hash() or self._data_rows() > 1 or self._spans_processes():
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
            return table.apply_step_with(self.ctx.local_table, self._layout_step,
                                         batch, hyper)
        return table.apply_step(self._layout_step, batch, hyper)

    @staticmethod
    def _row_processes(sharding, rows: int) -> Tuple[Tuple[int, ...], ...]:
        """The processes of each data row (one process's own, off a pod)."""
        return tuple(sharding.row_processes(r) for r in range(rows)) if rows > 1 else ()

    def _layout_step(self, state, *rest):
        """The step on the layout the table holds NOW (called under its lock,
        so no reshard lands inside it): a step built for another compute
        device, number of data rows or placement of the rows over processes
        is rebuilt, and a batch that lies on another device is copied to the
        compute device."""
        *tables, batch, hyper = (state, *rest)
        sharded = isinstance(state, ShardedArray)
        dev = state.device if sharded else (state[0] if isinstance(state, tuple)
                                            else state).device
        rows = state.sharding.data_rows if sharded else 1
        if dev != self.device:
            self._rehome(dev)
        layout = (dev, rows, self._row_processes(state.sharding, rows) if sharded else ())
        if layout != self._step_layout:
            self._build_step(rows)
            self._step_rows = list(state.sharding.local_rows) if sharded else [0]
        # a batch, or an epoch's hyper-parameters, made before the move: the
        # data-parallel step cuts a batch staged for other rows itself
        if isinstance(batch, RowBatch) and rows == 1:
            self._input["restaged_batches"] += 1
            batch = batch.joined(dev)
        elif not isinstance(batch, RowBatch):
            batch = tuple(on_device(a, dev) for a in batch)
        hyper = {k: on_device(v, dev) for k, v in hyper.items()}
        return self._step(*tables, batch, hyper)

    def _rehome(self, device: torch.device) -> None:
        """Follow the table to ``device``: the device copies of batches and
        the hyper-parameter scalars are made anew there, staged by the
        table's data rows."""
        self.device = device
        self._rows = row_devices(self.ctx.model_table.mesh)
        self._batch_cache.clear()
        self._stacked_cache = None
        self._hyper_scalars = {}

    def _follow_layout(self) -> None:
        """At a dispatch boundary: re-home when the table now computes on
        another device, or its data rows on other devices."""
        table = self.ctx.model_table
        if (table.device, row_devices(table.mesh)) != (self.device, self._rows):
            self._rehome(table.device)

    def _on_layout(self, target) -> None:
        """The table's reshard announcement (the target mesh): when the target
        computes on another device, or its rows on others, the epoch's
        pipeline stops staging and drops what it staged."""
        pipe = self._pipeline
        if pipe is not None and (target.devices.flat[0].device != self.device
                                 or row_devices(target) != self._rows):
            pipe.stop_staging()

    def _to_device(self, batch: Tuple[np.ndarray, ...]) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.as_tensor(np.ascontiguousarray(a), device=self.device)
                     for a in batch)

    def _place(self, batch: Tuple[np.ndarray, ...]):
        """A host batch on the device for a step: whole on the compute
        device, or on a mesh with data rows each row's part on its row's
        compute slot (a :class:`RowBatch`)."""
        if self._rows is None:
            return self._to_device(batch)
        return stage_rows(batch, self._rows, host=lambda: batch)

    def _check_local_rows(self, batch_idx: int, batch) -> None:
        """On a data axis > 1, refuse a batch that writes one worker-local
        row twice (the reference's ``.at[].set`` leaves such a write
        undefined): checked on the host batch, once a stable batch."""
        if self._rows is None or not self.trainer.uses_local_table:
            return
        stable = self.cache_device_batches
        if stable and batch_idx in self._local_rows_ok:
            return
        host = self._host_batch(batch_idx, batch)
        keys = self.trainer.local_keys(tuple(torch.as_tensor(np.asarray(a)) for a in host))
        if keys is not None:
            uniq, counts = np.unique(keys.reshape(-1).numpy(), return_counts=True)
            if (counts > 1).any():
                raise ValueError(
                    f"job {self.job_id}: batch {batch_idx} writes local row "
                    f"{int(uniq[counts > 1][0])} of {self.ctx.local_table.spec.table_id} "
                    "more than once; on a data axis > 1 each row of a batch's "
                    "local writes must be distinct")
        if stable:
            self._local_rows_ok.add(batch_idx)

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
            # a window a reshard crossed holds metrics of two devices
            host = torch.stack([on_device(c, self.device) for c in cols]).cpu().tolist()
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
            def copy(state):
                if isinstance(state, ShardedArray):
                    return state.clone()
                return tuple(t.clone() for t in state)

            def pull_fn(state, batch):
                scratch = copy(state)
                return spec.pull(scratch, trainer.pull_keys(batch))[1]

            def pp_fn(state, batch):
                scratch = copy(state)
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
        if self._use_fused_epoch() and self._rows is None:
            self._ensure_stacked_cache()
            return self._stacked_batch(self._stacked_cache, 0)
        return self._to_device(self.data.first_rows(self.data.batch_size))

    def _probe_comm(self) -> None:
        """Time the probe programs on one batch under the table lock: one
        warm-up call, then the minimum of ``PROBE_SAMPLES`` calls, each
        ended by a sync. Stores ``(pull_s, push_s)``. On a mesh over several
        processes the probe's pulls are collectives: with several workers and
        no turnstile their order could differ between processes, so it is
        skipped."""
        if (self._spans_processes() and self.dispatch_turn is None
                and self.ctx.num_workers != 1):
            return
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

        with table._lock, counted_as("probe"):
            arr = table._step_state
            batch = tuple(on_device(a, table.device) for a in batch)
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
        dispatches. An SSP gate decides per batch, and an epoch callback that
        must see each epoch's state (``defer_epoch_callback=False``) runs at
        every epoch: no window. A window ends at the epoch of the job's next
        pod plan (``pending_plan_epoch``)."""
        if self.batch_barrier is not None:
            return 1
        if not self._fused_mode():
            return 1
        if self.pod_contended is not None and self.pod_contended():
            # a window is one pod unit: contended tenants interleave by epoch
            return 1
        if not Trainer._epoch_hook_windowable(self.trainer):
            return 1
        if self.epoch_callback is not None and not self.defer_epoch_callback:
            return 1
        w = min(self.EPOCH_WINDOW, num_epochs - epoch)
        if self.pending_plan_epoch is not None:
            due = self.pending_plan_epoch()
            if due is not None and due >= epoch:
                w = min(w, due - epoch + 1)  # the window ends AT the plan's epoch
        if self.comm_probe_every and self.global_init:
            if self._probe_pull is None:
                w = min(w, 1)  # a probe is due at this epoch boundary
            else:
                until = self._next_probe - (epoch - self.starting_epoch)
                if until > 0:
                    w = min(w, until)
        return max(1, w)

    # -- the fused epoch ---------------------------------------------------

    def _devcache_key(self, tag) -> "tuple | None":
        """Key into the process-level device cache: None unless the provider
        carries a data-source identity."""
        if self.data.dataset_key is None:
            return None
        where = (str(self.device) if self._rows is None
                 else ("rows", tuple(map(str, self._rows))))
        return (self.data.dataset_key, tag, where)

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
        stack = tuple(torch.as_tensor(np.stack([b[i] for b in batches]))
                      for i in range(len(batches[0])))
        self._stacked_cache = (tuple(a.to(self.device) for a in stack) if self._rows is None
                               else stage_stack_rows(stack, self._rows, self.data.batch_at))
        devcache.put(gkey, self._stacked_cache)

    @staticmethod
    def _stacked_batch(stacked, b: int):
        """Batch ``b`` of a device-resident stack (views)."""
        if isinstance(stacked, RowBatch):
            return stacked.index(b)
        return tuple(a[b] for a in stacked)

    def _enqueue_fused_window(self, first_epoch: int, k: int
                              ) -> List[List[Dict[str, torch.Tensor]]]:
        """Enqueue ``k`` epochs over the device-resident stack with no host
        sync: every batch a view ``stacked[i][b]``, the windowable trainer
        hook between epochs, the hyper-parameters set on the device."""
        # the stack of the window's start: a step that re-homes the worker
        # drops the cache, and its batches are copied to the new device
        stacked = self._stacked_cache
        out = []
        for j in range(k):
            hyper = self._hyper()
            batches = []
            with self._turn():   # each epoch is one pod unit
                for b in range(self.data.num_mini_batches):
                    self._step_fault_site(b)
                    self._check_local_rows(b, None)
                    batches.append(self._dispatch(self._stacked_batch(stacked, b), hyper))
            out.append(batches)
            if j + 1 < k:
                self.trainer.on_epoch_finished(self.ctx, first_epoch + j)
        return out

    def _run_fused_epochs(self, first_epoch: int, k: int
                          ) -> Tuple[List[List[float]], float]:
        """``k`` fused epochs and ONE drain; returns each epoch's per-batch
        metrics and the window's seconds split evenly over its epochs. The
        stack is uploaded before the timer starts."""
        self._follow_layout()
        self._ensure_stacked_cache()
        t0 = time.perf_counter()
        losses = self._drain(self._enqueue_fused_window(first_epoch, k))
        return losses, (time.perf_counter() - t0) / k

    # -- the batched epoch ---------------------------------------------------

    def _prefetch_usable(self) -> bool:
        """Whether background staging may run: ``input_prefetch``. The
        reference also turns it off under pod turnstiles and on meshes that
        span processes, where its staging copy is itself a collective; the
        port's stages a batch on this process's own card, a local copy that
        may run beside a unit."""
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
        pipeline = self._pipeline = self._make_pipeline(epoch)
        inp = self._input
        hits0, misses0 = inp["prefetch_hits"], inp["prefetch_misses"]
        try:
            for staged in pipeline:
                yield staged.index, staged.host, staged
        finally:
            self._pipeline = None
            pipeline.close()
            stats = pipeline.stats()
            inp["pipelines"] += 1
            inp["max_depth"] = max(inp["max_depth"], stats["max_depth"])
            for k in ("staged", "producer_idle_sec", "consumer_stall_sec",
                      "produce_sec", "stage_sec", "dropped_batches"):
                inp[k] += stats[k]
            self._report_input(pipeline, epoch, inp["prefetch_hits"] - hits0,
                               inp["prefetch_misses"] - misses0)

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
                                skip_stage_fn=skip, rows=self._rows)

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
            batch_dev = self._place(self._host_batch(batch_idx, batch))
            devcache.put(gkey, batch_dev)
        self._batch_cache[batch_idx] = batch_dev
        return batch_dev

    def _step_fault_site(self, batch_idx: int) -> None:
        """The step-boundary fault site (module doc); disarmed it costs one
        global read."""
        if faults.armed():
            faults.site("worker.step", job=self.job_id, worker=self.ctx.worker_id,
                        batch=batch_idx, proc=multihost.process_index())

    def _dispatch_batch(self, batch_idx: int, batch, hyper,
                        staged: Optional[StagedBatch]) -> Dict[str, torch.Tensor]:
        self._step_fault_site(batch_idx)
        self._check_local_rows(batch_idx, batch)
        # host_dispatch (metrics/phases.py): the placement's host seconds
        t_place = time.perf_counter()
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
                batch_dev = self._place(self._host_batch(batch_idx, batch))
        self._phase_dispatch_acc += time.perf_counter() - t_place
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
        if self.pod_contended is not None and self.dispatch_turn is not None:
            # pod units: a FIXED group (the same in every process), one
            # batch under contention
            return 1 if self.pod_contended() else 8
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
        self._follow_layout()
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
        self._phase_dispatch[epoch], self._phase_dispatch_acc = self._phase_dispatch_acc, 0.0
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
        self.trainer.on_training_start(ctx, self.starting_epoch)
        self._build_step()
        ctx.model_table.add_layout_listener(self._on_layout)
        try:
            with torch.no_grad():  # compute takes its own gradient
                return self._run_epoch_loop()
        finally:
            ctx.model_table.remove_layout_listener(self._on_layout)
            if isinstance(self._step, AsyncStepDriver):
                self._step.shutdown()

    def _run_epoch_loop(self) -> Dict[str, Any]:
        ctx, params = self.ctx, self.ctx.params
        epoch_losses: List[float] = []
        batch_losses: List[float] = []
        epoch_seconds: List[float] = []
        windows: List[int] = []
        started = time.perf_counter()
        epoch = self.starting_epoch
        stop = False
        while epoch < params.num_epochs and not stop:
            since = epoch - self.starting_epoch
            if (self.comm_probe_every and self.global_init and self._fused_mode()
                    and (self._probe_pull is None or since >= self._next_probe)):
                self._next_probe = since + 8 * self.comm_probe_every
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
                self._report_batches(epoch, losses, secs)
            for epoch_batches in losses:
                batch_losses.extend(epoch_batches)
                epoch_losses.append(epoch_batches[-1] if epoch_batches else 0.0)
                epoch_seconds.append(secs)
                self._rows_by_epoch.append(list(self._step_rows))
            if losses:
                # the window's last hook runs after its drain
                self.trainer.on_epoch_finished(ctx, epoch + len(losses) - 1)
            for e in range(epoch, epoch + len(losses)):
                if self.collector is not None:
                    # each epoch's ops before its callback: a window's
                    # ServerMetrics stay per epoch, as the reference's
                    self._account_ops(len(losses[e - epoch]))
                if self.epoch_callback is not None:
                    with self._turn():
                        try:
                            self.epoch_callback(e)
                        except BaseException as exc:
                            if getattr(exc, "elastic_fence", None):
                                # an elastic fence ends the run here: what it
                                # trained rides the fence to the attempt's report
                                exc.worker_result = {
                                    "starting_epoch": self.starting_epoch,
                                    "epochs_run": len(epoch_losses), "losses": epoch_losses,
                                    "batch_losses": batch_losses,
                                    "epoch_seconds": epoch_seconds, "attempt": self.attempt,
                                    "train_span": [started, time.perf_counter()]}
                            raise
                elif self._balanced_turns():
                    with self._turn():
                        pass
                if self.collector is not None:
                    # after the callback, as the reference flushes: a
                    # reconfiguration there clears the metrics before it,
                    # not this epoch's
                    self.collector.flush()
            epoch += window
        finished = time.perf_counter()
        self.trainer.cleanup(ctx)
        step = self._step
        mode = ("async" if isinstance(step, AsyncStepDriver)
                else "data_parallel" if isinstance(step, _DataParallelStep)
                else "fused" if self._fused_mode() else "unfused")
        result = {
            "job_id": self.job_id,
            # this run trained epochs [starting_epoch, starting_epoch + epochs_run)
            "starting_epoch": self.starting_epoch,
            "epochs_run": len(epoch_losses),
            "attempt": self.attempt,
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
            # the model table's mesh: {"data": D, "model": M}
            "mesh": dict(ctx.model_table.mesh.shape),
            # the data rows this process computed (those holding its
            # slots); once a move changed them, the rows of each epoch run
            "data_rows": self._data_rows_report(),
        }
        if self._is_hash():
            result["overflow_count"] = ctx.model_table.overflow_count
        if mode in ("unfused", "async"):
            result["phase_seconds"] = dict(zip(("pull", "comp", "push"),
                                               step.mean_phase_seconds()))
        if mode == "async":
            result["staleness"] = step.staleness_stats()
        return result

    def _data_rows_report(self) -> List[Any]:
        """The rows every epoch computed, or, when a move changed them, the
        rows of each epoch run, in order."""
        by_epoch = self._rows_by_epoch
        if not by_epoch:
            return list(self.ctx.model_table.sharding.local_rows)
        if all(r == by_epoch[0] for r in by_epoch):
            return list(by_epoch[0])
        return [list(r) for r in by_epoch]

    # -- metrics ---------------------------------------------------------

    def _report_batches(self, first_epoch: int, losses: List[List[float]],
                        epoch_sec: float) -> None:
        """After a drain, for each epoch of its window: queue one
        ``BatchMetrics`` a batch (with a collector) at the epoch's seconds
        smeared over its batches, with the probe's pull/push split (the
        unfused phases' own where they run) and comp the rest; the queue is
        flushed after the epoch callback. Then the epoch's feeds: the tenant
        ledger (steps, examples, device seconds: the epoch's seconds less its
        input wait), the step-phase budget (that split of the same seconds,
        the placement seconds, the input wait), the step and epoch
        histograms, and the chief's SLO check. Host arithmetic on numbers the
        drain already has: no sync, no launch."""
        measured_fn = getattr(self._step, "mean_phase_seconds", None)
        measured = measured_fn() if measured_fn is not None else None
        if measured is not None:
            t_pull, _, t_push = measured
        else:
            t_pull, t_push = self._comm_probe_times
        for j, batch_losses in enumerate(losses):
            epoch = first_epoch + j
            steps = len(batch_losses)
            per_batch = epoch_sec / max(steps, 1)
            if self.collector is not None:
                comp = max(per_batch - t_pull - t_push, 0.0)
                for b, loss in enumerate(batch_losses):
                    self.collector.add(BatchMetrics(
                        job_id=self.job_id, worker_id=self.ctx.worker_id,
                        epoch_idx=epoch, batch_idx=b,
                        num_examples=self.data.batch_size, batch_time_sec=per_batch,
                        pull_time_sec=t_pull, comp_time_sec=comp, push_time_sec=t_push,
                        loss=float(loss)))
            self._feed_epoch(epoch, steps, epoch_sec, per_batch, measured, (t_pull, t_push))
        # every epoch dispatched so far was drained: nothing stays staged
        self._phase_dispatch.clear()
        self._phase_input_wait.clear()

    def _feed_epoch(self, epoch: int, steps: int, epoch_sec: float, per_batch: float,
                    measured: Optional[Tuple[float, float, float]],
                    probe: Tuple[float, float]) -> None:
        """One drained epoch's feeds of metrics/{accounting,phases}.py and the
        registry's histograms. Guarded: accounting never fails a step."""
        dispatch = self._phase_dispatch.pop(epoch, 0.0)
        wait = self._phase_input_wait.pop(epoch, 0.0)
        try:
            work = max(epoch_sec - wait, 0.0)
            acct = accounting.ledger()
            acct.observe_steps(self.job_id, self.attempt_key, self.ctx.worker_id,
                               steps=steps, device_sec=work,
                               examples=steps * self.data.batch_size,
                               devices=self.ctx.model_table.mesh.size)
            acct.set_resident(self.job_id, self.attempt_key, "input",
                              self._input_resident_bytes())
            stats = (self._step.staleness_stats()
                     if isinstance(self._step, AsyncStepDriver) else {})
            acct.set_async_state(
                self.job_id, self.attempt_key, available=self._async_capable(),
                enabled=bool(stats), bound=stats.get("bound", self._staleness_bound),
                max_lag=stats.get("max_lag", 0),
                exposed_wait_sec=stats.get("exposed_wait_sec", 0.0),
                overlapped_comm_sec=stats.get("overlapped_comm_sec", 0.0))
            # no FLOP count (ROADMAP A item 6.5): no FLOP floor under compute
            split = phases.split_device_phases(
                work, steps, dispatch_sec=dispatch, measured=measured,
                probe_split=None if measured is not None else probe)
            phases.budget().observe_epoch(
                self.job_id, self.attempt_key, self.ctx.worker_id, epoch, epoch_sec,
                {"input_wait": wait, "host_dispatch": dispatch, **split})
            hist = self._step_histogram()
            for _ in range(steps):
                hist.observe(per_batch)
            get_registry().histogram(
                "harmony_epoch_time_seconds", "Per-epoch wall seconds per worker",
                ("job", "attempt"), buckets=EPOCH_TIME_BUCKETS,
            ).labels(job=self.job_id, attempt=self.attempt_key).observe(epoch_sec)
        except Exception:
            pass
        self._check_slo(epoch, steps * self.data.batch_size, epoch_sec)

    #: consecutive under-target epochs before the SLO event fires — one
    #: slow epoch (a reshard, a checkpoint, a co-tenant's burst) is noise;
    #: a sustained run is the scheduler-actionable signal
    SLO_WINDOW_EPOCHS = 3
    #: attainment floor: below this fraction of target counts as a breach
    SLO_ATTAINMENT_FLOOR = 0.9

    def _check_slo(self, epoch: int, epoch_examples: int, epoch_sec: float) -> None:
        """Windowed SLO attainment check at the epoch boundary (the
        reference's; chief only — the target is per JOB, so sibling workers
        checking their own shares would fire many times). The job's rate is
        this worker's rate × num_workers (the provider splits the epoch
        evenly); exact for single-worker jobs. A sustained breach records ONE
        structured joblog event (kind="slo") and counts in the tenant ledger;
        recovery above the floor re-arms it."""
        if self._slo_target is None or not self.global_init:
            return
        own_sps = epoch_examples / epoch_sec if epoch_sec > 0 else 0.0
        job_sps = own_sps * max(self.ctx.num_workers, 1)
        if job_sps >= self.SLO_ATTAINMENT_FLOOR * self._slo_target:
            self._slo_below = 0
            self._slo_fired = False
            return
        self._slo_below += 1
        if self._slo_below < self.SLO_WINDOW_EPOCHS or self._slo_fired:
            return
        self._slo_fired = True
        try:
            from harmony_tpu_torch.jobserver import joblog

            joblog.record_event(
                self.job_id, kind="slo", attempt=self.attempt_key, epoch=epoch,
                target_sps=self._slo_target, achieved_sps=round(job_sps, 3),
                attainment=round(job_sps / self._slo_target, 4),
                window_epochs=self.SLO_WINDOW_EPOCHS)
            accounting.ledger().record_slo_event(self.job_id)
        except Exception:
            pass  # SLO observability never fails the epoch boundary

    def _report_input(self, pipeline: PrefetchPipeline, epoch: int, hits: int,
                      misses: int) -> None:
        """At the close of an epoch's pipeline: its ``InputPipelineMetrics``
        (with a collector), and its consumer stall as the epoch's input wait
        (the ledger's wait fraction, the budget's ``input_wait``)."""
        if self.collector is not None:
            self.collector.add(pipeline.report(self.job_id, self.ctx.worker_id, epoch,
                                               hits, misses))
        stall = pipeline.stats()["consumer_stall_sec"]
        self._phase_input_wait[epoch] = stall
        try:
            accounting.ledger().record_input_wait(self.job_id, self.attempt_key, stall)
        except Exception:
            pass

    def _bind_ledger(self) -> None:
        """At each (re)build of the step: name this job the owner of its
        tables (the ledger attributes their moved and checkpointed bytes
        through the binding), refresh the resident-table bytes, and set the
        SLO target. Guarded: accounting never fails a build."""
        try:
            acct = accounting.ledger()
            tables = [self.ctx.model_table]
            if self.trainer.uses_local_table:
                tables.append(self.ctx.local_table)
            for t in tables:
                acct.bind_table(t.spec.table_id, self.job_id, self.attempt_key)
            acct.set_resident(self.job_id, self.attempt_key, "table",
                              sum(self._table_bytes(t) for t in tables))
            if self._slo_target is not None:
                acct.set_slo_target(self.job_id, self.attempt_key, self._slo_target)
        except Exception:
            pass

    @staticmethod
    def _table_bytes(table) -> int:
        """Device bytes of a table's storage, from its spec (dense array, or
        a hash table's int32 slot keys and values): the reference's count."""
        spec = table.spec
        if isinstance(table, DeviceHashTable):
            return (int(np.prod(spec.keys_shape)) * 4
                    + int(np.prod(spec.values_shape)) * spec.dtype.itemsize)
        return int(np.prod(spec.storage_shape)) * spec.dtype.itemsize

    def _input_resident_bytes(self) -> int:
        """Device bytes of this worker's resident input copies: its stacked
        epoch and its per-batch cache (its share of the device cache)."""
        def nbytes(x) -> int:
            if isinstance(x, torch.Tensor):
                return x.numel() * x.element_size()
            if isinstance(x, RowBatch):
                return x.nbytes()
            return sum(nbytes(v) for v in x) if isinstance(x, (tuple, list)) else 0

        total = nbytes(self._stacked_cache) if self._stacked_cache is not None else 0
        return total + sum(nbytes(b) for b in self._batch_cache.values())

    def _step_histogram(self):
        """This worker's child of ``harmony_step_time_seconds``."""
        if self._step_hist is None:
            self._step_hist = get_registry().histogram(
                "harmony_step_time_seconds",
                "Per-mini-batch dispatch+device seconds per worker",
                ("job", "attempt", "worker"), buckets=STEP_TIME_BUCKETS,
            ).labels(job=self.job_id, attempt=self.attempt_key,
                     worker=self.ctx.worker_id)
        return self._step_hist

    def _account_ops(self, steps: int) -> None:
        """Fold ``steps`` steps' pulls and pushes (one each a step) into this
        worker's own counters, which the entity's ServerMetrics read."""
        self.op_stats["pulls"] += steps
        self.op_stats["pushes"] += steps
        self.op_stats["pull_bytes"] += steps * self._pull_size()

    def _pull_size(self) -> int:
        """Bytes a step pulls: its keys' rows (the keys of the first batch's
        rows, on the host), or the whole table for a whole-model pull."""
        if self._pull_bytes is None:
            spec = self.ctx.model_table.spec
            row = (int(np.prod(spec.value_shape)) if spec.value_shape else 1) * \
                torch.empty(0, dtype=spec.dtype).element_size()
            if self.trainer.pull_mode == "keys":
                sample = tuple(torch.as_tensor(np.ascontiguousarray(a))
                               for a in self.data.first_rows(self.data.batch_size))
                rows = int(self.trainer.pull_keys(sample).reshape(-1).shape[0])
            else:
                rows = int(spec.config.capacity)
            self._pull_bytes = rows * row
        return self._pull_bytes

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
