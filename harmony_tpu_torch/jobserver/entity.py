"""Job entities — a job between the JobServer and its runtime.

Counterpart of ``harmony_tpu/jobserver/entity.py``. :func:`build_entity` is
the reference's app-type switch: ``"dolphin"`` jobs get a
:class:`DolphinJobEntity`, ``"pregel"`` jobs a :class:`PregelJobEntity`, and
any other type raises. The JobServer hands every entity its global and local
TaskUnit schedulers (``runtime/taskunit.py``).

``DolphinJobEntity``: the trainer and its data come from the serializable
``JobConfig`` (dotted-path symbols). The job's model table is SHARED when
``config.tables`` names one (the table of that id is reused if it exists; the
master refcounts it and frees it when its last holder drops it), else a
PRIVATE table under a job-namespaced id (a ``DeviceHashTable`` when its
config is ``sparse``), so two jobs of one app never collide; a worker-local
table, when the trainer has one, is always private. The run is the
reference's ``DolphinJobEntity.run``: ``num_workers`` workers (0 = one per
granted executor), each on one slice of the data (the last takes the
remainder) on a thread of its own, on the stream of the dispatch thread;
the ``INIT`` lifecycle barrier, the chief's (worker 0's) global init with a
barrier after it that a failing worker aborts; an SSP
``MiniBatchController`` when there is more than one worker (slack at least 1
under ``user.force_lockstep``, which also builds a ``DispatchTurnstile``);
and a ``TaskUnitClient`` for every worker unless it runs in lockstep. A
worker that stops, or fails, leaves the TaskUnit quorum, the SSP gate and
the turnstile, so its siblings never wait for it. Cleanup releases the job's
own references only. The dataset is cached under its data source
(``_data_source_key``): a second job with the same ``data_fn`` and
``data_args`` reads the cached host arrays, and its workers the
device-resident batches of their slices, as in the reference.

``PregelJobEntity``: ``config.trainer`` names the Computation class,
``user.graph_fn``/``user.graph_args`` build the Graph, ``user.max_supersteps``
bounds the run; a Computation whose ``__init__`` takes ``graph`` gets it. Its
``PregelMaster`` holds the vertex and message tables on the executors' device
and takes a COMP unit a superstep; cleanup closes it, which drops them.

Not ported yet: checkpoint chains and resume (ROADMAP A.7), elastic recovery,
the optimizer loop, metric sinks and the pod branch (A.9, A.10).
"""
from __future__ import annotations

import contextlib
import inspect
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from harmony_tpu_torch.config.base import resolve_symbol
from harmony_tpu_torch.config.params import JobConfig
from harmony_tpu_torch.data import devcache
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.master import (
    BatchProgressTracker,
    DispatchTurnstile,
    MiniBatchController,
    WorkerStateManager,
)
from harmony_tpu_torch.dolphin.trainer import Trainer, TrainerContext
from harmony_tpu_torch.dolphin.worker import WorkerTasklet
from harmony_tpu_torch.pregel.master import PregelMaster
from harmony_tpu_torch.runtime.master import ETMaster, Table
from harmony_tpu_torch.runtime.taskunit import (
    GlobalTaskUnitScheduler,
    LocalTaskUnitScheduler,
    TaskUnitClient,
)
from harmony_tpu_torch.table.table import DenseTable


class DolphinJobEntity:
    def __init__(
        self,
        config: JobConfig,
        global_taskunit: Optional[GlobalTaskUnitScheduler] = None,
        local_taskunit: Optional[LocalTaskUnitScheduler] = None,
    ) -> None:
        self.config = config
        self._global_tu = global_taskunit
        self._local_tu = local_taskunit
        self._master: Optional[ETMaster] = None
        self._table: Optional[Table] = None
        self._local: Optional[DenseTable] = None
        self._executor_ids: List[str] = []
        self._data_arrays: List[np.ndarray] = []
        self._setup_start = 0.0
        # per-worker batch progress of the last run (resume floors, A.7)
        self.progress: Optional[BatchProgressTracker] = None

    def _make_trainer(self) -> Trainer:
        if not self.config.trainer:
            raise ValueError(f"job {self.config.job_id}: no trainer configured")
        return resolve_symbol(self.config.trainer)(**self.config.params.app_params)

    def _data_source_key(self) -> "tuple | None":
        """Identity of this job's data source: the generator's dotted path and
        its canonicalized args. Jobs that share it share the host arrays and
        the device-resident batches (data/devcache.py). None when an arg is
        unhashable."""
        user = self.config.user

        def tag(v):
            # type-tagged recursively: True == 1 == 1.0 must not collide, as
            # a data_fn may behave differently by type
            if isinstance(v, (list, tuple)):
                return (type(v).__name__, tuple(tag(x) for x in v))
            return (type(v).__name__, v)

        try:
            args = tuple(sorted(
                (k, tag(v)) for k, v in user.get("data_args", {}).items()))
            hash(args)
        except TypeError:
            return None
        return (user.get("data_fn"), args)

    def _make_data(self) -> List[np.ndarray]:
        """The job's dataset. Jobs with the SAME (data_fn, data_args) see the
        same dataset by definition: the host arrays are cached under the
        source key (``devcache.host_data``), so a second submission does not
        call ``data_fn`` again. A source that must differ per job varies its
        args (a seed)."""
        user = self.config.user
        if "data_fn" not in user:
            raise ValueError(f"job {self.config.job_id}: user.data_fn missing")
        key = self._data_source_key()
        cached = devcache.host_data.get(key)
        if cached is not None:
            return cached
        out = resolve_symbol(user["data_fn"])(**user.get("data_args", {}))
        arrays = [np.asarray(a)
                  for a in (out if isinstance(out, (tuple, list)) else (out,))]
        devcache.host_data.put(key, arrays)
        return arrays

    def _create(self, master: ETMaster, table_cfg, executor_ids) -> Table:
        return master.create_table(
            table_cfg.replace(table_id=f"{self.config.job_id}:{table_cfg.table_id}"),
            executor_ids)

    def setup(self, master: ETMaster, executor_ids: List[str]) -> None:
        """Create the job's tables on its executors' device (or take a
        reference to the shared table ``config.tables`` names) and
        materialize its data."""
        self._setup_start = time.perf_counter()
        self._master = master
        cfg = self.config
        probe = self._make_trainer()
        if cfg.tables:
            # an explicit table id is shared state: reuse the table if it
            # exists (the reference reuses same-id tables across jobs)
            self._table, _ = master.get_or_create_table(cfg.tables[0], executor_ids)
        else:
            self._table = self._create(master, probe.model_table_config(), executor_ids)
        if probe.uses_local_table:
            self._local = self._create(master, probe.local_table_config(), executor_ids)
        self._executor_ids = list(executor_ids)
        self._data_arrays = self._make_data()

    def make_worker(self, idx: int = 0, num_workers: int = 1,
                    **worker_args: Any) -> WorkerTasklet:
        """Worker ``idx`` of ``num_workers`` over the tables and data that
        ``setup`` made: its slice of the data (the last worker takes the
        remainder), global init for worker 0 only. ``worker_args`` go to the
        WorkerTasklet (barriers, TaskUnit client, turn, epoch callback); with
        none, a lone worker outside any scheduler (fused windows)."""
        cfg = self.config
        nb = cfg.params.num_mini_batches
        n = len(self._data_arrays[0])
        if n < num_workers * nb:
            raise ValueError(f"job {cfg.job_id}: {n} examples cannot feed "
                             f"{num_workers} workers x {nb} mini-batches")
        per = n // num_workers
        lo = idx * per
        hi = (idx + 1) * per if idx < num_workers - 1 else n
        src = self._data_source_key()
        data = TrainingDataProvider(
            [a[lo:hi] for a in self._data_arrays], nb,
            dataset_key=None if src is None else (src, lo, hi, nb))
        ctx = TrainerContext(params=cfg.params, model_table=self._table,
                             local_table=self._local, worker_id=f"{cfg.job_id}/w{idx}",
                             num_workers=num_workers)
        return WorkerTasklet(cfg.job_id, ctx, self._make_trainer(), data,
                             global_init=(idx == 0), **worker_args)

    def run(self) -> Dict[str, Any]:
        cfg = self.config
        params = cfg.params
        # 0 means one worker per granted executor
        num_workers = cfg.num_workers or len(self._executor_ids)
        nb = params.num_mini_batches
        wids = [f"{cfg.job_id}/w{i}" for i in range(num_workers)]
        self.progress = BatchProgressTracker(nb)
        # single-worker jobs have no controller to feed the tracker: the
        # chief's epoch callback does
        tracker_hook = None
        if num_workers == 1:
            tracker, wid0 = self.progress, wids[0]

            def tracker_hook(e: int) -> None:
                tracker.on_batch(wid0, (e + 1) * nb - 1)

        # user.force_lockstep: the deterministic schedule (a DispatchTurnstile
        # cycles the workers' dispatch turns in a fixed order). The SSP slack
        # is at least 1 so the gate never blocks INSIDE a turn, and lockstep
        # workers take no TaskUnits (a quorum wait inside a turn would
        # deadlock the cycle): a determinism knob, not a scheduling mode.
        lockstep = num_workers > 1 and bool(cfg.user.get("force_lockstep"))
        turnstile = DispatchTurnstile(wids) if lockstep else None
        ctrl = (
            MiniBatchController(
                max(params.clock_slack, 1) if lockstep else params.clock_slack,
                params.num_epochs * nb, tracker=self.progress)
            if num_workers > 1 else None)
        wsm = WorkerStateManager(wids)
        # chief-only global init: the others wait here until it has run
        init_barrier = threading.Barrier(num_workers)
        if self._global_tu is not None:
            self._global_tu.on_job_start(cfg.job_id, wids)
        # a new thread starts on the default stream: every worker enqueues on
        # the stream the dispatch thread has, as a lone worker would
        device = self._table.device
        stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
        results: Dict[str, Any] = {}
        errors: List[BaseException] = []

        def run_worker(idx: int) -> None:
            wid = wids[idx]
            try:
                wsm.await_barrier(wid, "INIT")
                taskunit = (
                    TaskUnitClient(cfg.job_id, wid, self._global_tu, self._local_tu)
                    if self._global_tu is not None and self._local_tu is not None
                    and not lockstep else None)
                worker = self.make_worker(
                    idx, num_workers,
                    batch_barrier=ctrl.make_barrier(wid) if ctrl is not None else None,
                    taskunit=taskunit,
                    post_init_barrier=init_barrier.wait,
                    dispatch_turn=((lambda: turnstile.turn(wid))
                                   if turnstile is not None else None),
                    epoch_callback=tracker_hook if idx == 0 else None)
                scope = (torch.cuda.stream(stream) if stream is not None
                         else contextlib.nullcontext())
                with scope:
                    results[wid] = worker.run()
            except BaseException as e:  # noqa: BLE001 - raised by run() below
                errors.append(e)
                # a worker that dies before the init barrier must break it,
                # or every other worker waits there forever
                init_barrier.abort()
            finally:
                if turnstile is not None:
                    turnstile.leave(wid)   # a finished worker must not stall the cycle
                if ctrl is not None:
                    ctrl.deregister_worker(wid)  # nor gate its siblings
                if self._global_tu is not None:
                    # shrink the quorum, or the siblings wait for this one's units
                    self._global_tu.on_executor_done(cfg.job_id, wid)
                wsm.await_barrier(wid, "CLEANUP", timeout=60)

        threads = [threading.Thread(target=run_worker, args=(i,),
                                    name=f"{cfg.job_id}-w{i}", daemon=True)
                   for i in range(num_workers)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            if self._global_tu is not None:
                self._global_tu.on_job_finish(cfg.job_id)
        if errors:
            raise errors[0]
        # perf_counter from the start of setup (tables, data) to the workers' end
        return {"job_id": cfg.job_id,
                "workers": {w: results[w] for w in wids},
                "span": [self._setup_start, time.perf_counter()]}

    def cleanup(self) -> None:
        """Release the job's references to its tables (a shared table lives
        on while another holder has it). Idempotent: each reference is
        cleared before it is dropped."""
        for name in ("_table", "_local"):
            table = getattr(self, name)
            setattr(self, name, None)
            if self._master is not None and table is not None:
                self._master.drop_table(table.spec.table_id)


class PregelJobEntity:
    """A vertex-centric BSP job (the reference's ``PregelJobEntity``). Its one
    worker takes a COMP unit a superstep when the JobServer gives it
    TaskUnit schedulers."""

    def __init__(
        self,
        config: JobConfig,
        global_taskunit: Optional[GlobalTaskUnitScheduler] = None,
        local_taskunit: Optional[LocalTaskUnitScheduler] = None,
    ) -> None:
        self.config = config
        self._global_tu = global_taskunit
        self._local_tu = local_taskunit
        self._pregel_master: Optional[PregelMaster] = None
        self._registered = False

    def setup(self, master: ETMaster, executor_ids: List[str]) -> None:
        cfg = self.config
        user = cfg.user
        if "graph_fn" not in user:
            raise ValueError(f"job {cfg.job_id}: user.graph_fn missing")
        graph = resolve_symbol(user["graph_fn"])(**user.get("graph_args", {}))
        comp_cls = resolve_symbol(cfg.trainer)
        app_params = dict(cfg.params.app_params)
        if "graph" in inspect.signature(comp_cls.__init__).parameters:
            app_params["graph"] = graph
        devices = {master.executor(e).device for e in executor_ids}
        if len(devices) != 1:
            raise NotImplementedError(
                f"job {cfg.job_id}: executors {list(executor_ids)} span devices "
                f"{sorted(map(str, devices))}; a Pregel job runs on one device")
        computation = comp_cls(**app_params)
        taskunit = None
        if self._global_tu is not None and self._local_tu is not None:
            wid = f"{cfg.job_id}/w0"
            self._global_tu.on_job_start(cfg.job_id, [wid])
            self._registered = True
            taskunit = TaskUnitClient(cfg.job_id, wid, self._global_tu, self._local_tu)
        try:
            self._pregel_master = PregelMaster(
                graph, computation, devices.pop(),
                max_supersteps=int(user.get("max_supersteps", 100)),
                taskunit=taskunit, job_id=cfg.job_id)
        except BaseException:
            self._deregister()  # a failed setup must not leave a stale quorum
            raise

    def _deregister(self) -> None:
        if self._registered:
            self._global_tu.on_executor_done(self.config.job_id,
                                             f"{self.config.job_id}/w0")
            self._global_tu.on_job_finish(self.config.job_id)
            self._registered = False

    def run(self) -> Dict[str, Any]:
        # a job that dies mid-superstep must not leave its quorum entry behind
        try:
            return self._pregel_master.run()
        finally:
            self._deregister()

    def cleanup(self) -> None:
        if self._pregel_master is not None:
            self._pregel_master.close()
        self._pregel_master = None


def build_entity(config: JobConfig, **kwargs: Any):
    """The app-type switch (the reference's ``JobEntity.getJobEntity``);
    ``kwargs`` are the TaskUnit schedulers."""
    if config.app_type == "dolphin":
        return DolphinJobEntity(config, **kwargs)
    if config.app_type == "pregel":
        return PregelJobEntity(config, **kwargs)
    raise ValueError(f"unknown app_type {config.app_type!r}")
