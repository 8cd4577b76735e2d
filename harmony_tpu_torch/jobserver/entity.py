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
``PregelMaster`` holds the vertex and message tables sharded over the mesh of
the executors' slots (``build_mesh(slots, data=1)``, as the reference's
entity builds it; ``user["data_axis"]`` does not apply to a graph job) and
takes a COMP unit a superstep; cleanup closes it, which drops every shard.

Checkpoint chains (``TrainerParams.model_chkp_period`` = N): the chief's
epoch hook snapshots the model table every N epochs into the job's chain
under the server's ``chkp_root`` (a temporary directory without one),
asynchronously (``dolphin/evaluator.py::ModelChkpManager``), and the
worker's windows stay at one epoch so each snapshot holds its own epoch's
state; the result lists the chain (``model_chkp_ids``, ``model_chkp_root``,
``model_chkp_stats``). A job submitted with ``user["resume_from_chain"]``
rebuilds its model table from the newest committed entry of its chain (a
corrupt or torn entry is quarantined and the previous one tried), skips the
global init and continues at that entry's epoch + 1. With
``offline_model_eval``, :meth:`DolphinJobEntity.deferred_evaluation` hands
the JobServer the closure that evaluates the chain at shutdown and deletes
it.

Metrics and the optimizer loop: under a JobServer each worker's drain emits
one ``BatchMetrics`` a batch into the server's ``MetricManager``, and the
chief's epoch hook one ``ServerMetrics`` an owning executor an epoch (its
block count and a block-proportional share of the job's pulls and pushes).
``JobConfig.optimizer`` names an optimizer (``_OPTIMIZERS``, or a dotted
path): the job's :class:`~harmony_tpu_torch.optimizer.OptimizationOrchestrator`
then runs on a timer of ``optimizer_period`` seconds beside the workers,
turning the metrics into plans that move the model table's blocks while the
job trains (the reference's ETOptimizationOrchestrator). One loop a table:
a tenant of a shared table whose loop already runs trains without one.

On a pod (``jobserver/pod.py``) every participating process builds the same
entity from the same config, and the whole dataset; ``user["data_axis"]``
holds there too, its data rows computed by the processes holding their
slots (``dolphin/worker.py::_DataParallelStep``), and the worker's result
lists the rows this process computed (``data_rows``). Moves, an optimizer
and elastic recovery of a table whose rows lie in different processes are
refused (``runtime/master.py::ROWS_APART``). A job whose executors lie in
several processes takes ``pod_unit_scope`` and ``pod_unit_contended`` from
the cross-job unit protocol (``runtime/podunits.py``): set-up, and every
dispatch region of its workers or its superstep loop, run inside
leader-granted units, so
overlapping tenants enter their collectives in one pod-wide order, and such
a job drops the local TaskUnit admission. Several workers of such a job take
turns in a ``DispatchTurnstile`` (its SSP slack at least 1), so every process
enqueues in the same order.

Chains on a pod: the chief's hook takes the pod's synchronous collective
checkpoint (each process stages its own blocks into the shared
``chkp_root``), inside the chief's turnstile turn, for any worker count; a
resume restores the newest entry onto the grant, each process installing its
own shards. With ``offline_model_eval`` the leader's deferred evaluation is a
pod collective: it broadcasts the chain through the pod's evaluation channel
(``pod_eval_channel``, ``jobserver/pod.py``), every process restores and
evaluates each entry, and the leader alone deletes them. A job wholly on a
follower evaluates there at shutdown. The guards are the reference's, decided
from the config and the grant alone (:func:`_pod_guards`), so every process
raises alike.

Plans on a pod: the leader's ``schedule_pod_reshard`` broadcasts a move
(``jobserver/podplan.py``), and every process of the job applies it at the
chief's epoch hook of the plan's epoch (``_make_pod_plan_hook``), inside the
chief's pod unit and turnstile turn; the chief's windows end at that epoch
(``pending_plan_epoch``). A move that would change the processes owning the
table is skipped and recorded; the result's ``applied_plans`` lists every
plan. The optimizer loop of a job over several processes runs on the leader
only and hands its move-only plans to that channel
(``_make_pod_plan_adapter``).

Elastic recovery (``jobserver/elastic.py``, the pod's ``_dispatch_elastic``):
a job flagged ``user.elastic_shrink`` keeps a host copy of this process's
blocks at each chain entry (``recovery_retain``, unless
``HARMONY_ELASTIC_CACHE=0``). A fence plan (``elastic_fence``) ends the
attempt at the chief's hook of its epoch, right after the chain hook has
snapshotted that epoch, by raising :class:`ElasticFence` in every process. The
next attempt's config carries ``user.elastic_recovery`` (its attempt index,
the kind, the lost executors, and the epoch the newest chain entry resumes
at, from which the leader places a later fence): set-up then rebuilds the
model table from the newest chain entry through
``CheckpointManager.restore_partial`` (a
corrupt or torn entry is quarantined and the previous one tried), which
reads only the blocks this process's recovery cache lacks, and resumes at
that entry's epoch + 1. The result carries the restore's accounting
(``elastic_restore``), also recorded as an ``elastic_restore`` event
(``jobserver/joblog.py``). Worker-local tables are refused there, as for a
resume.
"""
from __future__ import annotations

import contextlib
import inspect
import logging
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

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
from harmony_tpu_torch.metrics.collector import MetricCollector, ServerMetrics
from harmony_tpu_torch.jobserver import podplan
from harmony_tpu_torch.jobserver.elastic import ElasticFence, attempt_of
from harmony_tpu_torch.metrics.manager import MetricManager
from harmony_tpu_torch.parallel import multihost
from harmony_tpu_torch.parallel.mesh import build_mesh
from harmony_tpu_torch.pregel.master import PregelMaster
from harmony_tpu_torch.runtime.master import (
    ROWS_APART,
    ETMaster,
    Table,
    TableHandle,
    data_rows_apart,
)
from harmony_tpu_torch.runtime.taskunit import (
    GlobalTaskUnitScheduler,
    LocalTaskUnitScheduler,
    TaskUnitClient,
)
from harmony_tpu_torch.table.table import DenseTable

log = logging.getLogger(__name__)

# what a plan's entry in ``plan_moves`` keeps of ``blockmove.last_move_stats``
_MOVE_KEYS = ("transport", "blocks_sent", "bytes_sent", "blocks_received", "bytes_received",
              "total_moves", "block_nbytes", "transport_retries", "seconds")


class DolphinJobEntity:
    def __init__(
        self,
        config: JobConfig,
        global_taskunit: Optional[GlobalTaskUnitScheduler] = None,
        local_taskunit: Optional[LocalTaskUnitScheduler] = None,
        chkp_root: Optional[str] = None,
        metric_sink: Optional[Callable[[Any], None]] = None,
        metric_manager: Optional[MetricManager] = None,
        pod_unit_scope: Optional[Callable[[], Any]] = None,
        pod_unit_contended: Optional[Callable[[], bool]] = None,
        pod_plan_sink: Optional[Callable[..., None]] = None,
        pod_eval_channel: Optional[Callable[..., None]] = None,
    ) -> None:
        self.config = config
        self._global_tu = global_taskunit
        self._local_tu = local_taskunit
        # the cross-job unit protocol's client (a job over several processes
        # of a pod): every dispatch region runs in a leader-granted unit
        self._pod_unit_scope = pod_unit_scope
        self._pod_unit_contended = pod_unit_contended
        # the pod leader's plan channel (PodJobServer.schedule_pod_reshard):
        # the optimizer loop hands its plans there instead of executing them
        self._pod_plan_sink = pod_plan_sink
        # the pod leader's collective evaluation channel (PodJobServer's
        # _pod_eval_channel): the followers replay the chain with the leader
        self._pod_eval_channel = pod_eval_channel
        # the pod plans this job applied (or skipped) at the chief's epoch hook,
        # and this process's side of each one that moved bytes
        self._applied_plans: List[Dict[str, Any]] = []
        self._plan_moves: List[Dict[str, Any]] = []
        # the JobServer's MetricManager (its on_metric is the sink)
        self._metric_sink = metric_sink
        self._metric_manager = metric_manager
        self._workers: List[WorkerTasklet] = []
        # where the job's checkpoint chain lives (None: a temporary directory)
        self.chkp_root = chkp_root
        self._starting_epoch = 0       # > 0 when resumed from a chain
        self._chkp_counter_base = 0    # a resumed chain continues its numbering
        self._chkp_mgr = None
        self._chkp_chain = None
        self._chkp_dir: Optional[str] = None
        self._master: Optional[ETMaster] = None
        self._table: Optional[Table] = None
        self._local: Optional[DenseTable] = None
        self._executor_ids: List[str] = []
        self._data_arrays: List[np.ndarray] = []
        self._setup_start = 0.0
        self._setup_wall = 0.0
        # an elastic attempt's restore accounting (jobserver/elastic.py)
        self._elastic_restore: Optional[Dict[str, Any]] = None
        # the running job's SSP controller (a multi-worker job), which an
        # elastic fence stops
        self._ctrl: Optional[MiniBatchController] = None
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

    def _create(self, master: ETMaster, table_cfg, executor_ids, data_axis: int) -> Table:
        return master.create_table(
            table_cfg.replace(table_id=f"{self.config.job_id}:{table_cfg.table_id}"),
            executor_ids, data_axis)

    def setup(self, master: ETMaster, executor_ids: List[str]) -> None:
        """Create the job's tables over all its executors (or take a
        reference to the shared table ``config.tables`` names), on a mesh
        ``user["data_axis"]`` rows deep (default 1: the blocks split over
        every executor), and materialize its data. On a pod, in one unit."""
        _pod_guards(self.config, master, executor_ids, self.chkp_root,
                    self._pod_eval_channel is not None)
        scope = (self._pod_unit_scope() if self._pod_unit_scope is not None
                 else contextlib.nullcontext())
        with scope:
            self._setup_inner(master, executor_ids)

    def _setup_inner(self, master: ETMaster, executor_ids: List[str]) -> None:
        self._setup_start = time.perf_counter()
        self._setup_wall = time.time()
        self._master = master
        cfg = self.config
        data_axis = max(1, int(cfg.user.get("data_axis", 1)))
        probe = self._make_trainer()
        if cfg.tables:
            # an explicit table id is shared state: reuse the table if it
            # exists (the reference reuses same-id tables across jobs)
            self._table, _ = master.get_or_create_table(cfg.tables[0], executor_ids,
                                                        data_axis)
        elif cfg.user.get("elastic_recovery"):
            # the same submission on a changed executor set: read only the
            # blocks this process's recovery cache lacks
            if probe.uses_local_table:
                raise ValueError(
                    f"job {cfg.job_id}: elastic recovery does not cover "
                    "worker-local tables (their state is not chained)")
            self._table, self._starting_epoch, self._chkp_counter_base = (
                self._restore_elastic(master, executor_ids, data_axis))
        elif cfg.user.get("resume_from_chain"):
            if probe.uses_local_table:
                raise ValueError(
                    f"job {cfg.job_id}: resume_from_chain does not cover "
                    "worker-local tables (their state is not chained)")
            self._table, self._starting_epoch, self._chkp_counter_base = (
                self._restore_chain(master, executor_ids, data_axis))
        else:
            self._table = self._create(master, probe.model_table_config(), executor_ids,
                                       data_axis)
        if probe.uses_local_table:
            self._local = self._create(master, probe.local_table_config(), executor_ids,
                                       data_axis)
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
        wid = f"{cfg.job_id}/w{idx}"
        ctx = TrainerContext(params=cfg.params, model_table=self._table,
                             local_table=self._local, worker_id=wid,
                             num_workers=num_workers)
        if self._metric_sink is not None:
            worker_args.setdefault("collector", MetricCollector(
                sink=self._metric_sink, job_id=cfg.job_id, worker_id=wid))
        # a resumed job must not run global init again: the restored table
        # holds trained state, and an additive init would change it
        return WorkerTasklet(cfg.job_id, ctx, self._make_trainer(), data,
                             global_init=(idx == 0 and self._starting_epoch == 0),
                             starting_epoch=self._starting_epoch, **worker_args)

    # -- checkpoint chains -------------------------------------------------

    def _chain_scan(self, why: str):
        """The job's epoch-tagged chain entries under ``chkp_root``, newest
        first by the epoch tag (``created_at`` breaks ties), and the counter
        base past every existing entry. A torn manifest is quarantined
        during the scan. Returns (manager, ordered infos, counter base)."""
        from harmony_tpu_torch.checkpoint.manager import (
            CheckpointCorruptError,
            CheckpointManager,
        )

        cfg = self.config
        if self.chkp_root is None:
            raise ValueError(f"job {cfg.job_id}: {why} needs the server's chkp_root "
                             "(the chain lives there)")
        mgr = CheckpointManager.for_job(self.chkp_root, cfg.job_id)
        infos = []
        for cid in mgr.list_checkpoints():
            if not cid.startswith(f"{cfg.job_id}:"):
                continue
            try:
                info = mgr.info(cid)
            except CheckpointCorruptError as e:
                # a torn manifest can never restore: quarantine it now, so no
                # later scan trips on it either
                log.warning("job %s: chain entry %s has a torn manifest (%s); "
                            "quarantined", cfg.job_id, cid, e)
                mgr.quarantine(cid)
                continue
            if info.app_meta is None or "epoch" not in info.app_meta:
                continue  # not a chain entry
            infos.append(info)
        if not infos:
            raise ValueError(f"job {cfg.job_id}: {why} found no epoch-tagged chain "
                             f"checkpoints under {self.chkp_root}")

        def counter_of(cid: str) -> int:
            try:
                return int(cid.rsplit("-", 2)[1])
            except (ValueError, IndexError):
                return 0

        base = max(counter_of(i.chkp_id) for i in infos)
        ordered = sorted(infos, key=lambda i: (int(i.app_meta["epoch"]), i.created_at),
                         reverse=True)
        return mgr, ordered, base

    def _restore_chain(self, master: ETMaster, executor_ids: List[str], data_axis: int):
        """Rebuild the model table from the newest chain entry that restores;
        a corrupt or torn entry is quarantined and the previous one tried.
        The entry tagged epoch e covers epochs 0..e, so training resumes at
        e + 1; a single-worker resume is exact (the snapshot is a clean
        epoch cut). On a grant over several processes every process restores
        the same entry (each reads every block, so each sees a corrupt one)
        and installs its own shards. Returns (table, starting_epoch,
        counter_base)."""
        from harmony_tpu_torch.checkpoint.manager import CheckpointCorruptError

        mgr, ordered, base = self._chain_scan("resume_from_chain")
        failures = []
        for info in ordered:
            try:
                handle = mgr.restore(master, info.chkp_id, executor_ids, data_axis)
            except (CheckpointCorruptError, FileNotFoundError) as e:
                log.warning("job %s: chain entry %s is corrupt or torn (%s: %s); "
                            "quarantined, falling back to the previous entry",
                            self.config.job_id, info.chkp_id, type(e).__name__, e)
                failures.append((info.chkp_id, f"{type(e).__name__}: {e}"))
                mgr.quarantine(info.chkp_id)
                continue
            return handle.table, int(info.app_meta["epoch"]) + 1, base
        raise ValueError(f"job {self.config.job_id}: every chain checkpoint failed "
                         f"integrity on restore (all quarantined): {failures}")

    def _restore_elastic(self, master: ETMaster, executor_ids: List[str], data_axis: int):
        """The shrink or re-grow restore: the newest chain entry through
        ``restore_partial`` (the recovery cache first, storage only for what
        this process lacks), with :meth:`_restore_chain`'s fallback past a
        corrupt or torn entry. Keeps the accounting in ``_elastic_restore``
        and records it as an ``elastic_restore`` event. Returns (table,
        starting_epoch, counter_base)."""
        from harmony_tpu_torch import faults
        from harmony_tpu_torch.checkpoint.manager import CheckpointCorruptError
        from harmony_tpu_torch.jobserver.joblog import job_logger
        from harmony_tpu_torch.table import ownership

        cfg = self.config
        rec = cfg.user.get("elastic_recovery") or {}
        jlog = job_logger(cfg.job_id)
        mgr, ordered, base = self._chain_scan("elastic recovery")
        failures = []
        for info in ordered:
            if faults.armed():
                faults.site("elastic.restore", chkp_id=info.chkp_id,
                            attempt=int(rec.get("attempt", 0)))
            t0 = time.perf_counter()
            try:
                handle, stats = mgr.restore_partial(master, info.chkp_id, executor_ids,
                                                    data_axis)
            except (CheckpointCorruptError, FileNotFoundError) as e:
                jlog.warning("elastic recovery: chain entry %s is corrupt or torn "
                             "(%s: %s); quarantined, falling back", info.chkp_id,
                             type(e).__name__, e)
                failures.append((info.chkp_id, f"{type(e).__name__}: {e}"))
                mgr.quarantine(info.chkp_id)
                continue
            seconds = time.perf_counter() - t0
            lost = [e for e in rec.get("lost_executors", []) if e in info.executors]
            plan = None
            if lost:
                try:
                    plan = ownership.shrink_plan(info.ownership, info.executors, lost,
                                                 executor_ids)
                except ValueError:
                    plan = None
            resumed = int(info.app_meta["epoch"]) + 1
            self._elastic_restore = {
                "attempt": int(rec.get("attempt", 0)),
                "kind": rec.get("kind", "shrink"),
                "chkp_id": info.chkp_id,
                "resumed_epoch": resumed,
                "executors": list(executor_ids),
                "lost_executors": lost,
                "lost_block_count": len(plan["lost"]) if plan else 0,
                **stats,
                "seconds": seconds,
            }
            jlog.event("elastic_restore", recovery=self._elastic_restore["kind"],
                       process=multihost.process_index(),
                       **{k: v for k, v in self._elastic_restore.items()
                          if k not in ("executors", "kind")})
            return handle.table, resumed, base
        raise ValueError(f"job {cfg.job_id}: every chain checkpoint failed integrity "
                         f"during elastic recovery (all quarantined): {failures}")

    def _make_chain(self):
        """The chief's chain hook when ``model_chkp_period`` > 0, else None."""
        from harmony_tpu_torch.checkpoint.manager import CheckpointManager
        from harmony_tpu_torch.dolphin.evaluator import ModelChkpManager

        cfg = self.config
        if cfg.params.model_chkp_period <= 0:
            return None
        root = self.chkp_root or tempfile.mkdtemp(prefix=f"harmony-chkp-{cfg.job_id}-")
        self._chkp_dir = root
        self._chkp_mgr = CheckpointManager.for_job(root, cfg.job_id)
        if cfg.user.get("elastic_shrink"):
            # the recovery cache: a shrink restore then reads only the blocks
            # that died with a peer
            from harmony_tpu_torch.jobserver import elastic

            self._chkp_mgr.recovery_retain = elastic.cache_enabled()
        if self._chkp_counter_base:
            # a resumed job continues its chain's numbering
            self._chkp_mgr.advance_counter(self._chkp_counter_base)
        handle = TableHandle(self._master, self._table, self._executor_ids)
        self._chkp_chain = ModelChkpManager(self._chkp_mgr, handle,
                                            period=cfg.params.model_chkp_period)
        return self._chkp_chain.on_epoch

    def deferred_evaluation(self):
        """The closure replaying this job's chain through the trainer's
        evaluation, or None (no chain, or no ``offline_model_eval``).

        The JobServer registers it after a successful run and calls it at
        graceful shutdown (the reference's JobServerDriver.java:178-214). Test
        data resolves inside the closure (``user["test_data_fn"]``, else the
        training data), so nothing large is held until then. The replayed
        entries are deleted: the evaluation is the chain's consumer.

        On a table over several processes the evaluation is a collective: the
        closure opens the pod's evaluation channel first (the followers stage
        what they need and enter the same restores and evaluations only once
        all are ready), evaluates, and closes it in a ``finally``; only the
        leader deletes the entries."""
        if self._chkp_chain is None or not self.config.params.offline_model_eval:
            return None
        chkp_ids = list(self._chkp_chain.chkp_ids)
        if not chkp_ids:
            return None
        cfg, mgr, executor_ids = self.config, self._chkp_mgr, list(self._executor_ids)
        channel = (self._pod_eval_channel
                   if len(self._table.mesh.processes) > 1 else None)

        def run_eval(master: ETMaster) -> List[Dict[str, float]]:
            from harmony_tpu_torch.dolphin.evaluator import (
                ModelEvaluator,
                resolve_eval_inputs,
            )

            # the one resolution the followers make too: identical collectives
            trainer, batch = resolve_eval_inputs(cfg)
            if channel is None:
                metrics = ModelEvaluator(master, mgr).evaluate_checkpoints(
                    chkp_ids, trainer, batch, executor_ids)
            else:
                channel("start", cfg.job_id, {"chkp_ids": chkp_ids})
                try:
                    metrics = ModelEvaluator(master, mgr).evaluate_checkpoints(
                        chkp_ids, trainer, batch, executor_ids)
                finally:
                    channel("finish", cfg.job_id)
            for cid in chkp_ids:
                mgr.delete(cid)
            return metrics

        return run_eval

    def run(self) -> Dict[str, Any]:
        cfg = self.config
        params = cfg.params
        # 0 means one worker per granted executor
        num_workers = cfg.num_workers or len(self._executor_ids)
        nb = params.num_mini_batches
        wids = [f"{cfg.job_id}/w{i}" for i in range(num_workers)]
        # a resumed job never reports progress below its resume point
        self.progress = BatchProgressTracker(nb, floor_batch=self._starting_epoch * nb)
        # single-worker jobs have no controller to feed the tracker: the
        # chief's epoch callback does
        tracker_hook = None
        if num_workers == 1:
            tracker, wid0 = self.progress, wids[0]

            def tracker_hook(e: int) -> None:
                tracker.on_batch(wid0, (e + 1) * nb - 1)

        chain_hook = self._make_chain()
        tm_hook = self._make_table_metrics_hook()
        # on a pod the plans apply after the epoch's other hooks, at the one
        # point every process reaches at the same epoch; an elastic job takes
        # its fences there on any server
        on_pod = multihost.is_multihost() or bool(cfg.user.get("elastic_shrink"))
        plan_hook = self._make_pod_plan_hook() if on_pod else None
        hooks = [h for h in (tracker_hook, chain_hook, tm_hook, plan_hook) if h is not None]
        job_id = cfg.job_id
        attempt = attempt_of(cfg)

        def plan_epoch() -> Optional[int]:
            return podplan.next_epoch(job_id)

        def epoch_hook(e: int) -> None:
            for h in hooks:
                h(e)

        # user.force_lockstep, and every multi-worker job over several
        # processes: the deterministic schedule (a DispatchTurnstile cycles
        # the workers' dispatch turns in a fixed order, the same in every
        # process). The SSP slack is at least 1 so the gate never blocks
        # INSIDE a turn, and lockstep workers take no TaskUnits (a quorum
        # wait inside a turn would deadlock the cycle). A pod-unit job drops
        # them too: ordering and fairness come from the pod's arbiter.
        procs = {self._master.executor(e).slot.process_index for e in self._executor_ids}
        lockstep = num_workers > 1 and (len(procs) > 1 or bool(cfg.user.get("force_lockstep")))
        turnstile = DispatchTurnstile(wids) if lockstep else None
        ctrl = self._ctrl = (
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
                    and not lockstep and self._pod_unit_scope is None else None)
                worker = self.make_worker(
                    idx, num_workers,
                    batch_barrier=ctrl.make_barrier(wid) if ctrl is not None else None,
                    taskunit=taskunit,
                    post_init_barrier=init_barrier.wait,
                    dispatch_turn=self._dispatch_turn(turnstile, wid),
                    pod_contended=self._pod_unit_contended,
                    epoch_callback=epoch_hook if idx == 0 and hooks else None,
                    pending_plan_epoch=plan_epoch if idx == 0 and on_pod else None,
                    attempt=attempt,
                    # the tracker only reads drained counters and may run after
                    # a multi-epoch window; a chain snapshots the table AT its
                    # epoch, so it keeps windows at one epoch
                    defer_epoch_callback=chain_hook is None)
                self._workers.append(worker)
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
        orchestrator = self._make_orchestrator()
        if orchestrator is not None:
            orchestrator.start()
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            if orchestrator is not None:
                orchestrator.stop()
                self._master.release_optimizer_lease(self._table.spec.table_id)
            if self._global_tu is not None:
                self._global_tu.on_job_finish(cfg.job_id)
        if errors:
            fence = next((e for e in errors if getattr(e, "elastic_fence", None)), None)
            if fence is not None and self._chkp_chain is not None:
                # the fence ends the attempt right after its epoch's chain
                # hook: join the writers, so the recovery point is committed
                # before the leader plans the next attempt
                try:
                    self._chkp_chain.drain()
                except BaseException:  # noqa: BLE001 - the fence still stands
                    pass
            if fence is not None:
                # the attempt's report: what the chief trained before the
                # fence, and the restore it started from
                chief = getattr(fence, "worker_result", {})
                fence.attempt_result = {
                    "job_id": cfg.job_id, "workers": {wids[0]: chief},
                    **({"train_wall": self._setup_wall + (
                        chief["train_span"][0] - self._setup_start)}
                       if "train_span" in chief else {}),
                    **({"elastic_restore": dict(self._elastic_restore)}
                       if self._elastic_restore is not None else {})}
                # the fence outranks a sibling's error while unwinding: the
                # elastic loop classifies on its marker
                raise fence
            raise errors[0]
        if tm_hook is not None:
            # the closing window: ops of peers that lagged the chief's last hook
            tm_hook(params.num_epochs)
        # perf_counter from the start of setup (tables, data) to the workers' end
        out = {"job_id": cfg.job_id,
               "workers": {w: results[w] for w in wids},
               "span": [self._setup_start, time.perf_counter()],
               # the wall clock at the chief's first epoch, the same clock in
               # every process of a host
               "train_wall": self._setup_wall + (
                   results[wids[0]]["train_span"][0] - self._setup_start)}
        if self._elastic_restore is not None:
            out["elastic_restore"] = dict(self._elastic_restore)
        if self._applied_plans:
            out["applied_plans"] = list(self._applied_plans)
        if self._plan_moves:
            out["plan_moves"] = list(self._plan_moves)
        if orchestrator is not None:
            out["reconfigs"] = len(orchestrator.reconfig_log)
            if orchestrator.errors:
                # failed rounds are visible in the result, not only in a list
                # that dies with the orchestrator
                out["optimizer_errors"] = [
                    f"{type(e).__name__}: {e}" for e in orchestrator.errors]
        if self._chkp_chain is not None:
            # join the writers before the table is dropped; the surviving ids
            # are the replayable chain. A checkpoint failure does not fail a
            # job whose training succeeded: it is reported beside the chain
            try:
                out["model_chkp_ids"] = self._chkp_chain.drain()
            except Exception as e:  # noqa: BLE001 - reported in the result
                out["model_chkp_ids"] = list(self._chkp_chain.chkp_ids)
                out["model_chkp_warning"] = f"{type(e).__name__}: {e}"
            out["model_chkp_root"] = self._chkp_dir
            out["model_chkp_stats"] = self._chkp_chain.stats
        return out

    def _dispatch_turn(self, turnstile, wid: str):
        """The worker's admission context for each dispatch region: its
        turnstile turn, the job's pod unit, both (the turn outside, the unit
        inside: the turnstile orders this process's threads, so the unit
        numbers stay the same in every process), or None."""
        scope = self._pod_unit_scope
        if turnstile is None:
            return scope
        if scope is None:
            return lambda: turnstile.turn(wid)

        @contextlib.contextmanager
        def composed():
            with turnstile.turn(wid):
                with scope():
                    yield

        return composed

    # -- the optimizer loop and its metrics --------------------------------

    _OPTIMIZERS = {
        "homogeneous": "harmony_tpu_torch.optimizer:HomogeneousOptimizer",
        "heterogeneous": "harmony_tpu_torch.optimizer:HeterogeneousOptimizer",
        "add_one_server": "harmony_tpu_torch.optimizer:AddOneServerOptimizer",
        "delete_one_server": "harmony_tpu_torch.optimizer:DeleteOneServerOptimizer",
        "empty": "harmony_tpu_torch.optimizer:EmptyPlanOptimizer",
    }

    def _make_orchestrator(self):
        """The job's elasticity loop (the reference's
        ETOptimizationOrchestrator run for each Dolphin job), or None:
        metrics -> Optimizer -> plan -> live migration of THIS job's model
        table while it trains. Enabled by ``JobConfig.optimizer`` (a registry
        name or a dotted path).

        On a table over several processes only the pod leader (process 0)
        runs the loop, and it hands each plan to the pod's plan channel
        (:meth:`_make_pod_plan_adapter`) for every process to apply at the
        same epoch; the followers apply plans and make none. The grant must
        hold process 0, a predicate of the config and the mesh alone, so
        every process refuses alike."""
        name = self.config.optimizer
        if not name:
            return None
        plan_sink = None
        mesh = self._table.mesh
        if len(mesh.processes) > 1:
            if 0 not in mesh.processes:
                raise ValueError(
                    f"job {self.config.job_id}: optimizer={name!r} on a multi-process "
                    "grant needs the grant to include the pod leader (process 0), "
                    "which runs the optimization loop and owns the plan channel")
            if multihost.process_index() != 0:
                return None
            if self._pod_plan_sink is None:
                raise ValueError(
                    f"job {self.config.job_id}: optimizer={name!r} on a multi-process "
                    "grant has no pod plan channel (running outside a PodJobServer?)")
            plan_sink = self._make_pod_plan_adapter()
        if self._metric_manager is None:
            raise ValueError(
                f"job {self.config.job_id}: optimizer={name!r} needs the "
                "jobserver's MetricManager (running outside a JobServer?)")
        table_id = self._table.spec.table_id
        # one optimization loop a table: a tenant attaching to a shared table
        # whose creator already optimizes it trains unoptimized rather than
        # racing competing migration plans
        if not self._master.acquire_optimizer_lease(table_id):
            return None
        try:
            from harmony_tpu_torch.optimizer import OptimizationOrchestrator

            cls = resolve_symbol(self._OPTIMIZERS.get(name, name))
            return OptimizationOrchestrator(
                self._master, self._master.table_handle(table_id), cls(),
                self._metric_manager, period_sec=self.config.optimizer_period,
                job_id=self.config.job_id, plan_sink=plan_sink)
        except BaseException:
            # run() releases through the orchestrator; a construction failure
            # would otherwise hold the lease for good
            self._master.release_optimizer_lease(table_id)
            raise

    def _make_pod_plan_adapter(self):
        """The optimizer's plans into the pod's plan channel: a move-only plan
        is scheduled at the current epoch + ``EPOCH_WINDOW`` + 2 (past the
        window horizon), one ``pod_plan_sink`` call a transfer step. A plan
        that adds or deletes executors is declined (the pod's topology is
        its processes' life cycle, not a table move), and so is a plan whose
        earliest safe epoch is past the job's end. Returns whether the plan
        was taken."""
        job_id = self.config.job_id
        sink = self._pod_plan_sink
        metrics = self._metric_manager
        # the highest epoch seen: a round after an accepted plan reads
        # cleared metrics and must not schedule behind the job's progress
        seen = {"hi": 0}

        def apply(dplan) -> bool:
            if dplan.evaluators_to_add or dplan.evaluators_to_delete:
                log.warning("job %s: pod optimization declined a plan that adds or "
                            "deletes executors (a pod takes move-only plans)", job_id)
                return False
            wm = metrics.worker_batch_metrics(job_id=job_id)
            cur = seen["hi"] = max(max((m.epoch_idx for m in wm), default=0), seen["hi"])
            epoch = cur + WorkerTasklet.EPOCH_WINDOW + 2
            if epoch >= self.config.params.num_epochs:
                log.warning("job %s: pod optimization declined: the earliest safe "
                            "apply epoch %d is past the job's end (%d epochs)",
                            job_id, epoch, self.config.params.num_epochs)
                return False
            for step in dplan.transfer_steps:
                sink(job_id, step.src, step.dst, step.num_blocks, epoch)
            return bool(dplan.transfer_steps)

        return apply

    def _make_pod_plan_hook(self):
        """Apply the job's pod plans at the chief's epoch hook, the point
        every process reaches at the same epoch (``jobserver/podplan.py``,
        ``PodJobServer.schedule_pod_reshard``); inside the chief's pod unit
        (and its turnstile turn in a multi-worker job), so every process
        moves the table at the same place in its dispatch order.

        The count is clamped to what ``src`` owns, and a plan that would
        change WHICH processes own blocks is skipped and recorded
        (``"skipped": "process-set change mid-training"``): a process that
        left the table's mesh would go on dispatching a step over slots it
        no longer shares. Each decision reads the block map, the same in
        every process. ``applied_plans`` records each plan: its epoch, src,
        dst, the blocks moved and the owners after. A plan that changed the
        table's layout also records this process's side of the exchange in
        ``plan_moves`` (``blockmove.last_move_stats``: blocks and bytes sent
        and received, the transport, seconds). An elastic fence (a plan with
        ``elastic_fence``) ends the attempt here instead: the SSP controller's
        stop releases the sibling workers, and :class:`ElasticFence` carries
        the marker the elastic dispatch loop classifies on."""
        from harmony_tpu_torch.table import blockmove

        job_id = self.config.job_id

        def hook(epoch_idx: int) -> None:
            for p in podplan.take(job_id, epoch_idx):
                if p.get("elastic_fence"):
                    if self._ctrl is not None:
                        self._ctrl.request_stop()
                    raise ElasticFence(str(p["elastic_fence"]), epoch_idx)
                handle = self.table_handle
                counts = handle.block_manager.block_counts()
                owned = counts.get(p["src"], 0)
                n = min(int(p["num_blocks"]), owned)
                skipped = None
                if n:
                    def owner_procs(cmap):
                        return {self._master.executor(e).slot.process_index
                                for e, c in cmap.items() if c > 0}

                    after = dict(counts)
                    after[p["src"]] = owned - n
                    after[p["dst"]] = after.get(p["dst"], 0) + n
                    if owner_procs(after) != owner_procs(counts):
                        skipped = "process-set change mid-training"
                        log.warning("job %s: pod plan %s->%s (%d blocks) skipped: it would "
                                    "change the processes that own the table", job_id,
                                    p["src"], p["dst"], n)
                        n = 0
                layout = handle.table.sharding
                if n:
                    handle.move_blocks(p["src"], p["dst"], n)
                entry = {"epoch": epoch_idx, "src": p["src"], "dst": p["dst"], "moved": n,
                         "owners_after": len(handle.owning_executors())}
                if handle.table.sharding is not layout:
                    st = blockmove.last_move_stats
                    self._plan_moves.append({**entry, **{k: st.get(k) for k in _MOVE_KEYS}})
                if skipped:
                    entry["skipped"] = skipped
                self._applied_plans.append(entry)

        return hook

    def _make_table_metrics_hook(self):
        """The per-epoch ``ServerMetrics`` report (the reference's ET
        MetricReportMsg built-ins: per-table block counts, pull and push
        counts, pulled bytes), or None without a sink. Each owning executor
        reports its block count and a block-proportional share of THIS job's
        op-counter deltas since the last report, split by largest remainder
        so the shares sum exactly to the total."""
        if self._metric_sink is None:
            return None
        from harmony_tpu_torch.optimizer.hetero import _largest_remainder as apportion

        last = {"pulls": 0, "pushes": 0, "pull_bytes": 0}
        job_id = self.config.job_id
        bm = TableHandle(self._master, self._table, self._executor_ids).block_manager

        def report(epoch_idx: int) -> None:
            stats = {k: 0 for k in last}
            for w in list(self._workers):
                for k in stats:
                    stats[k] += w.op_stats[k]
            delta = {k: stats[k] - last[k] for k in last}
            last.update(stats)
            owners = [(ex, n) for ex, n in bm.block_counts().items() if n > 0]
            weights = [n for _, n in owners]
            pulls = apportion(delta["pulls"], weights)
            pushes = apportion(delta["pushes"], weights)
            pbytes = apportion(delta["pull_bytes"], weights)
            for i, (ex, nblocks) in enumerate(owners):
                self._metric_sink(ServerMetrics(
                    job_id=job_id, executor_id=ex, window_idx=epoch_idx,
                    num_blocks=nblocks, pull_count=pulls[i], push_count=pushes[i],
                    pull_bytes=pbytes[i]))

        return report

    @property
    def table_handle(self) -> Optional[TableHandle]:
        """The job's model table with its executors (the serving plane's live
        table), or None before set-up and after cleanup."""
        table = self._table
        if table is None:
            return None
        return TableHandle(self._master, table, self._executor_ids)

    def cleanup(self) -> None:
        """Drop the job's unapplied pod plans (a resubmitted job id must not
        inherit them) and release its references to its tables (a shared
        table lives on while another holder has it). Idempotent: each
        reference is cleared before it is dropped."""
        podplan.clear(self.config.job_id)
        for name in ("_table", "_local"):
            table = getattr(self, name)
            setattr(self, name, None)
            if self._master is not None and table is not None:
                self._master.drop_table(table.spec.table_id)


class PregelJobEntity:
    """A vertex-centric BSP job (the reference's ``PregelJobEntity``) over all
    its executors: its tables shard over the mesh of their slots. Its one
    worker takes a COMP unit a superstep when the JobServer gives it
    TaskUnit schedulers."""

    def __init__(
        self,
        config: JobConfig,
        global_taskunit: Optional[GlobalTaskUnitScheduler] = None,
        local_taskunit: Optional[LocalTaskUnitScheduler] = None,
        pod_unit_scope: Optional[Callable[[], Any]] = None,
        pod_unit_contended: Optional[Callable[[], bool]] = None,
    ) -> None:
        self.config = config
        self._global_tu = global_taskunit
        self._local_tu = local_taskunit
        # supersteps run in the job's pod units (no window to shrink, so the
        # contended flag goes unread)
        self._pod_unit_scope = pod_unit_scope
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
        # every executor on the model axis, as the reference's entity builds
        # it (data=1 whatever user["data_axis"] says): the tables shard over
        # the job's slots
        mesh = build_mesh([master.executor(e).slot for e in executor_ids], data=1)
        computation = comp_cls(**app_params)
        taskunit = None
        if (self._global_tu is not None and self._local_tu is not None
                and self._pod_unit_scope is None):
            wid = f"{cfg.job_id}/w0"
            self._global_tu.on_job_start(cfg.job_id, [wid])
            self._registered = True
            taskunit = TaskUnitClient(cfg.job_id, wid, self._global_tu, self._local_tu)
        scope = (self._pod_unit_scope() if self._pod_unit_scope is not None
                 else contextlib.nullcontext())
        try:
            with scope:   # the tables' creation and seeding
                self._pregel_master = PregelMaster(
                    graph, computation, mesh,
                    max_supersteps=int(user.get("max_supersteps", 100)),
                    taskunit=taskunit, job_id=cfg.job_id,
                    dispatch_turn=self._pod_unit_scope)
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

    def deferred_evaluation(self):
        """None: a graph job has no model table and no chain to evaluate."""
        return None

    def cleanup(self) -> None:
        if self._pregel_master is not None:
            self._pregel_master.close()
        self._pregel_master = None


def _pod_guards(config: JobConfig, master: ETMaster, executor_ids: List[str],
                chkp_root: Optional[str], has_eval_channel: bool) -> None:
    """The reference's guards on chains and their evaluation over several
    processes (``harmony_tpu/jobserver/entity.py:487-534``), decided from the
    config and the grant (and, for the last, whether this is process 0), so
    every process raises alike:

      * a pod chain needs a shared ``chkp_root``: per-process temporary
        directories would each hold a fragment of every entry;
      * ``offline_model_eval`` on a multi-process grant needs process 0 in the
        grant: its JobServer runs the collective evaluation;
      * on process 0 that grant also needs the pod's evaluation channel (a
        PodJobServer's); the followers replay on its broadcast;

    and the port's own: an ``optimizer`` on a table whose data rows lie in
    different processes (its plans would move blocks under a layout no test
    holds: ``ROWS_APART``)."""
    procs = sorted({master.executor(e).slot.process_index for e in executor_ids})
    p, job = config.params, config.job_id
    if config.optimizer and data_rows_apart(
            [master.executor(e).slot for e in executor_ids],
            max(1, int(config.user.get("data_axis", 1)))):
        raise ValueError(f"job {job}: optimizer={config.optimizer!r} is refused: {ROWS_APART}")
    if len(procs) < 2 or p.model_chkp_period <= 0:
        return
    where = f"on a multi-process grant (processes {procs})"
    if chkp_root is None:
        raise ValueError(
            f"job {job}: a checkpoint chain {where} needs a SHARED chkp_root "
            "(per-process temporary directories would each hold only a fragment "
            "of every checkpoint)")
    if not p.offline_model_eval:
        return
    if 0 not in procs:
        raise ValueError(
            f"job {job}: offline_model_eval {where} needs the grant to include "
            "the pod leader (process 0), which runs the collective evaluation")
    if multihost.process_index() == 0 and not has_eval_channel:
        raise ValueError(
            f"job {job}: offline_model_eval {where} needs the pod's evaluation "
            "channel (running outside a PodJobServer?)")


def build_entity(config: JobConfig, chkp_root: Optional[str] = None, **kwargs: Any):
    """The app-type switch (the reference's ``JobEntity.getJobEntity``);
    ``kwargs`` are the TaskUnit schedulers and a Dolphin job's metric sink and
    manager, ``chkp_root`` the root of a Dolphin job's checkpoint chain (a
    graph job has no model table)."""
    if config.app_type == "dolphin":
        return DolphinJobEntity(config, chkp_root=chkp_root, **kwargs)
    if config.app_type == "pregel":
        # a graph job has no model table: no metric sources, no optimizer,
        # no plans
        kwargs.pop("metric_sink", None)
        kwargs.pop("metric_manager", None)
        kwargs.pop("pod_plan_sink", None)
        kwargs.pop("pod_eval_channel", None)
        return PregelJobEntity(config, **kwargs)
    raise ValueError(f"unknown app_type {config.app_type!r}")
