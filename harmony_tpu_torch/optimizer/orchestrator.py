"""OptimizationOrchestrator — the periodic metrics -> plan -> reshard loop.

Parity with the reference's ETOptimizationOrchestrator (optimizer/impl/
ETOptimizationOrchestrator.java:50-140): on a timer, (1) snapshot metrics,
(2) ask the Optimizer for a plan given currently-available evaluators,
(3) compile to the ET op DAG, (4) execute it (live migration), (5) notify
interested parties (here: metric collection pauses around the
reconfiguration so migration-skewed samples never feed the next decision —
ref: MetricManager pause/resume).

Simulated resource fluctuation: the reference toggles NumExtraResources on
a timer to emulate a dynamic cluster; ``available_fn`` plays that role
(defaults to the device pool's free capacity).

A copy of ``harmony_tpu/optimizer/orchestrator.py``. On a pod the leader's
loop takes a ``plan_sink`` (``jobserver/entity.py::_make_pod_plan_adapter``):
a plan is handed off there, for every process to apply at the same epoch,
and this thread executes nothing. A job's reconfiguration is logged through
``logging`` (the reference writes it to its job log).
"""
from __future__ import annotations

import logging
import re
import threading
from typing import Callable, Dict, List, Optional

from harmony_tpu_torch.metrics.manager import MetricManager
from harmony_tpu_torch.optimizer.api import DolphinPlan, EvaluatorParams, Optimizer
from harmony_tpu_torch.optimizer.compiler import PlanCompiler
from harmony_tpu_torch.plan.executor import PlanExecutor, PlanResult
from harmony_tpu_torch.runtime.master import ETMaster, TableHandle

log = logging.getLogger(__name__)


class OptimizationOrchestrator:
    def __init__(
        self,
        master: ETMaster,
        handle: TableHandle,
        optimizer: Optimizer,
        metrics: MetricManager,
        period_sec: float = 5.0,
        available_fn: Optional[Callable[[], int]] = None,
        job_id: Optional[str] = None,
        plan_sink: Optional[Callable[[DolphinPlan], bool]] = None,
    ) -> None:
        """``job_id`` scopes a multi-tenant deployment: the optimizer sees
        ONLY this job's metrics (another tenant's throughput must not steer
        this table's placement) and post-migration cleanup clears only this
        job's skewed samples instead of pausing/erasing every tenant's
        collection. None = single-tenant mode (whole-manager pause/clear,
        like the reference's per-driver orchestrator)."""
        self.master = master
        self.handle = handle
        self.optimizer = optimizer
        self.metrics = metrics
        self.period_sec = period_sec
        self.job_id = job_id
        self._available_fn = available_fn
        # on a pod, plans are HANDED OFF (plan_sink(dplan) -> accepted)
        # instead of executed from this thread: a move over several processes
        # is applied by every process at one epoch (jobserver/podplan.py)
        self._plan_sink = plan_sink
        self._compiler = PlanCompiler()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.reconfig_log: List[PlanResult] = []
        from collections import deque

        self.errors = deque(maxlen=16)  # failed rounds (loop continues)
        # Snapshot for worker->executor mapping (see _worker_executor_map).
        self._initial_executors: List[str] = list(handle.block_manager.executors)

    # -- one optimization round (callable directly for tests) ------------

    def _worker_executor_map(self, worker_metrics) -> Dict[str, str]:
        """Map jobserver worker ids ("<job>/wN") to the table's Nth
        associated executor (collocated PS: worker N runs on executor N).

        Indexes into the executor list AS OF ORCHESTRATOR CREATION (job
        setup): BlockManager.executors index-shifts when a plan unassociates
        an executor, which would silently re-key surviving workers to the
        wrong machines. Surviving workers keep their original executor;
        workers whose executor has since left the table are left unmapped
        (optimizers fall back to identity)."""
        current = set(self.handle.block_manager.executors)
        out: Dict[str, str] = {}
        for m in worker_metrics:
            wid = m.worker_id
            if wid in out:
                continue
            match = re.match(r".*/w(\d+)$", wid)
            if match and int(match.group(1)) < len(self._initial_executors):
                eid = self._initial_executors[int(match.group(1))]
                if eid in current:
                    out[wid] = eid
        return out

    def run_once(self) -> Optional[PlanResult]:
        worker_metrics = self.metrics.worker_batch_metrics(job_id=self.job_id)
        params = EvaluatorParams(
            worker_metrics=worker_metrics,
            server_metrics=self.metrics.server_metrics(job_id=self.job_id),
            table_id=self.handle.table_id,
            block_counts=self.handle.block_manager.block_counts(),
            worker_to_executor=self._worker_executor_map(worker_metrics),
        )
        # SPI contract: TOTAL executors the table may use = current owners +
        # free pool capacity (Optimizer.optimize docstring).
        avail = (
            self._available_fn()
            if self._available_fn is not None
            else len(self.master._pool)
            - len(self.master.executor_ids())
            + len(self.handle.block_manager.executors)
        )
        dplan = self.optimizer.optimize(params, avail)
        if dplan.empty:
            return None
        if self._plan_sink is not None:
            if not self._plan_sink(dplan):
                # a declined plan moved nothing: the metrics stay for the
                # next round
                return None
            # samples taken while the plan was decided must not feed the next
            # round; the move itself lands later, at its epoch
            self.metrics.clear(job_id=self.job_id)
            result = PlanResult()
            self.reconfig_log.append(result)
            return result
        plan = self._compiler.compile(dplan, self.handle.table_id)
        if self.job_id is not None:
            log.info("job %s: reconfiguring table %s: %s", self.job_id,
                     self.handle.table_id, dplan)
        # Migration-window samples are skewed and must not feed the next
        # round's cost estimate. Single-tenant: pause+clear the manager
        # (ref: MetricManager pause/resume). Multi-tenant (job_id set):
        # never touch other tenants' data — clear only this job's records
        # after the migration.
        if self.job_id is None:
            self.metrics.stop_collection()
        try:
            result = PlanExecutor(self.master).execute(plan)
        finally:
            self.metrics.clear(job_id=self.job_id)
            if self.job_id is None:
                self.metrics.start_collection()
        self.reconfig_log.append(result)
        return result

    # -- periodic loop ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("already started")
        self._stop.clear()

        def loop() -> None:
            # first round immediately: a job shorter than one period still
            # gets optimized once (then the periodic cadence takes over)
            while True:
                try:
                    self.run_once()
                except Exception as e:  # noqa: BLE001 - keep optimizing
                    self.errors.append(e)  # visible, never silently eaten
                if self._stop.wait(self.period_sec):
                    return

        self._thread = threading.Thread(target=loop, daemon=True, name="optimizer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None


class ResourceFluctuator:
    """Timer-toggled extra capacity — the reference's simulated dynamic
    cluster (ETOptimizationOrchestrator toggling NumExtraResources on a
    timer). Use as the orchestrator's ``available_fn``:

        fluct = ResourceFluctuator(base=4, num_extra=2, period_sec=30)
        OptimizationOrchestrator(..., available_fn=fluct)

    For ``period_sec`` seconds the extra resources are present, then absent,
    alternating. ``clock`` is injectable for deterministic tests.
    """

    def __init__(
        self,
        base: int,
        num_extra: int,
        period_sec: float,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        if base < 0 or num_extra < 0 or period_sec <= 0:
            raise ValueError("base/num_extra >= 0 and period_sec > 0 required")
        import time as _time

        self.base = base
        self.num_extra = num_extra
        self.period_sec = period_sec
        self._clock = clock or _time.monotonic
        self._t0 = self._clock()

    def extra_available(self) -> bool:
        phase = int((self._clock() - self._t0) / self.period_sec)
        return phase % 2 == 0

    def __call__(self) -> int:
        return self.base + (self.num_extra if self.extra_available() else 0)
