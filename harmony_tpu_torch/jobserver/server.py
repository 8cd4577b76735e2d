"""JobServer — the in-process multi-tenant job server.

Counterpart of ``harmony_tpu/jobserver/server.py``, cut to the in-process
core: ``start`` allocates the executors (one device each, from the
:class:`DevicePool`) and binds the scheduler; ``submit`` returns a ``Future``
of the job's result and hands the job to the scheduler; each launch runs on a
dispatch thread of its own (the entity's setup, run and cleanup), so the
default share-all scheduler runs every submitted job at once; ``shutdown``
stops accepting, waits for the jobs and joins their threads. Every job's
future resolves, to its result or to the exception that ended it, and the
scheduler hears of every finish. A job's entity comes from
``build_entity``'s app-type switch (``dolphin`` or ``pregel``). The pool is
every visible card unless the caller passes another
(``DevicePool([torch.device("cpu")])``).

TaskUnit admission (``runtime/taskunit.py``): the server owns one
``GlobalTaskUnitScheduler`` (the grant order across jobs) and one
``LocalTaskUnitScheduler`` (1 CPU and 2 NET slots), and hands both to every
entity, whose workers wrap each batch group, metric drain and init in a
unit. Execution metering is on only when every executor is a CPU, where a
scope's exit means its work is done; on the card a unit orders the host's
launches and does not hold the device.

Checkpoint chains: ``chkp_root`` is where the jobs' chains live (each job
under ``<chkp_root>/<job_id>``; without it a chaining job writes into a
temporary directory, and ``resume_from_chain`` has nothing to read). A job
with ``offline_model_eval`` registers its deferred evaluation after a
successful run; ``shutdown``, once the jobs have drained, runs each on a
thread of its own within its own ``timeout`` budget and records the
evaluations, or the error, in ``eval_results[job_id]``. A failed or timed-out
evaluation never fails the shutdown.

Not ported yet: the TCP control plane, HA, the policy engine, overload
control, history and doctor, metrics scraping and the serving plane
(ROADMAP A.10).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Union

from harmony_tpu_torch.config.params import JobConfig
from harmony_tpu_torch.jobserver.entity import build_entity
from harmony_tpu_torch.jobserver.scheduler import (
    JobScheduler,
    ShareAllScheduler,
    make_scheduler,
)
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.runtime.master import ETMaster
from harmony_tpu_torch.runtime.taskunit import (
    GlobalTaskUnitScheduler,
    LocalTaskUnitScheduler,
)


class JobServer:
    def __init__(
        self,
        num_executors: int,
        scheduler: Union[JobScheduler, str, None] = None,
        device_pool: Optional[DevicePool] = None,
        chkp_root: Optional[str] = None,
    ) -> None:
        if isinstance(scheduler, str):
            scheduler = make_scheduler(scheduler)
        self.master = ETMaster(device_pool)  # the default pool raises without a card
        self.global_taskunit = GlobalTaskUnitScheduler()
        self.local_taskunit = LocalTaskUnitScheduler()  # 1 CPU, 2 NET slots
        self._scheduler = scheduler or ShareAllScheduler()
        self._num_executors = num_executors
        self._lock = threading.Lock()
        self._state = "NOT_INIT"   # -> INIT (accepting) -> CLOSING -> CLOSED
        self._jobs: Dict[str, Future] = {}
        self._threads: List[threading.Thread] = []
        self._chkp_root = chkp_root
        # job id -> the closure of its deferred offline evaluation
        self._deferred_evals: Dict[str, Any] = {}
        # job id -> the evaluations of its chain, or {"error": ...}
        self.eval_results: Dict[str, Any] = {}

    @property
    def state(self) -> str:
        return self._state

    def start(self) -> None:
        """Allocate the executors and bind the scheduler; accept jobs."""
        with self._lock:
            if self._state != "NOT_INIT":
                raise RuntimeError(f"server already started (state={self._state})")
            executors = self.master.add_executors(self._num_executors)
            # execution metering is a blocking-backend concept (see
            # GlobalTaskUnitScheduler.meter_execution)
            self.global_taskunit.meter_execution = all(
                e.device.type == "cpu" for e in executors)
            self._scheduler.bind([e.id for e in executors], self._launch)
            self._state = "INIT"

    def submit(self, config: JobConfig) -> "Future[Dict[str, Any]]":
        """Schedule a job; the future resolves to the entity's result, or to the
        exception that ended the job. A job id still running is refused."""
        with self._lock:
            if self._state != "INIT":
                raise RuntimeError(f"server not accepting jobs (state={self._state})")
            existing = self._jobs.get(config.job_id)
            if existing is not None and not existing.done():
                raise ValueError(f"duplicate job id {config.job_id} (still running)")
            future: Future = Future()
            self._jobs[config.job_id] = future
        try:
            self._scheduler.on_job_arrival(config)
        except BaseException as e:
            future.set_exception(e)
            raise
        return future

    def _launch(self, config: JobConfig, executor_ids: List[str]) -> None:
        """The scheduler's launch: run the job on a dispatch thread of its own."""
        t = threading.Thread(target=self._dispatch, args=(config, executor_ids),
                             name=f"dispatch-{config.job_id}", daemon=True)
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()

    def _dispatch(self, config: JobConfig, executor_ids: List[str]) -> None:
        future = self._jobs[config.job_id]
        try:
            entity = build_entity(config, chkp_root=self._chkp_root,
                                  global_taskunit=self.global_taskunit,
                                  local_taskunit=self.local_taskunit)
            try:
                entity.setup(self.master, executor_ids)
                result = entity.run()
                # registered before cleanup drops the tables: the evaluation
                # replays the chain from disk and needs only the closure
                deferred = entity.deferred_evaluation()
                if deferred is not None:
                    with self._lock:
                        self._deferred_evals[config.job_id] = deferred
            finally:
                entity.cleanup()
        except BaseException as e:  # delivered through the future
            future.set_exception(e)
            if not isinstance(e, Exception):
                raise
        else:
            future.set_result(result)
        finally:
            self._scheduler.on_job_finish(config.job_id)

    def shutdown(self, timeout: Optional[float] = 300.0) -> None:
        """Stop accepting jobs, wait for the submitted ones (including those a
        scheduler still queues) and join their threads. ``timeout`` bounds the
        whole wait; a job still running after it stays visible in its future.
        Then the deferred evaluations run (see :meth:`_run_deferred_evals`),
        with a budget of their own."""
        with self._lock:
            if self._state != "INIT":
                return
            self._state = "CLOSING"
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                pending = [f for f in self._jobs.values() if not f.done()]
            remaining = None if deadline is None else deadline - time.monotonic()
            if not pending or (remaining is not None and remaining <= 0):
                break
            try:
                pending[0].result(timeout=remaining)
            except Exception:
                pass  # the job's failure is its future's to report
        with self._lock:
            threads = list(self._threads)
        drained = True
        for t in threads:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            t.join(timeout=remaining)
            drained = drained and not t.is_alive()
        self._run_deferred_evals(timeout, drained)
        self._state = "CLOSED"

    def _run_deferred_evals(self, timeout: Optional[float], drained: bool) -> None:
        """The deferred-work stage of graceful shutdown: run the evaluations
        the jobs deferred, each on a daemon thread, within one ``timeout``
        budget for the stage. Failures are recorded per job, never raised. A
        slow evaluation is abandoned with a recorded error, and the ones
        after it are skipped (it may still hold the device). If the job drain
        timed out, every evaluation is skipped: a straggler still holds the
        executors."""
        with self._lock:
            evals = dict(self._deferred_evals)
            self._deferred_evals.clear()
        deadline = None if timeout is None else time.monotonic() + timeout
        abandoned = False
        for job_id, fn in evals.items():
            if not drained:
                self.eval_results[job_id] = {"error": "skipped: job drain timed out"}
                continue
            if abandoned:
                self.eval_results[job_id] = {
                    "error": "skipped: a previous eval timed out and may still be running"}
                continue
            box: Dict[str, Any] = {}

            def call(fn=fn, box=box) -> None:
                try:
                    box["result"] = fn(self.master)
                except Exception as e:  # noqa: BLE001 - recorded below
                    box["error"] = f"{type(e).__name__}: {e}"

            t = threading.Thread(target=call, daemon=True, name=f"deferred-eval-{job_id}")
            t.start()
            t.join(timeout=None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                self.eval_results[job_id] = {"error": "timed out"}
                abandoned = True
            elif "error" in box:
                self.eval_results[job_id] = {"error": box["error"]}
            else:
                self.eval_results[job_id] = box["result"]
