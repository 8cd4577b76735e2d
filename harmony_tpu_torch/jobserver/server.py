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
            entity = build_entity(config, global_taskunit=self.global_taskunit,
                                  local_taskunit=self.local_taskunit)
            try:
                entity.setup(self.master, executor_ids)
                result = entity.run()
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
        whole wait; a job still running after it stays visible in its future."""
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
        for t in threads:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            t.join(timeout=remaining)
        self._state = "CLOSED"
