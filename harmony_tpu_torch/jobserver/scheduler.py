"""Pluggable job scheduling: when a job runs and on which executors.

Counterpart of ``harmony_tpu/jobserver/scheduler.py``: the JobScheduler SPI
(``bind``, ``on_job_arrival``, ``on_job_finish``), the default
:class:`ShareAllScheduler`, which starts every job at once on all executors
(multi-tenant overlap on the shared pool), and :class:`FifoExclusiveScheduler`,
one job at a time on the whole pool. Not ported yet: the policy engine's
pins, the carve schedulers and elastic reacquire (ROADMAP A.10).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from harmony_tpu_torch.config.params import JobConfig

# What the server gives a scheduler: launch this job on these executors.
LaunchFn = Callable[[JobConfig, List[str]], None]


class JobScheduler:
    """SPI: implementations decide when a job runs and on which executors."""

    def bind(self, executor_ids: List[str], launch: LaunchFn) -> None:
        self._executors = list(executor_ids)
        self._launch = launch

    def on_job_arrival(self, config: JobConfig) -> None:
        raise NotImplementedError

    def on_job_finish(self, job_id: str) -> None:
        raise NotImplementedError


class ShareAllScheduler(JobScheduler):
    """Default: every job starts at once on all executors."""

    def on_job_arrival(self, config: JobConfig) -> None:
        self._launch(config, list(self._executors))

    def on_job_finish(self, job_id: str) -> None:
        pass


class FifoExclusiveScheduler(JobScheduler):
    """One job at a time on the whole pool; arrivals queue in order."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._queue: Deque[JobConfig] = deque()
        self._running: Optional[str] = None

    def on_job_arrival(self, config: JobConfig) -> None:
        with self._lock:
            if self._running is not None:
                self._queue.append(config)
                return
            self._running = config.job_id
        self._launch(config, list(self._executors))

    def on_job_finish(self, job_id: str) -> None:
        nxt = None
        with self._lock:
            if self._running == job_id:
                self._running = None
                if self._queue:
                    nxt = self._queue.popleft()
                    self._running = nxt.job_id
        if nxt is not None:
            self._launch(nxt, list(self._executors))


_SCHEDULERS: Dict[str, type] = {
    "share_all": ShareAllScheduler,
    "fifo": FifoExclusiveScheduler,
}


def make_scheduler(name: str) -> JobScheduler:
    """A scheduler by name (the reference's -scheduler flag)."""
    try:
        return _SCHEDULERS[name]()
    except KeyError:
        raise KeyError(f"unknown scheduler {name!r}; have {sorted(_SCHEDULERS)}") from None
