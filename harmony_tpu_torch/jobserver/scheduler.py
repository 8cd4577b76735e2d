"""Pluggable job scheduling: when a job runs and on which executors.

Counterpart of ``harmony_tpu/jobserver/scheduler.py``: the JobScheduler SPI
(``bind``, ``on_job_arrival``, ``on_job_finish``), the default
:class:`ShareAllScheduler`, which starts every job at once on all executors
(multi-tenant overlap on the shared pool), :class:`FifoExclusiveScheduler`,
one job at a time on the whole pool, and the carve schedulers:
:class:`CarveScheduler` gives every job a disjoint slice of the executors,
and :class:`ProcessCarveScheduler` slices in whole pod processes, so carved
jobs on a pod never share a process. Not ported yet: the policy engine's
pins (ROADMAP A.10), and the carve schedulers' ``retire``, ``restore`` and
``reacquire``, which serve elastic recovery (ROADMAP A item 4).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

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


class CarveScheduler(JobScheduler):
    """Mesh carving: every job gets a DISJOINT slice of the executor pool.
    Fair share at arrival = pool // (running jobs + 1), floored at
    ``min_slice`` and capped at ``max_share``; arrivals that cannot get
    ``min_slice`` free executors queue FIFO, and a finishing job returns its
    slice (launching queued jobs first)."""

    def __init__(self, min_slice: int = 1, max_share: Optional[int] = None) -> None:
        if min_slice < 1:
            raise ValueError("min_slice must be >= 1")
        if max_share is not None and max_share < min_slice:
            raise ValueError("max_share must be >= min_slice")
        self.min_slice = min_slice
        self.max_share = max_share
        self._lock = threading.Lock()
        self._free: List[str] = []
        self._slices: Dict[str, List[str]] = {}
        self._queue: Deque[JobConfig] = deque()

    def bind(self, executor_ids: List[str], launch: LaunchFn) -> None:
        super().bind(executor_ids, launch)
        self._free = list(executor_ids)

    def idle_executors(self) -> List[str]:
        with self._lock:
            return list(self._free)

    def queued_jobs(self) -> List[JobConfig]:
        with self._lock:
            return list(self._queue)

    def _take_slice(self) -> Optional[List[str]]:
        """Under the lock: carve the next job's slice, or None to queue."""
        share = max(self.min_slice, len(self._executors) // (len(self._slices) + 1))
        if self.max_share is not None:
            share = min(share, self.max_share)
        if len(self._free) < self.min_slice:
            return None
        take = self._free[: min(share, len(self._free))]
        del self._free[: len(take)]
        return take

    def on_job_arrival(self, config: JobConfig) -> None:
        with self._lock:
            sl = self._take_slice()
            if sl is None:
                self._queue.append(config)
                return
            self._slices[config.job_id] = sl
        self._launch(config, sl)

    def on_job_finish(self, job_id: str) -> None:
        with self._lock:
            mine = self._slices.pop(job_id, [])
            held = {e for sl in self._slices.values() for e in sl}
            self._free.extend(e for e in mine if e not in held and e not in self._free)
            launches = self._drain_queue_locked()
        for cfg, sl in launches:
            self._launch(cfg, sl)

    def _drain_queue_locked(self) -> List[Tuple[JobConfig, List[str]]]:
        """Under the lock: carve slices for queued jobs while any fit; returns
        the (config, slice) launches to fire outside the lock."""
        launches = []
        while self._queue:
            sl = self._take_slice()
            if sl is None:
                break
            cfg = self._queue.popleft()
            self._slices[cfg.job_id] = sl
            launches.append((cfg, sl))
        return launches

    def slice_of(self, job_id: str) -> List[str]:
        with self._lock:
            return list(self._slices.get(job_id, []))


class ProcessCarveScheduler(CarveScheduler):
    """Mesh carving in whole-PROCESS units, for pods: every slice is a set of
    complete processes, so carved jobs never share a process and the pod
    server runs them all at once. Fair share at arrival = processes //
    (running jobs + 1), floored at ``min_procs`` and capped at
    ``max_procs``. The server injects the executor -> process map after
    allocation (``set_process_map``); until then the pool counts as one
    process."""

    def __init__(self, min_procs: int = 1, max_procs: Optional[int] = None) -> None:
        super().__init__(min_slice=1, max_share=None)
        if min_procs < 1:
            raise ValueError("min_procs must be >= 1")
        if max_procs is not None and max_procs < min_procs:
            raise ValueError("max_procs must be >= min_procs")
        self.min_procs = min_procs
        self.max_procs = max_procs
        self._proc_of: Dict[str, int] = {}

    def set_process_map(self, proc_of: Dict[str, int]) -> None:
        """executor id -> process index (``Executor.slot.process_index``)."""
        with self._lock:
            self._proc_of = dict(proc_of)

    def _take_slice(self) -> Optional[List[str]]:
        """Under the lock: carve whole free processes, or None to queue."""
        members: Dict[int, List[str]] = {}
        for e in self._executors:
            members.setdefault(self._proc_of.get(e, 0), []).append(e)
        free = set(self._free)
        free_procs = sorted(p for p, mem in members.items() if all(e in free for e in mem))
        share = max(self.min_procs, len(members) // (len(self._slices) + 1))
        if self.max_procs is not None:
            share = min(share, self.max_procs)
        if len(free_procs) < self.min_procs:
            return None
        take = [e for p in free_procs[: min(share, len(free_procs))] for e in members[p]]
        taken = set(take)
        self._free = [e for e in self._free if e not in taken]
        return take


_SCHEDULERS: Dict[str, type] = {
    "share_all": ShareAllScheduler,
    "fifo": FifoExclusiveScheduler,
    "carve": CarveScheduler,
    "pod_carve": ProcessCarveScheduler,
}


def make_scheduler(name: str) -> JobScheduler:
    """A scheduler by name (the reference's -scheduler flag)."""
    try:
        return _SCHEDULERS[name]()
    except KeyError:
        raise KeyError(f"unknown scheduler {name!r}; have {sorted(_SCHEDULERS)}") from None
