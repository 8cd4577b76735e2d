"""Dolphin master-side control: SSP gate, lifecycle barriers, progress.

Rebuilds the reference's master components (SURVEY.md §2.6):

  * MiniBatchController  — SSP bounded staleness: each worker announces
    every mini-batch start; any worker more than ``clock_slack`` batches
    ahead of the globally slowest is blocked; a global batch budget
    (num_epochs x num_mini_batches per worker) triggers a broadcast stop
    (ref: dolphin/core/master/MiniBatchController.java:28-118).
  * WorkerStateManager   — barrier for the worker lifecycle INIT->RUN->
    CLEANUP driven by sync messages, released by broadcast
    (ref: core/master/WorkerStateManager.java:40-95).
  * BatchProgressTracker — per-worker batch index for job-level progress
    and the starting epoch on restart
    (ref: core/master/BatchProgressTracker.java).

Counterpart of ``harmony_tpu/dolphin/master.py``, copied with its semantics
and names (the port imports nothing of the JAX package). These are
in-process (condition variables instead of avro SyncMsg / MiniBatchSyncMsg
round-trips): master and workers run in one process, so "messages" are
method calls; the method surface mirrors the message vocabulary so a
multi-host transport can slot in behind the same API.

Clock-slack = 0 degrades to BSP.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Set


class BatchProgressTracker:
    """Tracks per-worker mini-batch progress (max batch index seen).

    ``floor_batch`` seeds the global minimum for RESUMED jobs (chain
    auto-resume, elastic recovery): a fresh tracker reporting progress 0
    would let the pod plan-horizon check accept a reshard/fence epoch
    BEHIND the continuation's real progress — the divergent-application
    hazard the horizon exists to prevent. The floor never decreases
    observed progress, only prevents understating it."""

    def __init__(self, num_mini_batches_per_epoch: int,
                 floor_batch: int = 0) -> None:
        self._nb = num_mini_batches_per_epoch
        self._floor = max(0, int(floor_batch))
        self._lock = threading.Lock()
        self._progress: Dict[str, int] = {}

    def on_batch(self, worker_id: str, global_batch_idx: int) -> None:
        with self._lock:
            cur = self._progress.get(worker_id, -1)
            if global_batch_idx > cur:
                self._progress[worker_id] = global_batch_idx

    def global_min_batch(self) -> int:
        with self._lock:
            low = min(self._progress.values()) if self._progress else 0
            return max(low, self._floor)

    def starting_epoch(self) -> int:
        """Epoch a restarted worker should resume from (ref: StartingEpochIdx
        fed by the tracker, DolphinMaster.java:116)."""
        return self.global_min_batch() // self._nb


class MiniBatchController:
    """SSP gate + global batch budget.

    Workers call :meth:`on_sync` at each batch start (the MiniBatchSyncMsg).
    The call blocks while the caller is more than ``clock_slack`` batches
    ahead of the slowest registered worker, and returns ``True`` when the
    job's batch budget is exhausted (the MiniBatchControlMsg stop
    broadcast).
    """

    def __init__(
        self,
        clock_slack: int,
        batches_per_worker: int,
        tracker: Optional[BatchProgressTracker] = None,
    ) -> None:
        self.clock_slack = clock_slack
        self.batches_per_worker = batches_per_worker
        self._cond = threading.Condition()
        self._progress: Dict[str, int] = {}
        self._stopped = False
        self._tracker = tracker

    # -- membership (elasticity adjusts this; ref: WorkerStateManager
    # keeping barrier counts consistent across reconfigurations) ---------

    def register_worker(self, worker_id: str) -> None:
        with self._cond:
            self._progress.setdefault(worker_id, 0)
            self._cond.notify_all()

    def deregister_worker(self, worker_id: str) -> None:
        """A finished/removed worker must not gate the others."""
        with self._cond:
            self._progress.pop(worker_id, None)
            self._cond.notify_all()

    def request_stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    @property
    def stopped(self) -> bool:
        with self._cond:
            return self._stopped

    # -- the gate --------------------------------------------------------

    def on_sync(self, worker_id: str, batch_idx: int) -> bool:
        """Announce batch start; block per SSP; return stop flag."""
        with self._cond:
            if worker_id not in self._progress:
                self._progress[worker_id] = 0
            self._progress[worker_id] = batch_idx
            if self._tracker is not None:
                self._tracker.on_batch(worker_id, batch_idx)
            self._cond.notify_all()
            if batch_idx >= self.batches_per_worker:
                self._stopped = True
                self._cond.notify_all()
                return True
            while (
                not self._stopped
                and self._progress
                and batch_idx > min(self._progress.values()) + self.clock_slack
            ):
                self._cond.wait()
            return self._stopped

    def make_barrier(self, worker_id: str) -> Callable[[int], bool]:
        """Worker-side MiniBatchBarrier bound to this controller (ref:
        core/worker/MiniBatchBarrier.java:28-60) — plugs into
        WorkerTasklet(batch_barrier=...)."""
        self.register_worker(worker_id)
        return lambda batch_idx: self.on_sync(worker_id, batch_idx)


class DispatchTurnstile:
    """Deterministic cyclic admission of worker dispatch turns — what makes
    multi-worker SSP legal on a MULTI-PROCESS pod.

    The hazard: a pod job's worker threads dispatch global SPMD programs,
    and every process must enqueue them in the SAME order (an inversion
    wedges the collectives — parallel/dispatch.py). Thread timing differs
    per host, so the order must come from a schedule, not the OS. The
    turnstile admits exactly one worker "turn" at a time, cycling the
    worker list in fixed order; every process runs the same cycle, so
    batch dispatches, metric drains and probes enqueue identically
    everywhere — and the per-process MiniBatchControllers see sync calls
    in the same order too, making their stop decisions deterministic
    (the reference reaches the same property by centralizing the decision
    in one master and broadcasting it, MiniBatchController.java:28-118;
    here determinism-by-schedule needs no message round-trip per batch).

    Divergence between workers is bounded by one turn, so an SSP gate with
    clock_slack >= 1 never blocks INSIDE a turn (a blocked turn-holder
    would stall the cycle); the entity clamps the slack accordingly.
    Workers that finish or die ``leave()`` so the cycle skips them.
    """

    def __init__(self, worker_ids: List[str]) -> None:
        self._order = list(worker_ids)
        self._cond = threading.Condition()
        self._pos = 0
        self._active: Set[str] = set(worker_ids)

    def _current_locked(self) -> Optional[str]:
        n = len(self._order)
        for _ in range(n):
            wid = self._order[self._pos % n]
            if wid in self._active:
                return wid
            self._pos += 1
        return None

    @contextlib.contextmanager
    def turn(self, worker_id: str):
        """Block until it is ``worker_id``'s turn; the turn ends (and the
        cycle advances) when the with-block exits."""
        with self._cond:
            self._cond.wait_for(lambda: self._current_locked() == worker_id)
        try:
            yield
        finally:
            with self._cond:
                self._pos += 1
                self._cond.notify_all()

    def leave(self, worker_id: str) -> None:
        with self._cond:
            self._active.discard(worker_id)
            self._cond.notify_all()


class WorkerStateManager:
    """Lifecycle barrier: all workers must reach a state before any proceeds.

    Worker side calls :meth:`await_barrier(worker_id, state)` (the SyncMsg);
    when every registered worker has arrived, the master releases all (the
    broadcast release). States progress INIT -> RUN -> CLEANUP.
    """

    STATES = ("INIT", "RUN", "CLEANUP")

    def __init__(self, worker_ids: List[str]) -> None:
        self._cond = threading.Condition()
        self._workers: Set[str] = set(worker_ids)
        self._arrived: Dict[str, Set[str]] = {s: set() for s in self.STATES}
        self._released: Set[str] = set()

    def update_workers(self, worker_ids: List[str]) -> None:
        """Reconfiguration: adjust the barrier membership (ref:
        ETTaskRunner.updateExecutorEntry keeping barrier counts right)."""
        with self._cond:
            self._workers = set(worker_ids)
            self._maybe_release_locked()

    def await_barrier(self, worker_id: str, state: str, timeout: Optional[float] = None) -> bool:
        if state not in self.STATES:
            raise ValueError(f"unknown state {state!r}")
        with self._cond:
            self._arrived[state].add(worker_id)
            self._maybe_release_locked()
            return self._cond.wait_for(lambda: state in self._released, timeout=timeout)

    def _maybe_release_locked(self) -> None:
        for s in self.STATES:
            if s not in self._released and self._workers and self._workers <= self._arrived[s]:
                self._released.add(s)
                self._cond.notify_all()
