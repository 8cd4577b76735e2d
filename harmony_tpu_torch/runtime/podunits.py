"""Cross-job dispatch units — share-all multi-tenancy on a pod.

The reference's defining property is concurrent jobs on SHARED executors,
made safe by one globally-agreed order of work units: every executor learns
the same TaskUnit grant sequence from the driver and enqueues accordingly
(ref: services/et/src/main/java/edu/snu/cay/services/et/driver/impl/
GlobalTaskUnitScheduler.java:29-92, jobserver/driver/SchedulerImpl.java:
28-66 — the default scheduler runs every job on ALL executors).

A copy of ``harmony_tpu/runtime/podunits.py`` (which imports no JAX; the
port keeps its own copy and imports nothing of the JAX package).

On a pod the same need is a hard CORRECTNESS requirement, not just
fairness: a cross-process collective (``torch.distributed``, in
parallel/collectives.py) blocks its thread until every participant
arrives, and the collectives of one process group match by their order —
so two multi-process jobs whose host threads enter collectives in
different orders on different processes deadlock the pod (a distributed
lock-order inversion; parallel/dispatch.py orders the single-process
variant). Within one job the framework already forces a deterministic
per-process dispatch schedule (single dispatch thread, or the
DispatchTurnstile for multi-worker jobs). This module extends that
discipline ACROSS jobs:

  * every multi-process job's global-dispatch regions (setup, global init,
    batch/epoch dispatches, metric drains, probes, epoch hooks) are
    wrapped in numbered UNITS — the per-process numbering is deterministic
    because the per-job schedule is;
  * the pod leader runs the :class:`PodUnitArbiter`: processes announce
    each unit (TU_WAIT), the leader grants units in ONE order (TU_GRANT,
    weighted-fair across jobs), and a process reports TU_DONE when its
    enqueue region exits;
  * the arbiter never lets units of two process-overlapping jobs be
    outstanding at once, so between a grant and its last DONE only one
    job (per overlapping process set) is enqueueing — every process's
    cross-job enqueue order IS the grant order.

Latency: one control-plane round trip per unit. Units are coarse (a fused
epoch window, a batch group, an epoch hook), so the RTT amortizes exactly
like the reference's per-TaskUnit wait/ready message pair.

Fairness: grants are deficit-ordered (deficit = measured grant-to-done
seconds, the serial resource the arbiter actually allocates), with a
hold-back rule so a cheap job waiting on a streaming tenant's outstanding
units is next in line rather than starved (jobs on disjoint processes
grant concurrently throughout). The leader piggybacks a ``contended`` flag
on every grant; workers read it at unit EXIT (a deterministic point — the
flag rode a specific unit's grant, so every process sees the same value at
the same logical point) and shrink their dispatch windows so tenants
interleave at epoch/batch granularity instead of multi-epoch windows.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Set


def _default_timeout() -> float:
    return float(os.environ.get("HARMONY_POD_UNIT_TIMEOUT", "600"))


def _retry_interval() -> float:
    """How long a blocked follower waits before re-announcing TU_WAIT with
    ``retry=True``. The retry announce forces the leader to re-send the
    grant even when its original broadcast send succeeded — the one
    self-healing path that covers BOTH loss modes (a send that failed
    after the announce arrived, and a delivered grant the follower since
    evicted). Cold path only: the hot path stays at one grant message per
    (unit, pid). ``<= 0`` disables retries; tiny values clamp to 0.1s so a
    misconfiguration cannot busy-spin the wait loop."""
    v = float(os.environ.get("HARMONY_POD_UNIT_RETRY", "10"))
    if v <= 0:
        return float("inf")
    return max(v, 0.1)


def _inject_latency() -> None:
    """Bench/test-only DCN latency injection: HARMONY_POD_UNIT_LAT_MS
    (one-way milliseconds, default 0) sleeps before each unit-protocol
    message leg — TU_WAIT and TU_DONE on the follower's send side,
    TU_GRANT on the follower's processing side — so a unit acquisition
    pays ~one injected RTT (WAIT leg + GRANT leg), the same bill the
    reference's per-TaskUnit wait/ready round trip pays over a real
    network (GlobalTaskUnitScheduler.java:64-85). The reference's
    benchmarks/podunits.py sweeps this to price unit coarseness; production
    leaves it unset."""
    ms = float(os.environ.get("HARMONY_POD_UNIT_LAT_MS", "0") or 0)
    if ms > 0:
        time.sleep(ms / 1000.0)


def _cap_evict(d: Dict[int, Any], outstanding: Dict[int, Any],
               cap: int) -> None:
    """Evict oldest entries of ``d`` past ``cap``, but never one whose seq
    is still outstanding — the repair path may yet need it."""
    if len(d) > cap:
        stale = [s for s in d if s not in outstanding]
        for s in stale[:len(d) - cap]:
            d.pop(s)


class _JobState:
    __slots__ = ("procs", "next_grant", "pending", "outstanding",
                 "granted_hi", "deficit", "grant_t0", "flags", "arrival",
                 "unsent")

    def __init__(self, procs: frozenset, deficit: float, arrival: int) -> None:
        self.procs = procs
        self.next_grant = 0              # next seq to grant (in order)
        self.pending: Set[int] = set()   # announced, ungranted seqs
        self.outstanding: Dict[int, Set[int]] = {}  # seq -> procs not DONE
        self.granted_hi = -1
        self.deficit = deficit
        self.grant_t0: Dict[int, float] = {}
        self.flags: Dict[int, bool] = {}  # seq -> contended (local reads)
        self.arrival = arrival
        self.unsent: Dict[int, Set[int]] = {}  # seq -> pids whose send failed


class PodUnitArbiter:
    """Leader-side grant authority. Driven by the pod server's reader
    threads (follower TU_WAIT/TU_DONE) and by leader-local clients
    (direct calls with pid 0)."""

    def __init__(self, send_to: Callable[[int, Dict[str, Any]], None]) -> None:
        self._send_to = send_to
        self._cond = threading.Condition()
        self._jobs: Dict[str, _JobState] = {}
        self._arrival = itertools.count()
        self._poisoned = False
        # protocol telemetry (survives job deregistration; read by the
        # pod STATUS surface)
        self.grants_total = 0
        self.grant_to_done_s = 0.0
        # final deficits of recently deregistered jobs (bounded): an
        # elastic recovery attempt re-registers under a fresh key and
        # INHERITS its predecessor's accumulated share, so a recovered
        # tenant re-enters the fair queue where it left rather than
        # resetting to the lowest active deficit on every attempt
        self._legacy_deficit: Dict[str, float] = {}

    # -- registry ---------------------------------------------------------

    def register_job(self, job_id: str, procs: "frozenset[int]",
                     inherit_from: Optional[str] = None) -> None:
        with self._cond:
            # WFQ virtual-time start: a late arrival begins at the lowest
            # active deficit so it cannot monopolize grants "catching up";
            # an elastic recovery attempt instead inherits its superseded
            # attempt's accumulated deficit (never below the late-arrival
            # floor — inheritance must not grant a priority boost either)
            active = [s.deficit for s in self._jobs.values()]
            start = min(active) if active else 0.0
            if inherit_from is not None:
                start = max(start, self._legacy_deficit.get(inherit_from,
                                                            start))
            self._jobs[job_id] = _JobState(
                frozenset(procs), start, next(self._arrival),
            )

    def deregister_job(self, job_id: str) -> None:
        """Job over (or failed): its outstanding units will never DONE —
        force-release them so peers unblock, and drop pending waits."""
        with self._cond:
            st = self._jobs.pop(job_id, None)
            if st is not None:
                self._legacy_deficit[job_id] = st.deficit
                while len(self._legacy_deficit) > 256:
                    self._legacy_deficit.pop(next(iter(self._legacy_deficit)))
                self._maybe_grant_locked()
                self._cond.notify_all()

    def poison(self) -> None:
        """Pod broken: grant everything, now and forever — blocked threads
        proceed into whatever state remains (no worse than wedging here)
        and fail through the normal error paths."""
        with self._cond:
            self._poisoned = True
            for jid, st in self._jobs.items():
                for seq in sorted(st.pending):
                    self._grant_locked(jid, st, seq, contended=False)
            self._cond.notify_all()

    # -- protocol ---------------------------------------------------------

    def on_wait(self, job_id: str, seq: int, pid: int,
                retry: bool = False) -> None:
        with self._cond:
            st = self._jobs.get(job_id)
            if st is None or self._poisoned:
                # unknown (finished/failed) job or poisoned pod: grant
                # unconditionally — its dispatches are beyond management,
                # and deadlocking a cleanup path helps nobody
                if pid != 0:
                    self._send_grant(pid, job_id, int(seq), False)
                # pid 0: local_wait's ready() already passes unregistered/
                # poisoned jobs — just wake it
                self._cond.notify_all()
                return
            seq = int(seq)
            if seq <= st.granted_hi:
                # Already granted — this process announced late. Repair
                # (re-send the grant) when the original broadcast send to
                # this pid FAILED, or when the follower explicitly asks
                # (``retry=True``: it has been blocked past the retry
                # interval, so whatever we sent it is lost to it — e.g.
                # a grant it received early and then evicted). A normal
                # late announce after a SUCCEEDED send is not repaired:
                # TCP orders that grant ahead of anything the announce
                # could race with, so the steady-state path stays at one
                # grant message per (unit, pid).
                if pid != 0 and (retry or pid in st.unsent.get(seq, ())):
                    if self._send_grant(pid, job_id, seq,
                                        bool(st.flags.get(seq, False))):
                        if seq in st.unsent:
                            st.unsent[seq].discard(pid)
                            if not st.unsent[seq]:
                                del st.unsent[seq]
                return
            st.pending.add(seq)
            self._maybe_grant_locked()

    def on_done(self, job_id: str, seq: int, pid: int) -> None:
        with self._cond:
            st = self._jobs.get(job_id)
            if st is None:
                return
            pending = st.outstanding.get(int(seq))
            if pending is None:
                return
            pending.discard(pid)
            if not pending:
                del st.outstanding[int(seq)]
                t0 = st.grant_t0.pop(int(seq), None)
                if t0 is not None:
                    # charge the serial resource actually consumed:
                    # grant -> last enqueue-done wall seconds
                    dt = time.monotonic() - t0
                    st.deficit += dt
                    self.grant_to_done_s += dt
                self._maybe_grant_locked()
                self._cond.notify_all()

    def proc_done(self, pid: int) -> None:
        """A follower died: its DONEs will never arrive — remove it from
        every pending finish so surviving jobs' grants keep flowing (the
        pod poison path handles the jobs it actually wedged)."""
        with self._cond:
            for jid, st in list(self._jobs.items()):
                for seq in list(st.outstanding):
                    st.outstanding[seq].discard(pid)
                    if not st.outstanding[seq]:
                        del st.outstanding[seq]
                        st.grant_t0.pop(seq, None)
                for seq in list(st.unsent):
                    st.unsent[seq].discard(pid)  # dead pid never announces
                    if not st.unsent[seq]:
                        del st.unsent[seq]
            self._maybe_grant_locked()
            self._cond.notify_all()

    # -- granting ---------------------------------------------------------

    def _contended_locked(self, job_id: str, st: _JobState) -> bool:
        return any(
            j != job_id and s.procs & st.procs for j, s in self._jobs.items()
        )

    def _send_grant(self, pid: int, job_id: str, seq: int,
                    contended: bool) -> bool:
        try:
            self._send_to(pid, {"cmd": "TU_GRANT", "job_id": job_id,
                                "seq": seq, "contended": contended})
            return True
        except OSError:
            return False  # dead follower: the reader loop poisons the pod

    def _grant_locked(self, job_id: str, st: _JobState, seq: int,
                      contended: bool) -> None:
        st.pending.discard(seq)
        st.granted_hi = max(st.granted_hi, seq)
        st.next_grant = max(st.next_grant, seq + 1)
        self.grants_total += 1
        st.outstanding[seq] = set(st.procs)
        st.grant_t0[seq] = time.monotonic()
        st.flags[seq] = contended
        _cap_evict(st.flags, st.outstanding, 1024)
        for pid in sorted(st.procs):
            if pid != 0 and not self._send_grant(pid, job_id, seq, contended):
                st.unsent.setdefault(seq, set()).add(pid)
        _cap_evict(st.unsent, st.outstanding, 1024)
        # pid 0 (leader-local client) reads granted_hi under the condition

    def _maybe_grant_locked(self) -> None:
        """Grant in deficit order with hold-back: a lower-deficit job
        blocked by another tenant's outstanding units RESERVES its
        processes, so later jobs cannot starve it by streaming; jobs on
        disjoint processes grant concurrently regardless."""
        granted = True
        while granted:
            granted = False
            order = sorted(
                ((st.deficit, st.arrival, jid, st)
                 for jid, st in self._jobs.items() if st.pending),
            )
            blocked: Set[int] = set()
            for _, _, jid, st in order:
                if st.next_grant not in st.pending:
                    continue  # next-in-order unit not announced yet
                conflict = st.procs & blocked or any(
                    j != jid and s.outstanding and s.procs & st.procs
                    for j, s in self._jobs.items()
                )
                if conflict:
                    blocked |= st.procs
                    continue
                self._grant_locked(jid, st, st.next_grant,
                                   self._contended_locked(jid, st))
                granted = True
        self._cond.notify_all()

    # -- leader-local client interface ------------------------------------

    def local_wait(self, job_id: str, seq: int,
                   timeout: Optional[float] = None) -> bool:
        """Block until (job_id, seq) is granted; returns the contended
        flag. Raises on timeout (a deadlock diagnosis, not a schedule)."""
        self.on_wait(job_id, seq, 0)
        deadline = time.monotonic() + (
            _default_timeout() if timeout is None else timeout
        )

        def ready() -> bool:
            st = self._jobs.get(job_id)
            if st is None or self._poisoned:
                return True
            return st.granted_hi >= seq

        with self._cond:
            while not ready():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RuntimeError(
                        f"pod unit ({job_id}, {seq}) not granted after "
                        f"{_default_timeout() if timeout is None else timeout}"
                        "s — a dispatch site outside the unit discipline, "
                        "or a wedged tenant"
                    )
                self._cond.wait(timeout=min(remaining, 5.0))
            st = self._jobs.get(job_id)
            return bool(st.flags.get(seq, False)) if st is not None else False


class FollowerUnits:
    """Follower-side grant tracker: the main reader loop feeds TU_GRANTs
    in; per-job clients wait on them. Grants may arrive BEFORE the local
    thread reaches its wait (another process announced first) — state is
    created on demand from either side."""

    _MAX_STATES = 256

    def __init__(self, report: Callable[[Dict[str, Any]], None]) -> None:
        self._report = report
        self._cond = threading.Condition()
        self._states: Dict[str, Dict[str, Any]] = {}
        self._waiting: Dict[str, int] = {}  # job_id -> active wait() count
        self._poisoned = False

    def _state(self, job_id: str) -> Dict[str, Any]:
        st = self._states.get(job_id)
        if st is None:
            st = self._states[job_id] = {"hi": -1, "flags": {}}
            if len(self._states) > self._MAX_STATES:
                # Evict oldest states, but NEVER one a local thread is
                # actively waiting on — dropping a live job's grant
                # watermark would turn an already-arrived grant into a
                # deadlock. If every state is live the map runs over the
                # cap (bounded by thread count, a correctness-first trade).
                evictable = [j for j in self._states
                             if j != job_id and not self._waiting.get(j)]
                for j in evictable[:len(self._states) - self._MAX_STATES]:
                    self._states.pop(j)
        return st

    def on_grant(self, job_id: str, seq: int, contended: bool) -> None:
        _inject_latency()  # the grant's network leg (bench knob, no-op off)
        with self._cond:
            st = self._state(job_id)
            st["hi"] = max(st["hi"], int(seq))
            st["flags"][int(seq)] = bool(contended)
            while len(st["flags"]) > 1024:
                st["flags"].pop(next(iter(st["flags"])))
            self._cond.notify_all()

    def on_poison(self) -> None:
        with self._cond:
            self._poisoned = True
            self._cond.notify_all()

    def forget(self, job_id: str) -> None:
        with self._cond:
            self._states.pop(job_id, None)

    def wait(self, job_id: str, seq: int,
             timeout: Optional[float] = None) -> bool:
        # Register as a waiter BEFORE the TU_WAIT report goes out: the
        # report can trigger the grant (and a flood of other jobs' grants)
        # on the reader thread, and the eviction guard in _state() must
        # already see this job as live by then.
        with self._cond:
            self._waiting[job_id] = self._waiting.get(job_id, 0) + 1
        try:
            _inject_latency()  # the announce's network leg (bench knob)
            self._report({"cmd": "TU_WAIT", "job_id": job_id,
                          "seq": int(seq)})
            deadline = time.monotonic() + (
                _default_timeout() if timeout is None else timeout
            )
            retry_s = _retry_interval()
            next_retry = time.monotonic() + retry_s
            while True:
                with self._cond:
                    st = self._states.get(job_id)
                    if self._poisoned:
                        return False
                    if st is not None and st["hi"] >= seq:
                        return bool(st["flags"].get(int(seq), False))
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise RuntimeError(
                            f"pod unit ({job_id}, {seq}) not granted after "
                            f"{_default_timeout() if timeout is None else timeout}"
                            "s — a dispatch site outside the unit discipline, "
                            "or a wedged tenant"
                        )
                    self._cond.wait(timeout=min(
                        remaining, next_retry - time.monotonic(), 5.0))
                # blocked past the retry interval: re-announce with
                # retry=True (outside the lock — socket IO) so the leader
                # force-resends the grant; self-heals a failed broadcast
                # send AND a delivered-then-evicted grant state
                if time.monotonic() >= next_retry:
                    self._report({"cmd": "TU_WAIT", "job_id": job_id,
                                  "seq": int(seq), "retry": True})
                    next_retry = time.monotonic() + retry_s
        finally:
            with self._cond:
                n = self._waiting.get(job_id, 1) - 1
                if n <= 0:
                    self._waiting.pop(job_id, None)
                else:
                    self._waiting[job_id] = n

    def done(self, job_id: str, seq: int) -> None:
        _inject_latency()  # the DONE's network leg (bench knob, no-op off)
        self._report({"cmd": "TU_DONE", "job_id": job_id, "seq": int(seq)})


class PodUnitClient:
    """Per-(process, job) handle: numbers this process's unit sequence and
    runs the WAIT -> enqueue -> DONE protocol. The sequence numbering is
    deterministic because each process's per-job dispatch schedule is
    (single dispatch thread, or the DispatchTurnstile cycle) — so unit k
    names the SAME dispatch region on every participating process.

    ``contended()`` returns the contended flag of the last COMPLETED unit
    — a value every process reads at the same logical point (it rode that
    unit's grant), safe to branch dispatch-window decisions on."""

    def __init__(self, job_id: str,
                 wait: Callable[[str, int, Optional[float]], bool],
                 done: Callable[[str, int], None]) -> None:
        self.job_id = job_id
        self._wait = wait
        self._done = done
        self._seq = itertools.count()
        self._lock = threading.Lock()  # turnstile serializes; belt+braces
        self._contended = False

    @contextlib.contextmanager
    def scope(self, timeout: Optional[float] = None):
        with self._lock:
            seq = next(self._seq)
        flag = self._wait(self.job_id, seq, timeout)
        try:
            yield
        finally:
            self._contended = flag
            self._done(self.job_id, seq)

    def contended(self) -> bool:
        return self._contended


def leader_client(arbiter: PodUnitArbiter, job_id: str) -> PodUnitClient:
    return PodUnitClient(
        job_id,
        wait=arbiter.local_wait,
        done=lambda jid, seq: arbiter.on_done(jid, seq, 0),
    )


def follower_client(units: FollowerUnits, job_id: str) -> PodUnitClient:
    return PodUnitClient(job_id, wait=units.wait, done=units.done)
