"""The pod's JobServer: the driver/evaluator split over real processes.

Counterpart of ``harmony_tpu/jobserver/pod.py``. Every process of a pod joins
one ``torch.distributed`` world (``parallel/multihost.py``) and builds the
same global slot list; process 0 runs the :class:`PodJobServer` (the
ordinary JobServer: scheduling, registry, TCP command plane, plus the pod's
control plane) and every other process a :class:`PodFollower`.

Control plane (JSON lines over TCP, the reference's framing): followers JOIN
the leader; for each dispatched job the leader sends RUN_JOB to the
followers whose processes hold slots of the job's executors, every
participating process builds the SAME entity from the config and runs it,
and the tables' cross-process all-gathers (``parallel/collectives.py``) are
the data plane. At the job's end each follower reports JOB_DONE with its
workers' losses, the kernel launches, the cross-process traffic and the pod
units it saw during the job; the leader keeps them by process (``pod_reports``, the
``reports`` of STATUS's ``pod`` block). Followers send a HEARTBEAT every
``HARMONY_POD_HB_PERIOD`` seconds (5); the leader confines a follower silent
past ``HARMONY_POD_HB_TIMEOUT`` (60), and a lost connection marks it dead:
a job it takes part in fails, and the pod is marked broken for the processes
that shared a running job with it.

Concurrent tenants: a cross-process collective blocks its thread until every
peer arrives, so two multi-process jobs sharing processes must enter their
collectives in the same order everywhere. Two mechanisms make that so, as
in the reference:

  * the CROSS-JOB UNIT PROTOCOL (``runtime/podunits.py``): every
    multi-process Dolphin and Pregel job runs its dispatch regions inside
    leader-granted units, and the leader's arbiter never leaves units of two
    process-overlapping jobs outstanding at once, so share-all tenants run
    at once, interleaved in one pod-wide order;
  * the admission rule of ``_dispatch_once_inner`` for the rest: disjoint
    process sets and single-process jobs always run at once; a
    multi-process job outside the protocol (``user.pod_isolated``) waits
    for every overlapping multi-process job, and a waiting job's FIFO
    ticket reserves its processes against later arrivals.

The ``pod_carve`` scheduler (``scheduler.ProcessCarveScheduler``) gives
tenants disjoint whole processes instead.

Determinism: entity construction is a pure function of the JobConfig,
executor ids come in the same order in every process, and the jobs' data is
seeded, so a job's participants issue the same collectives in the same
order.

Left out, with ROADMAP A item 3b (and item 4 for elasticity): elastic
dispatch and recovery (``_dispatch_elastic``, ``_plan_elastic_recovery``,
the fences, ``_maybe_auto_resume``), late joins and the rehabilitation of a
follower (``_accept_late_joins``, ``_reinstate_follower``, ``_rehabilitate``,
``_rejoin``), ``schedule_pod_reshard`` (a POD_RESHARD command is answered
with an error naming item 3b), the collective deferred evaluation
(``_pod_eval_channel``, ``_broadcast_eval_decision``; a job with
``offline_model_eval`` is refused on a grant beyond process 0), HA's leader
epochs and the policy hooks.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from harmony_tpu_torch.config.base import ConfigBase
from harmony_tpu_torch.config.params import JobConfig
from harmony_tpu_torch.jobserver import podplan
from harmony_tpu_torch.jobserver.scheduler import ProcessCarveScheduler
from harmony_tpu_torch.jobserver.server import JobServer, _json_sanitize
from harmony_tpu_torch.runtime.podunits import (
    FollowerUnits,
    PodUnitArbiter,
    follower_client,
    leader_client,
)
from harmony_tpu_torch.tracing.span import SpanContext, trace_span, wire_context

log = logging.getLogger(__name__)

POD_RESHARD_ERROR = (
    "POD_RESHARD: a live reshard on a pod (blockmove's TCP and file transports, "
    "the plan applied at the chief's epoch hook in every process) waits for "
    "ROADMAP A item 3b")


def _send(sock: socket.socket, msg: Dict[str, Any]) -> None:
    sock.sendall((json.dumps(msg) + "\n").encode())


def _recv(f) -> Optional[Dict[str, Any]]:
    line = f.readline()
    if not line:
        return None
    return json.loads(line)


def _job_counters() -> Dict[str, Any]:
    """This process's kernel launch counts and cross-process traffic so far
    (a job's share is the difference around it; jobs running at once in a
    process share the counts)."""
    from harmony_tpu_torch.ops import attention as A
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows
    from harmony_tpu_torch.parallel.collectives import POD_STATS

    return {"launches": {w.__name__: w.launches for w in (
                gather_rows, segment_sum_rows, weighted_histogram,
                A.flash_forward, A.flash_backward_dkv, A.flash_backward_dq)},
            "combine": dict(POD_STATS)}


def _counter_delta(before: Dict[str, Any], after: Dict[str, Any]) -> Dict[str, Any]:
    return {part: {k: after[part][k] - before[part][k] for k in after[part]}
            for part in after}


def _counted(scope, counts: Dict[str, int]):
    """``scope`` (a unit client's), counting the units it takes in
    ``counts["units"]``."""
    def counting(*args, **kwargs):
        counts["units"] += 1
        return scope(*args, **kwargs)

    return counting


def _job_summary(result: Dict[str, Any]) -> Dict[str, Any]:
    """What a report carries of a job's result: each worker's losses, batch
    losses, epoch seconds and comm probes; for a graph job its supersteps,
    their wall seconds and a SHA-256 of its vertex values' bytes."""
    out: Dict[str, Any] = {"workers": {
        wid: {"losses": [float(x) for x in w.get("losses", [])],
              "batch_losses": [float(x) for x in w.get("batch_losses", [])],
              "epoch_seconds": [float(x) for x in w.get("epoch_seconds", [])],
              "probes": int(w.get("comm_probe", {}).get("probes", 0))}
        for wid, w in result.get("workers", {}).items()}}
    if "vertex_values" in result:
        values = np.ascontiguousarray(result["vertex_values"])
        out.update(supersteps=int(result["supersteps"]), wall_sec=float(result["wall_sec"]),
                   vertex_digest=hashlib.sha256(values.tobytes()).hexdigest())
    return out


class PodJobServer(JobServer):
    """JobServer on process 0 of a pod: adds the follower control plane."""

    def __init__(self, *args, num_followers: int = 0, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._num_followers = num_followers
        self._pod_sock: Optional[socket.socket] = None
        self._followers: Dict[int, Tuple[socket.socket, Any]] = {}
        self._send_locks: Dict[int, threading.Lock] = {}
        # one condition guards the pod state: the running jobs' process sets
        # (admission), the report buffer the readers fill, the dead and
        # silent followers, and the broken flag
        self._pod_cond = threading.Condition()
        #: job id -> (process set, pod_ordered); pod_ordered jobs run the
        #: unit protocol and may overlap other pod_ordered jobs
        self._active_procs: Dict[str, Tuple[frozenset, bool]] = {}
        # FIFO admission tickets: job id -> (ticket, procs, pod_ordered)
        self._admission_ticket = 0
        self._admission_waiting: Dict[str, Tuple[int, frozenset, bool]] = {}
        self.pod_units = PodUnitArbiter(send_to=self._send_to)
        # liveness, not duration: a follower is infra-dead only on heartbeat
        # SILENCE, never because a healthy job ran long
        self.hb_timeout = float(os.environ.get("HARMONY_POD_HB_TIMEOUT", "60"))
        self._last_seen: Dict[int, float] = {}
        self._hb_jobs: Dict[int, set] = {}
        self._silenced: set = set()
        self._unusable_procs: set = set()
        self._poison_scope: Optional[str] = None     # "partial" | "total"
        self._pod_broken: Optional[str] = None
        self._reports: Dict[Tuple[str, int], Dict[str, Any]] = {}
        self._dead_followers: set = set()
        self._readers: List[threading.Thread] = []
        self._pod_closing = False
        self._monitor_stop = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None
        #: job id -> {pid: report} (the leader's own leg under pid 0)
        self.pod_reports: Dict[str, Dict[int, Dict[str, Any]]] = {}
        #: job id -> (dispatch start, dispatch end), monotonic seconds
        self.job_walls: Dict[str, Tuple[float, float]] = {}
        #: job id -> {"units": the pod units its leader leg took}
        self._unit_counts: Dict[str, Dict[str, int]] = {}

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        super().start()
        if isinstance(self._scheduler, ProcessCarveScheduler):
            self._scheduler.set_process_map({
                eid: self.master.executor(eid).slot.process_index
                for eid in self.master.executor_ids()})

    def serve_pod(self, port: int = 0, join_timeout: float = 300.0,
                  host: str = "0.0.0.0") -> int:
        """Listen for follower JOINs; blocks until all ``num_followers``
        have joined (the pod's start is a barrier: a dispatch before it would
        hang in its first collective). Then one reader thread a follower
        demultiplexes its stream, and the monitor watches the heartbeats."""
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        sock.listen(16)
        self._pod_sock = sock
        bound = sock.getsockname()[1]
        sock.settimeout(join_timeout)
        while len(self._followers) < self._num_followers:
            try:
                conn, addr = sock.accept()
            except socket.timeout:
                raise TimeoutError(f"pod join: {len(self._followers)}/{self._num_followers} "
                                   f"followers after {join_timeout}s") from None
            pid, f = self._read_join(conn)
            if pid is None:
                continue
            with self._pod_cond:
                self._followers[pid] = (conn, f)
                self._send_locks[pid] = threading.Lock()
                self._last_seen[pid] = time.monotonic()
            log.info("pod follower %d joined from %s", pid, addr)
        for pid, (_, f) in sorted(self._followers.items()):
            t = threading.Thread(target=self._reader_loop, args=(pid, f), daemon=True,
                                 name=f"pod-reader-{pid}")
            t.start()
            self._readers.append(t)
        self._monitor_thread = threading.Thread(target=self._pod_monitor, daemon=True,
                                                name="pod-monitor")
        self._monitor_thread.start()
        return bound

    @staticmethod
    def _read_join(conn: socket.socket) -> "Tuple[Optional[int], Any]":
        """One JOIN on a fresh connection; (None, None) for anything else (a
        health check, a scanner), which is dropped, never crashing the loop."""
        conn.settimeout(30.0)
        f = conn.makefile("r")
        try:
            hello = _recv(f)
            pid = int(hello["pid"]) if hello else None
        except (socket.timeout, OSError, ValueError, KeyError, TypeError):
            hello, pid = None, None
        if not hello or hello.get("cmd") != "JOIN" or pid is None:
            conn.close()
            return None, None
        conn.settimeout(None)  # the reader thread owns this socket now
        return pid, f

    def _mark_broken(self, reason: str, scope: str = "total") -> None:
        """The one poison path: record the reason and wake every waiter. A
        TOTAL poison (a RUN_JOB delivered to some followers only) also
        force-grants the unit arbiter and tells the followers' trackers, so
        blocked threads fail through their error paths instead of wedging; a
        PARTIAL one (a follower's death, confined by _on_follower_death)
        keeps the arbiter for the surviving tenants."""
        with self._pod_cond:
            if self._pod_broken is None:
                self._pod_broken = reason
                log.error("pod broken (%s): %s", scope, reason)
            if self._poison_scope != "total":
                self._poison_scope = scope
            total = self._poison_scope == "total"
            self._pod_cond.notify_all()
        if not total:
            return
        self.pod_units.poison()
        for pid in sorted(self._followers):
            try:
                self._send_to(pid, {"cmd": "TU_POISON"})
            except OSError:
                pass

    def _on_follower_death(self, pid: int) -> None:
        """Confine the damage: the dead process, and every process that
        shares a running job with it (their threads may wait in collectives
        the dead one never joins), become unusable for later jobs."""
        with self._pod_cond:
            if pid in self._unusable_procs and pid in self._dead_followers:
                return
            wedged = {pid}
            for ps, _ in self._active_procs.values():
                if pid in ps:
                    wedged |= ps
            self._unusable_procs |= wedged
        log.warning("pod follower %d died: processes %s unusable", pid, sorted(wedged))

    def _pod_monitor(self) -> None:
        """Heartbeat staleness, noticed whenever it happens: a follower
        silent past ``hb_timeout`` is confined (its processes unusable)."""
        period = max(0.25, min(self.hb_timeout / 4.0, 2.0))
        while not self._monitor_stop.wait(period):
            with self._pod_cond:
                if self._pod_closing:
                    return
                now = time.monotonic()
                stale = [pid for pid in self._followers
                         if pid not in self._dead_followers and pid not in self._silenced
                         and now - self._last_seen.get(pid, now) > self.hb_timeout]
                for pid in stale:
                    self._silenced.add(pid)
                    self._unusable_procs.add(pid)
                if stale:
                    self._pod_cond.notify_all()
            for pid in stale:
                log.warning("pod follower %d silent past %.1fs: confined", pid, self.hb_timeout)

    def _reader_loop(self, pid: int, f) -> None:
        """Owns every read from follower ``pid``: JOB_DONE into the report
        buffer by (job id, pid), TU_WAIT/TU_DONE into the arbiter, HEARTBEAT
        into the liveness state. EOF marks the follower dead and, outside
        shutdown, poisons the pod partially."""
        while True:
            try:
                msg = _recv(f)
            except (OSError, ValueError):
                msg = None
            if msg is None:
                with self._pod_cond:
                    self._dead_followers.add(pid)
                    self._silenced.discard(pid)
                    closing = self._pod_closing
                    self._pod_cond.notify_all()
                self.pod_units.proc_done(pid)
                if not closing:
                    self._on_follower_death(pid)
                    self._mark_broken(f"follower {pid} connection lost", scope="partial")
                return
            cmd = msg.get("cmd")
            with self._pod_cond:
                # ANY traffic proves the process alive
                self._last_seen[pid] = time.monotonic()
                if cmd == "HEARTBEAT":
                    self._hb_jobs[pid] = set(msg.get("jobs", []))
                    self._pod_cond.notify_all()
            if cmd == "HEARTBEAT":
                continue
            if cmd == "TU_WAIT":
                self.pod_units.on_wait(str(msg.get("job_id")), int(msg.get("seq", 0)), pid,
                                       retry=bool(msg.get("retry", False)))
                continue
            if cmd == "TU_DONE":
                self.pod_units.on_done(str(msg.get("job_id")), int(msg.get("seq", 0)), pid)
                continue
            if cmd != "JOB_DONE":
                log.warning("pod: unexpected %r from follower %d", cmd, pid)
                continue
            with self._pod_cond:
                self._reports[(str(msg.get("job_id")), pid)] = msg
                while len(self._reports) > 1024:  # bound the leader's memory
                    self._reports.pop(next(iter(self._reports)))
                self._pod_cond.notify_all()

    def _send_to(self, pid: int, msg: Dict[str, Any]) -> None:
        conn, _ = self._followers[pid]
        with self._send_locks[pid]:
            _send(conn, msg)

    def _wait_report_live(self, job_id: str, pid: int) -> Optional[Dict[str, Any]]:
        """Wait for follower ``pid``'s report on ``job_id`` as long as it
        stays LIVE: None once its connection is lost, its heartbeats are
        silent past ``hb_timeout`` (with a short grace), or its heartbeats
        stop listing the job for ``hb_timeout`` with no report (a job thread
        that died without reporting). A healthy job may run for hours."""
        key = (job_id, pid)
        missing_since: Optional[float] = None
        with self._pod_cond:
            while key not in self._reports:
                if pid in self._dead_followers:
                    return None
                now = time.monotonic()
                if now - self._last_seen.get(pid, 0.0) > self.hb_timeout + min(5.0, self.hb_timeout):
                    return None
                hb = self._hb_jobs.get(pid)
                if hb is not None and job_id not in hb:
                    if missing_since is None:
                        missing_since = now
                    elif now - missing_since > self.hb_timeout:
                        return None
                else:
                    missing_since = None
                self._pod_cond.wait(timeout=1.0)
            return self._reports[key]

    def _collect_reports(self, job_id: str, participants: List[int]) -> Dict[int, Dict[str, Any]]:
        """One JOB_DONE from each participant; a dead or silent one is an
        ``infra`` entry rather than a wait forever."""
        out: Dict[int, Dict[str, Any]] = {}
        for pid in participants:
            rep = self._wait_report_live(job_id, pid)
            if rep is None:
                why = "follower lost" if pid in self._dead_followers else "heartbeat silence"
                out[pid] = {"ok": False, "infra": True, "error": why}
            else:
                out[pid] = rep
        with self._pod_cond:
            for pid in participants:
                self._reports.pop((job_id, pid), None)
        return out

    # -- dispatch ---------------------------------------------------------

    def _fail_job(self, config: JobConfig, error: str) -> None:
        self._jobs[config.job_id].set_exception(RuntimeError(error))
        self._scheduler.on_job_finish(config.job_id)

    def _status(self) -> Dict[str, Any]:
        out = super()._status()
        with self._pod_cond:
            out["pod"] = {
                "followers": sorted(self._followers),
                "broken": self._pod_broken,
                "active": {j: sorted(ps) for j, (ps, _) in self._active_procs.items()},
                "units_granted": self.pod_units.grants_total,
                "units_grant_to_done_s": round(self.pod_units.grant_to_done_s, 4),
                "silenced": sorted(self._silenced),
                "dead": sorted(self._dead_followers),
                "unusable_procs": sorted(self._unusable_procs),
                # the newest jobs' reports by process, and their walls
                "reports": {j: {str(p): r for p, r in reps.items()}
                            for j, reps in list(self.pod_reports.items())[-16:]},
                "walls": {j: list(w) for j, w in list(self.job_walls.items())[-16:]},
            }
        return out

    @staticmethod
    def _blocks(ps: frozenset, their_ordered: bool, procs: frozenset, ordered: bool) -> bool:
        """One conflict predicate for running AND waiting peers: overlap,
        both multi-process, and not both under the unit arbiter."""
        return bool(ps & procs) and len(ps) > 1 and len(procs) > 1 and not (
            ordered and their_ordered)

    def _conflicts_locked(self, job_id: str, procs: frozenset, ordered: bool) -> Optional[str]:
        """The admission rule (module doc): the job that blocks ``procs``, a
        running one or an older waiter, or None."""
        for jid, (ps, their_ordered) in self._active_procs.items():
            if self._blocks(ps, their_ordered, procs, ordered):
                return jid
        mine = self._admission_waiting.get(job_id)
        my_ticket = mine[0] if mine is not None else float("inf")
        for jid, (ticket, ps, their_ordered) in self._admission_waiting.items():
            if (jid != job_id and ticket < my_ticket
                    and self._blocks(ps, their_ordered, procs, ordered)):
                return jid
        return None

    def _dispatch(self, config: JobConfig, executor_ids: List[str]) -> None:
        with trace_span("pod.dispatch", job_id=config.job_id):
            self._dispatch_once_inner(config, executor_ids)

    def _dispatch_once_inner(self, config: JobConfig, executor_ids: List[str]) -> None:
        procs = frozenset(self.master.executor(e).slot.process_index for e in executor_ids)
        pod_ordered = (config.app_type in ("dolphin", "pregel") and len(procs) > 1
                       and not bool(config.user.get("pod_isolated")))
        admitted = False
        with self._pod_cond:
            while True:
                # a TOTAL poison fails everything; a PARTIAL one only the
                # jobs that touch an unusable process
                if self._pod_broken and self._poison_scope != "partial":
                    break
                if procs & self._unusable_procs:
                    break
                if self._conflicts_locked(config.job_id, procs, pod_ordered) is None:
                    self._active_procs[config.job_id] = (procs, pod_ordered)
                    self._admission_waiting.pop(config.job_id, None)
                    admitted = True
                    self._pod_cond.notify_all()  # ticket holders re-check
                    break
                if config.job_id not in self._admission_waiting:
                    self._admission_ticket += 1
                    self._admission_waiting[config.job_id] = (
                        self._admission_ticket, procs, pod_ordered)
                self._pod_cond.wait(timeout=1.0)
            if not admitted:
                self._admission_waiting.pop(config.job_id, None)
        if not admitted:
            self._fail_job(config, f"pod is broken ({self._pod_broken}); the job's processes "
                                   f"{sorted(procs & self._unusable_procs)} are unusable")
            return
        t0 = time.monotonic()
        if pod_ordered:
            # known to the arbiter before any participant's first TU_WAIT
            self.pod_units.register_job(config.job_id, procs)
        try:
            participants = sorted(p for p in procs if p != 0)
            run_local = 0 in procs
            if participants:
                log.info("pod: RUN_JOB %s to follower(s) %s (chief %d, local %s)",
                         config.job_id, participants, min(procs), run_local)
                msg = {"cmd": "RUN_JOB", "conf": config.to_dict(),
                       "executor_ids": list(executor_ids), "chief_pid": min(procs),
                       "trace": wire_context(), "pod_ordered": pod_ordered,
                       "chkp_root": self._chkp_root,
                       # the same TaskUnit phasing in every process
                       "cpu_slots": self.local_taskunit.cpu_slots,
                       "net_slots": self.local_taskunit.net_slots}
                try:
                    for pid in participants:
                        self._send_to(pid, msg)
                except OSError as e:
                    # followers that did get it now wait in collectives
                    self._mark_broken(f"RUN_JOB send failed: {e}")
                    self._fail_job(config, f"pod RUN_JOB send failed: {e}")
                    return
            local_report = None
            if run_local:
                before = _job_counters()
                super()._dispatch(config, executor_ids)
                fut = self._jobs[config.job_id]
                local_report = {"ok": fut.exception() is None,
                                **_counter_delta(before, _job_counters()),
                                **self._unit_counts.pop(config.job_id, {})}
                if fut.exception() is None:
                    local_report.update(_job_summary(fut.result()))
                else:
                    local_report["error"] = f"{type(fut.exception()).__name__}: {fut.exception()}"
            else:
                # the leader holds none of the job's slots: the chief
                # participant's report is the job's result
                self._resolve_remote(config, participants)
            reports = self._collect_reports(config.job_id, participants) if participants else {}
            dead = [pid for pid, r in reports.items() if r.get("infra")]
            for pid in dead:
                self._on_follower_death(pid)
            if dead:
                self._mark_broken(f"follower(s) {dead} never reported for {config.job_id}",
                                  scope="partial")
            if local_report is not None:
                reports = {0: local_report, **reports}
            with self._pod_cond:
                self.pod_reports[config.job_id] = reports
                while len(self.pod_reports) > 256:
                    self.pod_reports.pop(next(iter(self.pod_reports)))
        finally:
            podplan.clear(config.job_id)
            if pod_ordered:
                # every participant's TU_DONEs precede its JOB_DONE on one
                # socket: nothing of this job is in flight at the arbiter
                self.pod_units.deregister_job(config.job_id)
            with self._pod_cond:
                self.job_walls[config.job_id] = (t0, time.monotonic())
                while len(self.job_walls) > 1024:
                    self.job_walls.pop(next(iter(self.job_walls)))
                self._active_procs.pop(config.job_id, None)
                self._pod_cond.notify_all()

    def _resolve_remote(self, config: JobConfig, participants: List[int]) -> None:
        """A job wholly on followers: the lowest participant is its chief,
        and its JOB_DONE resolves the leader's future."""
        future = self._jobs[config.job_id]
        chief = min(participants)
        try:
            rep = self._wait_report_live(config.job_id, chief)
            if rep is None:
                raise RuntimeError(f"chief follower {chief} never reported for "
                                   f"{config.job_id} (connection lost or heartbeat silence)")
            if not rep.get("ok"):
                raise RuntimeError(f"remote job failed on follower {chief}: "
                                   f"{rep.get('error', 'unknown error')}")
            future.set_result(rep.get("result") or {"job_id": config.job_id,
                                                    "workers": rep.get("workers", {})})
        except BaseException as e:  # noqa: BLE001 - delivered through the future
            future.set_exception(e)
        finally:
            self._scheduler.on_job_finish(config.job_id)

    def _entity_extras(self, config: JobConfig, executor_ids: List[str]) -> Dict[str, Any]:
        """The leader's leg of the unit protocol for a job over several
        processes (not ``user.pod_isolated``)."""
        procs = {self.master.executor(e).slot.process_index for e in executor_ids}
        if (len(procs) > 1 and config.app_type in ("dolphin", "pregel")
                and not bool(config.user.get("pod_isolated"))):
            client = leader_client(self.pod_units, config.job_id)
            counts = self._unit_counts[config.job_id] = {"units": 0}
            return {"pod_unit_scope": _counted(client.scope, counts),
                    "pod_unit_contended": client.contended}
        return {}

    def _pod_reshard_command(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return {"ok": False, "error": POD_RESHARD_ERROR}

    def _on_closing(self, timeout: Optional[float] = 300.0) -> None:
        """The pod's teardown, once the jobs have drained: wait out the
        report collections still running, then SHUTDOWN every follower and
        close the control plane."""
        self._monitor_stop.set()
        with self._pod_cond:
            self._pod_cond.wait_for(lambda: not self._active_procs, timeout=30.0)
            self._pod_closing = True
        for pid in sorted(self._followers):
            try:
                self._send_to(pid, {"cmd": "SHUTDOWN"})
            except OSError:
                pass
        for conn, _ in list(self._followers.values()):
            try:
                conn.close()
            except OSError:
                pass
        if self._pod_sock is not None:
            self._pod_sock.close()
            self._pod_sock = None


class PodFollower:
    """The evaluator-side loop on processes 1..N-1 of a pod.

    Its ETMaster allocates executors over the same global slots in the same
    order as the leader's, so an executor id names the same slot on both.
    Each RUN_JOB runs on a thread of its own: a follower may take part in
    several jobs at once, sharing one process-wide TaskUnit scheduler as the
    leader's local jobs do."""

    def __init__(self, leader_host: str, pod_port: int, pid: int, num_executors: int,
                 pool=None, join_timeout: float = 300.0) -> None:
        from harmony_tpu_torch.metrics.manager import MetricManager
        from harmony_tpu_torch.runtime.master import ETMaster

        self.pid = pid
        # the leader may still be starting: retry until the deadline
        deadline = time.monotonic() + join_timeout
        while True:
            try:
                self._sock = socket.create_connection((leader_host, pod_port), timeout=10.0)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.5)
        self._sock.settimeout(None)  # RUN_JOB may come much later
        self._file = self._sock.makefile("r")
        self._send_lock = threading.Lock()
        self._pod_units = FollowerUnits(report=self._report)
        self._job_threads: List[threading.Thread] = []
        #: job id -> live entity (listed by the heartbeats)
        self._entities: Dict[str, Any] = {}
        _send(self._sock, {"cmd": "JOIN", "pid": pid})
        self.master = ETMaster(pool)
        self.master.add_executors(num_executors)
        self.metrics = MetricManager()
        self.metrics.start_collection()
        # the liveness beacon: the leader's report waits are gated on it,
        # never on a job's duration
        self._hb_period = float(os.environ.get("HARMONY_POD_HB_PERIOD", "5"))
        self._hb_stop = threading.Event()
        threading.Thread(target=self._heartbeat_loop, daemon=True,
                         name=f"pod-hb-{pid}").start()

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(self._hb_period):
            try:
                self._report({"cmd": "HEARTBEAT", "pid": self.pid,
                              "jobs": sorted(list(self._entities))})
            except OSError:
                return  # the leader is gone; run() handles it

    def _report(self, payload: Dict[str, Any]) -> None:
        with self._send_lock:
            _send(self._sock, payload)

    def run(self) -> None:
        """Serve RUN_JOBs until SHUTDOWN or the leader hangs up."""
        from harmony_tpu_torch.runtime.taskunit import GlobalTaskUnitScheduler

        global_tu = GlobalTaskUnitScheduler()
        # the leader's policy: metering is a blocking-backend concept
        global_tu.meter_execution = all(
            self.master.executor(e).device.type == "cpu" for e in self.master.executor_ids())
        while True:
            try:
                msg = _recv(self._file)
            except (OSError, ValueError):
                msg = None
            if msg is None or msg.get("cmd") == "SHUTDOWN":
                for t in self._job_threads:
                    t.join(timeout=60.0)
                self._hb_stop.set()
                self._sock.close()
                return
            cmd = msg.get("cmd")
            if cmd == "TU_GRANT":
                self._pod_units.on_grant(str(msg.get("job_id")), int(msg.get("seq", 0)),
                                         bool(msg.get("contended", False)))
                continue
            if cmd == "TU_POISON":
                self._pod_units.on_poison()
                continue
            if cmd != "RUN_JOB":
                log.warning("pod follower %d: unexpected %r", self.pid, cmd)
                continue
            t = threading.Thread(target=self._run_job, args=(msg, global_tu), daemon=True,
                                 name=f"pod-job-{msg.get('conf', {}).get('job_id', '?')}")
            self._job_threads = [x for x in self._job_threads if x.is_alive()]
            self._job_threads.append(t)
            t.start()

    def _run_job(self, msg: Dict[str, Any], global_tu) -> None:
        """One span a follower's leg, under the leader's dispatch span (the
        RUN_JOB's trace context)."""
        with trace_span("pod.follower_job", parent=SpanContext.from_wire(msg.get("trace")),
                        job_id=msg.get("conf", {}).get("job_id"), pid=self.pid):
            self._run_job_inner(msg, global_tu)

    def _run_job_inner(self, msg: Dict[str, Any], global_tu) -> None:
        from harmony_tpu_torch.jobserver.entity import build_entity
        from harmony_tpu_torch.runtime.taskunit import LocalTaskUnitScheduler

        config = ConfigBase.from_dict(msg["conf"])
        executor_ids = msg["executor_ids"]
        chief = int(msg.get("chief_pid", 0)) == self.pid
        report: Dict[str, Any] = {"cmd": "JOB_DONE", "pid": self.pid, "job_id": config.job_id}
        unit_extras: Dict[str, Any] = {}
        counts = {"units": 0}
        if msg.get("pod_ordered"):
            client = follower_client(self._pod_units, config.job_id)
            unit_extras = {"pod_unit_scope": _counted(client.scope, counts),
                           "pod_unit_contended": client.contended}
        entity = None
        before = _job_counters()
        try:
            missing = set(executor_ids) - set(self.master.executor_ids())
            if missing:
                raise RuntimeError(f"follower {self.pid} missing executors {missing} "
                                   "(leader/follower allocation orders diverged)")
            # the leader's entity exactly: the same TaskUnit phasing
            entity = build_entity(
                config, chkp_root=msg.get("chkp_root"), global_taskunit=global_tu,
                local_taskunit=LocalTaskUnitScheduler(msg.get("cpu_slots", 1),
                                                      msg.get("net_slots", 2)),
                metric_sink=self.metrics.on_metric, metric_manager=self.metrics,
                **unit_extras)
            self._entities[config.job_id] = entity
            entity.setup(self.master, executor_ids)
            result = entity.run()
            entity.cleanup()
            report["ok"] = True
            report.update(_job_summary(result))
            if chief:
                # resolves the leader's future when it holds none of the slots
                report["result"] = _json_sanitize(result)
        except BaseException as e:  # noqa: BLE001 - reported to the leader
            if entity is not None:
                try:
                    entity.cleanup()
                except Exception:
                    pass
            report["ok"] = False
            report["error"] = f"{type(e).__name__}: {e}"
        report.update(_counter_delta(before, _job_counters()), **counts)
        self._entities.pop(config.job_id, None)
        self._pod_units.forget(config.job_id)
        try:
            self._report(report)
        except OSError:
            pass  # the leader is gone
