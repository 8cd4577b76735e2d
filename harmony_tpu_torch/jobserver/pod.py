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
that shared a running job with it. A follower started with
``HARMONY_METRICS_PORT`` runs a ``/metrics`` exporter of its own and
advertises its port on every HEARTBEAT; the leader's history scraper adds
each live follower's exporter to its targets as ``pod:<pid>`` (dead and
silenced followers are skipped), and STATUS's ``pod.metrics_ports`` lists
them.

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

Plans on a running job (``schedule_pod_reshard``, the ``POD_RESHARD``
command, ``cli pod-reshard``, and the leader's optimizer loop through the
``pod_plan_sink`` of ``_entity_extras``): the leader sends PLAN to the job's
followers and registers the plan itself (``jobserver/podplan.py``), and every
process applies the move at its chief's epoch hook of the plan's epoch
(``jobserver/entity.py``), the table's blocks crossing processes over
``table/blockmove.py``'s transports. A plan must lead the job's observed
epoch by a full window horizon (``WorkerTasklet.EPOCH_WINDOW`` + 1): the
leader reads that epoch from its own entity, or asks the chief follower of a
job wholly on followers (PROGRESS_REQ, answered PROGRESS_REP from the
follower's control loop, which reads its socket apart from the jobs'
threads). A PLAN delivered to some followers only marks the pod broken.

The collective deferred evaluation (a job with a chain and
``offline_model_eval`` over several processes): at shutdown the leader's
closure opens ``_pod_eval_channel``. It sends EVAL_COLLECTIVE to the job's
followers, each of which stages everything that can fail on its host and
answers EVAL_COLLECTIVE_READY; only when every one is ready does the leader
send EVAL_GO (else EVAL_ABORT, and the evaluation fails cleanly), and every
process restores and evaluates the chain together. The followers then answer
EVAL_COLLECTIVE_DONE; a partial GO, or a follower silent or failed after GO,
marks the pod broken. A job wholly on a follower evaluates there: its chief
keeps the closure (JOB_DONE's ``has_deferred_eval``), runs it at SHUTDOWN and
sends EVAL_DONE, which the leader's ``_on_closing`` collects into
``eval_results``.

Liveness and confinement: the monitor confines a follower whose BEACON has
been silent past ``hb_timeout`` (``_on_follower_silence``: its executors
retire from the scheduler, and the elastic jobs spanning it are fenced to
shrink), and rehabilitates it when its beacon resumes (``_rehabilitate``:
its executors come back, the pod's partial poison lifts once every confined
process is back, and the shrunk elastic jobs are fenced to re-grow). The
port reads the beacon alone here, where the reference counts any traffic: a
multi-process job's unit messages come from its job threads and would hide
a mute beacon. A lost connection is a death (``_on_follower_death``): the
dead process and every process sharing a running job with it become
unusable and their executors retire. Report waits still count any traffic
as life.

Elastic recovery (``jobserver/elastic.py``): a Dolphin job flagged
``user.elastic_shrink`` with a chain (``_elastic_eligible``) runs as one
submission of attempts (``_dispatch_elastic``). Each attempt is an ordinary
dispatch under its attempt key (``job@aN``: its RUN_JOB's ``att``, its
reports, unit messages and heartbeat listings) with a future of its own; the
client's future resolves once. An attempt that ends on a fence, a
participant's death or silence, or an ``infra_suspect`` report is followed
by the next (``_plan_elastic_recovery``: the scheduler's ``reacquire``
prefers the survivors for a shrink and the original layout for a re-grow,
and the entity restores through ``restore_partial`` onto the mesh
``_mesh_over`` makes of the new grant at the job's own ``data_axis``: a
data-axis job whose rows lay in different processes recovers on the rows
the survivors hold, data 1 where their count is odd); one that fails on its
own terms ends the submission, and ``HARMONY_ELASTIC_MAX_SHRINKS`` caps the
recoveries. A fence is a PLAN with ``elastic_fence`` at the epoch ``cur +
EPOCH_WINDOW + 2``, ``cur`` read from the leader's entity or a healthy
participant's PROGRESS_REQ, and never below the epoch a recovery attempt
resumes at (an attempt still in set-up reads 0; ``_schedule_elastic_fence``).
A non-elastic job flagged ``user.auto_resume`` that failed on infra evidence
is resubmitted with ``resume_from_chain`` (``_maybe_auto_resume``,
``auto_resumed``).
STATUS's ``elastic`` block and the ``pod`` block's ``reinstated`` and
``auto_resumed`` show it; the events also go to ``jobserver/joblog.py``.

Late joins (``_accept_late_joins``, after the bootstrap): a JOIN for a known
pid reinstates that follower (``_reinstate_follower``) only when it carries
the incarnation token the process sent at bootstrap, i.e. it is the same
process, still a member of the ``torch.distributed`` world. A new process
under a dead pid is refused with ``JOIN_REFUSED``: the world, its store and
its groups were fixed when the pod started, so it could join no collective.

HA's follower half (``jobserver/ha.py``): the leader stamps its
``leader_epoch`` (its lease's epoch; 0 outside HA, and then nothing is
stamped) on every message it sends a follower (``_send_to``). A follower
rejects a message below the highest epoch it has seen before it dispatches
anything, SHUTDOWN included (``_reject_stale``: a stale RUN_JOB is answered
with a failed JOB_DONE marked ``stale_epoch``, keyed by its attempt). With HA
on (``HARMONY_HA_LOG_DIR``, or ``reconnect=True``) a follower that loses its
leader JOINs again, under its pid and its incarnation token, the first of
``leader_addrs`` to answer (``_rejoin``), so the late-join path reinstates
the same process. As in the reference, no pod leader takes over from another:
process 0 holds the ``torch.distributed`` store, so its death ends the pod
(ROADMAP A item 5).

Left out (ROADMAP A item 5): the policy hooks.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from harmony_tpu_torch.config.base import ConfigBase
from harmony_tpu_torch.config.params import JobConfig
from harmony_tpu_torch.jobserver import elastic, podplan
from harmony_tpu_torch.jobserver.joblog import job_logger, record_event
from harmony_tpu_torch.jobserver.scheduler import ProcessCarveScheduler
from harmony_tpu_torch.jobserver.server import JobServer, _json_sanitize
from harmony_tpu_torch.metrics.exporter import exporter_from_env
from harmony_tpu_torch.runtime.podunits import (
    FollowerUnits,
    PodUnitArbiter,
    follower_client,
    leader_client,
)
from harmony_tpu_torch.tracing.span import SpanContext, trace_span, wire_context

log = logging.getLogger(__name__)

#: what a follower's JOB_DONE keeps of a job's result beside its workers
_SUMMARY_KEYS = ("applied_plans", "plan_moves", "model_chkp_ids", "model_chkp_stats",
                 "elastic_restore", "train_wall")

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
    losses, epoch seconds, comm probes, epoch range and seconds from its
    first epoch's start to its last's end (hooks included), the data rows
    the process computed and its steps whose batch was restaged, the pod plans
    the process applied or skipped and its side of each plan's exchange, its
    chain's ids and this process's share of each entry
    (``model_chkp_stats``), an elastic attempt's restore (``elastic_restore``)
    and the wall clock at the first epoch; for a graph job its supersteps, their wall
    seconds and a SHA-256 of its vertex values' bytes."""
    out: Dict[str, Any] = {"workers": {
        wid: {"losses": [float(x) for x in w.get("losses", [])],
              "batch_losses": [float(x) for x in w.get("batch_losses", [])],
              "epoch_seconds": [float(x) for x in w.get("epoch_seconds", [])],
              "probes": int(w.get("comm_probe", {}).get("probes", 0)),
              "starting_epoch": int(w.get("starting_epoch", 0)),
              "epochs_run": int(w.get("epochs_run", len(w.get("losses", [])))),
              "train_seconds": (float(w["train_span"][1] - w["train_span"][0])
                                if "train_span" in w else None),
              "data_rows": list(w.get("data_rows", [])),
              "restaged_batches": int(w.get("input", {}).get("restaged_batches", 0))}
        for wid, w in result.get("workers", {}).items()}}
    for key in _SUMMARY_KEYS:
        if key in result:
            out[key] = result[key]
    if "vertex_values" in result:
        values = np.ascontiguousarray(result["vertex_values"])
        out.update(supersteps=int(result["supersteps"]), wall_sec=float(result["wall_sec"]),
                   vertex_digest=hashlib.sha256(values.tobytes()).hexdigest())
    return out


def _resume_epoch(mgr, chain: List[str]) -> int:
    """The epoch a restore of the newest of the ``chain`` entries resumes
    at (its epoch tag + 1; 0 with no readable tag). A restore that falls
    back past a corrupt entry resumes earlier, so a fence placed from this
    epoch is only later than it must be."""
    from harmony_tpu_torch.checkpoint.manager import CheckpointCorruptError

    newest = -1
    for cid in chain:
        try:
            meta = mgr.info(cid).app_meta or {}
        except (CheckpointCorruptError, FileNotFoundError):
            continue
        if "epoch" in meta:
            newest = max(newest, int(meta["epoch"]))
    return newest + 1


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
        #: pid -> its last HEARTBEAT: confinement and rehabilitation read the
        #: beacon alone (module doc)
        self._last_beat: Dict[int, float] = {}
        #: pid -> the incarnation token of the process that JOINed at the
        #: bootstrap (a late JOIN must carry it)
        self._incarnations: Dict[int, Optional[str]] = {}
        self._hb_jobs: Dict[int, set] = {}
        #: pid -> the /metrics exporter port its latest HEARTBEAT advertised
        #: (the history scraper's target discovery); absent when the follower
        #: runs without HARMONY_METRICS_PORT
        self._hb_metrics_ports: Dict[int, int] = {}
        #: pid -> the address the follower connected from: the host half of
        #: its scrape target
        self._follower_hosts: Dict[int, str] = {}
        self._silenced: set = set()
        self._unusable_procs: set = set()
        self._poison_scope: Optional[str] = None     # "partial" | "total"
        self._pod_broken: Optional[str] = None
        self._reports: Dict[Tuple[str, int], Dict[str, Any]] = {}
        # the progress queries waiting for their reply, by (key, pid)
        self._progress_waiting: set = set()
        self._progress_seq = 0
        self._dead_followers: set = set()
        self._readers: List[threading.Thread] = []
        self._pod_closing = False
        self._monitor_stop = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None
        self._late_join_thread: Optional[threading.Thread] = None
        #: pids reinstated by a late JOIN, and the late JOINs refused
        self.reinstated: List[int] = []
        self.refused_joins: List[Dict[str, Any]] = []
        #: job id -> the live elastic attempt ({"attempt", "procs",
        #: "original_procs", "config", "executors"}): what fences read
        self._elastic_active: Dict[str, Dict[str, Any]] = {}
        #: job id -> the future of its running elastic attempt
        self._attempt_futures: Dict[str, Future] = {}
        #: recent recovery events (bounded; STATUS's elastic block)
        self.elastic_events: List[Dict[str, Any]] = []
        #: jobs whose failure was infra-observed (a participant died or went
        #: silent, or reported infra_suspect): auto-resume's evidence
        self._infra_failed: set = set()
        #: job ids auto-resumed
        self.auto_resumed: List[str] = []
        #: attempt key -> {pid: report} (the leader's own leg under pid 0)
        self.pod_reports: Dict[str, Dict[int, Dict[str, Any]]] = {}
        #: attempt key -> (dispatch start, dispatch end), monotonic seconds
        self.job_walls: Dict[str, Tuple[float, float]] = {}
        #: attempt key -> {"units": the pod units its leader leg took}
        self._unit_counts: Dict[str, Dict[str, int]] = {}
        #: running job id -> its follower participants, what
        #: schedule_pod_reshard sends PLAN to
        self._job_info: Dict[str, List[int]] = {}
        #: job id -> the followers of its collective deferred evaluation
        #: (only jobs with a chain and offline_model_eval)
        self._eval_participants: Dict[str, List[int]] = {}
        #: job id -> the chief follower holding its deferred evaluation (a
        #: job wholly on followers), and the EVAL_DONE results they send
        self._remote_evals: Dict[str, int] = {}
        self._remote_eval_results: Dict[str, Any] = {}

    @property
    def pod_broken(self) -> Optional[str]:
        """Why the pod was marked broken, or None."""
        with self._pod_cond:
            return self._pod_broken

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
            pid, f, token = self._read_join(conn)
            if pid is None:
                continue
            with self._pod_cond:
                self._followers[pid] = (conn, f)
                self._send_locks[pid] = threading.Lock()
                self._last_seen[pid] = self._last_beat[pid] = time.monotonic()
                self._incarnations[pid] = token
                self._follower_hosts[pid] = addr[0]
            log.info("pod follower %d joined from %s", pid, addr)
        for pid, (_, f) in sorted(self._followers.items()):
            t = threading.Thread(target=self._reader_loop, args=(pid, f), daemon=True,
                                 name=f"pod-reader-{pid}")
            t.start()
            self._readers.append(t)
        self._monitor_thread = threading.Thread(target=self._pod_monitor, daemon=True,
                                                name="pod-monitor")
        self._monitor_thread.start()
        # a follower may JOIN again at any time after the bootstrap
        sock.settimeout(1.0)
        self._late_join_thread = threading.Thread(target=self._accept_late_joins,
                                                  daemon=True, name="pod-late-join")
        self._late_join_thread.start()
        return bound

    @staticmethod
    def _read_join(conn: socket.socket) -> "Tuple[Optional[int], Any, Optional[str]]":
        """One JOIN on a fresh connection: (pid, reader, incarnation token);
        (None, None, None) for anything else (a health check, a scanner),
        which is dropped, never crashing the loop."""
        conn.settimeout(30.0)
        f = conn.makefile("r")
        try:
            hello = _recv(f)
            pid = int(hello["pid"]) if hello else None
        except (socket.timeout, OSError, ValueError, KeyError, TypeError):
            hello, pid = None, None
        if not hello or hello.get("cmd") != "JOIN" or pid is None:
            conn.close()
            return None, None, None
        conn.settimeout(None)  # the reader thread owns this socket now
        token = hello.get("incarnation")
        return pid, f, None if token is None else str(token)

    def _accept_late_joins(self) -> None:
        """The accept loop after the bootstrap: every JOIN goes to
        :meth:`_reinstate_follower`, which reinstates or refuses it."""
        sock = self._pod_sock
        while True:
            with self._pod_cond:
                if self._pod_closing:
                    return
            try:
                conn, addr = sock.accept()
            except socket.timeout:
                continue
            except (OSError, AttributeError):
                return  # the listener closed (shutdown)
            pid, f, token = self._read_join(conn)
            if pid is None:
                continue
            log.info("pod follower %d JOINed again from %s", pid, addr)
            self._reinstate_follower(pid, conn, f, token)

    def _reinstate_follower(self, pid: int, conn: socket.socket, f,
                            token: Optional[str] = None) -> bool:
        """Wire a follower back in: a fresh reader, its liveness state reset,
        its executors restored and the shrunk elastic jobs offered a re-grow
        (``_rehabilitate``). Only the process that joined at the bootstrap
        (the same incarnation token) is reinstated: any other process under
        that pid is outside the torch.distributed world, whose size, store
        and groups were fixed when the pod started, so its executors would
        give later multi-process jobs a participant that never arrives. That
        JOIN is refused (JOIN_REFUSED, the reason named) and recorded in
        ``refused_joins``. Returns whether the follower was reinstated."""
        with self._pod_cond:
            known = pid in self._incarnations
            expected = self._incarnations.get(pid)
        if not known or token is None or token != expected:
            why = ("no pod process of that id joined at the bootstrap" if not known
                   else "a new process under the pid of a pod process: the "
                   "torch.distributed world, its store and its process groups were "
                   "fixed when the pod started, so it could join no collective")
            reason = f"JOIN of process {pid} refused: {why}"
            log.error("%s", reason)
            with self._pod_cond:
                self.refused_joins.append({"pid": pid, "error": reason})
                del self.refused_joins[:-64]
            try:
                _send(conn, {"cmd": "JOIN_REFUSED", "pid": pid, "error": reason})
            except OSError:
                pass
            conn.close()
            return False
        try:
            peer_host = conn.getpeername()[0]
        except OSError:
            peer_host = None
        with self._pod_cond:
            old = self._followers.pop(pid, None)
            self._followers[pid] = (conn, f)
            self._send_locks[pid] = threading.Lock()
            self._last_seen[pid] = self._last_beat[pid] = time.monotonic()
            self._hb_jobs.pop(pid, None)
            # the process re-advertises its exporter on its next beat; the
            # old port may be gone with the connection
            self._hb_metrics_ports.pop(pid, None)
            if peer_host is not None:
                self._follower_hosts[pid] = peer_host
            self._dead_followers.discard(pid)
            self._pod_cond.notify_all()
        if old is not None:
            try:
                old[0].close()
            except OSError:
                pass
        t = threading.Thread(target=self._reader_loop, args=(pid, f), daemon=True,
                             name=f"pod-reader-{pid}")
        t.start()
        self._readers.append(t)
        with self._pod_cond:
            self.reinstated.append(pid)
        self.pod_units.proc_done(pid)  # stale DONE obligations end here
        self._rehabilitate(pid, reason="JOIN of the same process")
        return True

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

    def _record_infra_failed_locked(self, job_id: str) -> None:
        """Auto-resume's evidence for ``job_id`` (under ``_pod_cond``); trimmed
        before the add, so the id just recorded is never the one evicted."""
        while len(self._infra_failed) >= 1024:
            self._infra_failed.pop()
        self._infra_failed.add(job_id)

    def _proc_executors(self, pid: int) -> List[str]:
        return [e for e in self.master.executor_ids()
                if self.master.executor(e).slot.process_index == pid]

    def _on_follower_death(self, pid: int) -> None:
        """Confine the damage: the dead process, and every process that
        shares a running job with it (their threads may wait in collectives
        the dead one never joins), become unusable, and their executors
        retire from the scheduler's grants. Everything else stays
        schedulable: surviving jobs go on, elastic and auto-resume jobs
        recover on the rest."""
        with self._pod_cond:
            if pid in self._unusable_procs and pid in self._dead_followers:
                return  # confined already (the reader's EOF and a report wait race)
            wedged = {pid}
            for ps, _ in self._active_procs.values():
                if pid in ps:
                    wedged |= ps
            self._unusable_procs |= wedged
        retired = [e for p in sorted(wedged) for e in self._proc_executors(p)]
        if retired:
            self._scheduler.retire(retired)
        log.warning("pod follower %d died: processes %s unusable, executors %s retired",
                    pid, sorted(wedged), retired)
        self._record_pod_event("follower_death", pid=pid, wedged=sorted(wedged),
                               retired=retired)

    def _pod_monitor(self) -> None:
        """The liveness loop: a follower whose beacon is silent past
        ``hb_timeout`` is confined (``_on_follower_silence``), and a confined
        one whose beats resume is rehabilitated (``_rehabilitate``). Deaths
        (a reader's EOF) go through ``_on_follower_death``."""
        period = max(0.25, min(self.hb_timeout / 4.0, 2.0))
        while not self._monitor_stop.wait(period):
            with self._pod_cond:
                if self._pod_closing:
                    return
                now = time.monotonic()
                stale, fresh = [], []
                for pid in self._followers:
                    if pid in self._dead_followers:
                        continue
                    quiet = now - self._last_beat.get(pid, now)
                    if quiet > self.hb_timeout:
                        if pid not in self._silenced and pid not in self._unusable_procs:
                            stale.append((pid, quiet))
                    elif pid in self._silenced:
                        fresh.append(pid)
            for pid, quiet in stale:
                self._on_follower_silence(pid, quiet)
            for pid in fresh:
                self._rehabilitate(pid, reason="heartbeats resumed")

    def _on_follower_silence(self, pid: int, quiet: float = 0.0) -> None:
        """Confined on silence: the process may be alive (a partition, a
        mute beacon), so, unlike a death, its co-participants are not
        presumed wedged. Its executors retire, and the elastic jobs spanning
        it are fenced to shrink."""
        with self._pod_cond:
            if pid in self._dead_followers or pid in self._silenced:
                return
            self._silenced.add(pid)
            self._unusable_procs.add(pid)
            self._pod_cond.notify_all()
        retired = self._proc_executors(pid)
        if retired:
            self._scheduler.retire(retired)
        log.warning("pod follower %d silent for %.1fs (past %.1fs): confined, executors "
                    "%s retired", pid, quiet, self.hb_timeout, retired)
        self._record_pod_event("follower_silenced", pid=pid, retired=retired,
                               silent_for=round(quiet, 3))
        self._schedule_elastic_fences("shrink", pid)

    def _rehabilitate(self, pid: int, reason: str) -> None:
        """A confined follower is alive again (its beats resumed, or it
        JOINed again): lift the confinement, restore its executors, lift a
        partial poison once every confined process is back, and fence the
        shrunk elastic jobs to re-grow toward their original layout."""
        with self._pod_cond:
            if pid in self._dead_followers:
                return  # its reader saw EOF since
            self._silenced.discard(pid)
            self._unusable_procs.discard(pid)
            if (self._poison_scope == "partial" and not self._dead_followers
                    and not self._unusable_procs):
                self._pod_broken = None
                self._poison_scope = None
            self._pod_cond.notify_all()
        restored = self._proc_executors(pid)
        if restored:
            self._scheduler.restore(restored)
        log.info("pod follower %d rehabilitated (%s); executors %s restored", pid,
                 reason, restored)
        self._record_pod_event("follower_rehabilitated", pid=pid, reason=reason,
                               restored=restored)
        if elastic.regrow_enabled():
            self._schedule_elastic_fences("regrow", pid)

    def _record_pod_event(self, kind: str, job_id: Optional[str] = None,
                          **fields: Any) -> Dict[str, Any]:
        """One recovery event, in the job's (or the pod's) event ring and in
        ``elastic_events``."""
        ev = record_event(job_id or "__pod__", kind, **fields)
        self._keep_event(ev, job_id or "__pod__")
        return ev

    def _keep_event(self, ev: Dict[str, Any], job_id: str) -> None:
        with self._pod_cond:
            self.elastic_events.append(dict(ev, job_id=job_id))
            del self.elastic_events[:-256]

    def _elastic_give_up(self, job_id: str, **fields: Any) -> None:
        """The terminal elastic outcome: one event in the job's log and in
        ``elastic_events``, so STATUS says why a tenant stopped recovering."""
        self._keep_event(job_logger(job_id).event("elastic_give_up", **fields), job_id)

    # -- elastic fences -----------------------------------------------------

    def _schedule_elastic_fences(self, kind: str, pid: int) -> None:
        """Offer every affected running elastic job a fence: a shrink for the
        jobs spanning the confined pid, a re-grow for the shrunk jobs that
        can expand back onto a rehabilitated one."""
        with self._pod_cond:
            targets = [jid for jid, st in self._elastic_active.items()
                       if (kind == "shrink" and pid in st["procs"])
                       or (kind == "regrow" and st["attempt"] > 0
                           and pid not in st["procs"] and pid in st["original_procs"])]
        for jid in targets:
            try:
                self._schedule_elastic_fence(jid, kind)
            except Exception as e:  # noqa: BLE001 - a fence is best-effort
                job_logger(jid).warning("elastic %s fence could not be scheduled: %s: %s",
                                        kind, type(e).__name__, e)

    def _schedule_elastic_fence(self, job_id: str, kind: str) -> Optional[int]:
        """A fence on a RUNNING attempt: a PLAN with ``elastic_fence`` at the
        epoch ``cur + EPOCH_WINDOW + 2`` (past the window horizon, as
        ``schedule_pod_reshard`` requires), so every process's chief hook
        raises it at the same epoch. ``cur`` comes from the leader's entity,
        else from a HEALTHY participant (the silent one may be the chief);
        with only confined ones left, from one of them under a short timeout;
        and never below the epoch a recovery attempt resumes at, since an
        attempt still in set-up (restoring its chain entry) reads 0 there.
        Returns the epoch, or None when the job ends before it."""
        from harmony_tpu_torch.dolphin.worker import WorkerTasklet

        with self._pod_cond:
            st = self._elastic_active.get(job_id)
            if st is None:
                return None
            procs, att, resume = set(st["procs"]), st["attempt"], st["resume_epoch"]
            num_epochs = st["config"].params.num_epochs
            silenced = set(self._silenced)
        with self._lock:
            ent = self._entities.get(job_id)
        cur = 0
        if ent is not None:
            progress = getattr(ent, "progress", None)
            cur = (progress.starting_epoch() if progress is not None
                   else getattr(ent, "_starting_epoch", 0))
        else:
            participants = sorted(p for p in procs if p != 0)
            healthy = [p for p in participants if p not in silenced]
            rkey = elastic.attempt_key(job_id, att)
            if healthy:
                cur = self._query_remote_epoch(rkey, healthy[0])
            elif participants:
                cur = self._query_remote_epoch(rkey, participants[0], timeout=5.0)
        cur = max(cur, resume)
        epoch = cur + WorkerTasklet.EPOCH_WINDOW + 2
        if epoch >= num_epochs:
            job_logger(job_id).info("elastic %s fence skipped: its earliest epoch %d is "
                                    "past the job's end (%d epochs)", kind, epoch, num_epochs)
            return None
        plan = {"epoch": int(epoch), "elastic_fence": kind}
        for p in sorted(p for p in procs if p != 0):
            try:
                self._send_to(p, {"cmd": "PLAN", "job_id": job_id, "plan": plan})
            except OSError:
                # an unreachable participant misses the fence; its silence is
                # classified by the attempt's report waits
                pass
        podplan.schedule(job_id, plan)
        self._record_pod_event(f"elastic_{kind}_fence", job_id=job_id, epoch=int(epoch),
                               attempt=att, observed_epoch=int(cur))
        return epoch

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
                    cur = self._followers.get(pid)
                    stale = cur is None or cur[1] is not f
                    if not stale:
                        self._dead_followers.add(pid)
                        self._silenced.discard(pid)  # dead outranks silent
                    closing = self._pod_closing
                    self._pod_cond.notify_all()
                if stale:
                    return  # superseded by a reinstated connection
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
                    self._last_beat[pid] = self._last_seen[pid]
                    self._hb_jobs[pid] = set(msg.get("jobs", []))
                    if msg.get("metrics_port"):
                        self._hb_metrics_ports[pid] = int(msg["metrics_port"])
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
            if cmd == "PROGRESS_REP":
                self._on_progress_rep(pid, msg)
                continue
            if cmd in ("EVAL_COLLECTIVE_READY", "EVAL_COLLECTIVE_DONE"):
                prefix = "__evalr__" if cmd == "EVAL_COLLECTIVE_READY" else "__evalc__"
                with self._pod_cond:
                    self._reports[(f"{prefix}{msg.get('job_id')}", pid)] = msg
                    self._pod_cond.notify_all()
                continue
            if cmd == "EVAL_DONE":
                # a chief follower's deferred evaluation, run at its SHUTDOWN
                with self._pod_cond:
                    self._remote_eval_results[str(msg.get("job_id"))] = msg.get(
                        "result", {"error": "empty EVAL_DONE"})
                    self._pod_cond.notify_all()
                continue
            if cmd != "JOB_DONE":
                log.warning("pod: unexpected %r from follower %d", cmd, pid)
                continue
            with self._pod_cond:
                self._reports[(str(msg.get("job_id")), pid)] = msg
                while len(self._reports) > 1024:  # bound the leader's memory
                    self._reports.pop(next(iter(self._reports)))
                self._pod_cond.notify_all()

    def _on_progress_rep(self, pid: int, msg: Dict[str, Any]) -> None:
        """Keep follower ``pid``'s PROGRESS_REP only while the query it
        answers (its ``req``) waits: a reply that comes after its query gave
        up is dropped, or it would answer a later query with an older
        epoch."""
        key = (f"__prog__{msg.get('job_id')}#{msg.get('req')}", pid)
        with self._pod_cond:
            if key in self._progress_waiting:
                self._reports[key] = msg
                self._pod_cond.notify_all()

    def _send_to(self, pid: int, msg: Dict[str, Any]) -> None:
        if self.leader_epoch and "leader_epoch" not in msg:
            # HA fencing: every message to a follower carries the leader
            # epoch, and a follower drops what comes below the highest it has
            # seen, so a deposed leader's late RUN_JOB or PLAN never acts
            msg = dict(msg, leader_epoch=self.leader_epoch)
        conn, _ = self._followers[pid]
        with self._send_locks[pid]:
            _send(conn, msg)

    def _wait_report(self, key: str, pid: int, deadline: float) -> Optional[Dict[str, Any]]:
        """Follower ``pid``'s message under ``key`` (a short protocol reply),
        None once it is dead or past ``deadline``."""
        with self._pod_cond:
            while (key, pid) not in self._reports:
                remaining = deadline - time.monotonic()
                if pid in self._dead_followers or remaining <= 0:
                    return None
                self._pod_cond.wait(timeout=min(remaining, 1.0))
            return self._reports.pop((key, pid))

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

    def _future_of(self, job_id: str) -> Future:
        """The running elastic attempt's future, else the submission's."""
        with self._lock:
            inner = self._attempt_futures.get(job_id)
            return inner if inner is not None else self._jobs[job_id]

    def _fail_job(self, config: JobConfig, error: str) -> None:
        self._future_of(config.job_id).set_exception(RuntimeError(error))
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
                "reinstated": list(self.reinstated),
                "refused_joins": list(self.refused_joins),
                "auto_resumed": list(self.auto_resumed),
                # the followers' heartbeat-advertised /metrics ports: the
                # scraper's targets, for an operator to scrape by hand too
                "metrics_ports": {str(p): port for p, port
                                  in sorted(self._hb_metrics_ports.items())},
                # the newest attempts' reports by process, and their walls
                "reports": {j: {str(p): r for p, r in reps.items()}
                            for j, reps in list(self.pod_reports.items())[-16:]},
                "walls": {j: list(w) for j, w in list(self.job_walls.items())[-16:]},
            }
            out["elastic"] = {
                "active": {j: {"attempt": st["attempt"], "procs": sorted(st["procs"])}
                           for j, st in self._elastic_active.items()},
                "events": [dict(ev) for ev in self.elastic_events[-32:]],
            }
        return out

    def _scrape_targets(self) -> Dict[str, Any]:
        """The server's own targets plus every live follower whose heartbeat
        advertised an exporter port (``pod:<pid>``). Dead and silenced
        followers are skipped: their gap is already the signal, and scraping
        one would only hold the cycle to its timeout."""
        targets = super()._scrape_targets()
        with self._pod_cond:
            ports = dict(self._hb_metrics_ports)
            hosts = dict(self._follower_hosts)
            skip = set(self._dead_followers) | set(self._silenced)
        for pid, port in sorted(ports.items()):
            if pid in skip:
                continue
            host = hosts.get(pid) or "127.0.0.1"
            targets[f"pod:{pid}"] = f"http://{host}:{port}/metrics"
        return targets

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
        if self._elastic_eligible(config):
            # one span for the whole submission: each attempt's pod.dispatch
            # span nests under it
            with trace_span("elastic.submission", job_id=config.job_id):
                self._dispatch_elastic(config, executor_ids)
            return
        self._dispatch_once(config, executor_ids)
        self._maybe_auto_resume(config)

    def _elastic_eligible(self, config: JobConfig) -> bool:
        """``user.elastic_shrink`` jobs that can recover in place: a Dolphin
        job with a chain (the recovery point) under the server's chkp_root
        and a PRIVATE model table (a shared table's state is every tenant's,
        and rebuilding it under one would corrupt the others)."""
        if not config.user.get("elastic_shrink"):
            return False
        ok = (config.app_type == "dolphin" and not config.tables
              and config.params.model_chkp_period > 0 and self._chkp_root is not None)
        if not ok:
            job_logger(config.job_id).warning(
                "elastic_shrink ignored: it needs app_type=dolphin, a private model "
                "table, model_chkp_period > 0 and a server chkp_root")
        return ok

    def _proc_of(self, executor_id: str) -> int:
        return self.master.executor(executor_id).slot.process_index

    def _dispatch_elastic(self, config: JobConfig, executor_ids: List[str]) -> None:
        """The elastic dispatch loop: ONE submission, many attempts (module
        doc). Each attempt's outcome is classified: a fence (shrink or
        re-grow) or an infra-shaped failure (a participant's death or
        silence, an ``infra_suspect`` report) continues the submission on the
        next attempt's grant; anything else is the job's own failure and
        ends it. The submission's end releases this process's recovery
        cache of the job's tables."""
        outer = self._jobs[config.job_id]
        cfg, execs = config, list(executor_ids)
        original_procs = frozenset(self._proc_of(e) for e in executor_ids)
        recoveries = 0
        events: List[Dict[str, Any]] = []
        last_exc: Optional[BaseException] = None
        try:
            while True:
                att = elastic.attempt_of(cfg)
                inner: Future = Future()
                with self._lock:
                    self._attempt_futures[config.job_id] = inner
                with self._pod_cond:
                    self._elastic_active[config.job_id] = {
                        "attempt": att, "procs": frozenset(self._proc_of(e) for e in execs),
                        "original_procs": original_procs, "config": cfg,
                        "executors": list(execs), "resume_epoch": int(
                            (cfg.user.get("elastic_recovery") or {}).get("resume_epoch", 0))}
                try:
                    self._dispatch_once(cfg, execs)
                finally:
                    with self._pod_cond:
                        self._elastic_active.pop(config.job_id, None)
                if not inner.done():
                    inner.set_exception(RuntimeError("the attempt ended without a result"))
                exc = inner.exception()
                if exc is None:
                    result = dict(inner.result())
                    if att or events:
                        result["elastic"] = {"attempts": att + 1, "recoveries": recoveries,
                                             "events": list(events)}
                    outer.set_result(result)
                    return
                last_exc = exc
                fence = getattr(exc, "elastic_fence", None)
                with self._pod_cond:
                    infra = config.job_id in self._infra_failed
                    self._infra_failed.discard(config.job_id)
                infra = infra or bool(getattr(exc, "infra_suspect", False))
                if fence is None and not infra:
                    self._elastic_give_up(config.job_id, reason="job failed on its own terms",
                                          error=f"{type(exc).__name__}: {exc}"[:300])
                    return
                if recoveries >= elastic.max_shrinks():
                    self._elastic_give_up(
                        config.job_id, reason=f"recovery cap {elastic.max_shrinks()} reached "
                                              "(HARMONY_ELASTIC_MAX_SHRINKS)")
                    return
                kind = "regrow" if fence == "regrow" else "shrink"
                try:
                    with trace_span("elastic.plan_recovery", job_id=config.job_id, kind=kind,
                                    attempt=elastic.attempt_key(config.job_id, att + 1)):
                        plan = self._plan_elastic_recovery(config, execs, att, kind,
                                                           list(executor_ids), events)
                except BaseException as e:  # noqa: BLE001 - the submission fails cleanly
                    self._elastic_give_up(
                        config.job_id,
                        reason=f"recovery planning failed: {type(e).__name__}: {e}"[:300])
                    return
                if plan is None:
                    return
                cfg, execs = plan
                recoveries += 1
        finally:
            with self._lock:
                self._attempt_futures.pop(config.job_id, None)
            if not outer.done():
                outer.set_exception(last_exc if last_exc is not None else RuntimeError(
                    "elastic dispatch ended without a result"))
            from harmony_tpu_torch.checkpoint import manager as chkp_manager

            chkp_manager.drop_recovery_cache(prefix=f"{config.job_id}:")

    def _plan_elastic_recovery(self, config: JobConfig, prev_execs: List[str],
                               prev_attempt: int, kind: str, original_execs: List[str],
                               events: List[Dict[str, Any]]
                               ) -> "Optional[Tuple[JobConfig, List[str]]]":
        """The next attempt: rehabilitate the processes confined only because
        they shared the attempt with the lost one but reported and still
        beat (the leader by its report alone), reacquire executors (the
        survivors for a shrink, the original layout for a re-grow), check
        that a committed chain exists, and make the recovery config. None when no recovery is possible (an event
        says why; the submission then fails with the attempt's error)."""
        from harmony_tpu_torch import faults
        from harmony_tpu_torch.checkpoint.manager import CheckpointManager

        t0 = time.perf_counter()
        if faults.armed():
            faults.site("pod.shrink_plan" if kind == "shrink" else "pod.regrow",
                        job=config.job_id, attempt=prev_attempt)
        with self._pod_cond:
            reports = dict(self.pod_reports.get(
                elastic.attempt_key(config.job_id, prev_attempt), {}))
            now = time.monotonic()
            # the leader has no beacon: its own report, made here, is its
            # proof of life (a data-axis job over both processes of a pod
            # loses a follower and recovers on the leader's slots)
            rehab = [pid for pid, rep in reports.items()
                     if pid in self._unusable_procs and pid not in self._dead_followers
                     and pid not in self._silenced and not rep.get("infra")
                     and (pid == 0 or now - self._last_seen.get(pid, 0.0) <= self.hb_timeout)]
            self._unusable_procs.difference_update(rehab)
        for pid in rehab:
            restored = self._proc_executors(pid)
            if restored:
                self._scheduler.restore(restored)
            self._record_pod_event("follower_rehabilitated", job_id=config.job_id, pid=pid,
                                   reason="reported for the failed attempt")
        with self._pod_cond:
            unusable = set(self._unusable_procs)
        base = original_execs if kind == "regrow" else prev_execs
        preferred = [e for e in base if self._proc_of(e) not in unusable]
        granted = [e for e in self._scheduler.reacquire(config.job_id, preferred)
                   if self._proc_of(e) not in unusable]
        mgr = CheckpointManager.for_job(self._chkp_root, config.job_id)
        chain = [c for c in mgr.list_checkpoints() if c.startswith(f"{config.job_id}:")]
        why = ("no usable executors to recover on" if not granted
               else None if chain else "no committed chain checkpoints yet")
        if why is not None:
            self._scheduler.on_job_finish(config.job_id)  # return the grant
            self._elastic_give_up(config.job_id, reason=why)
            return None
        lost = [e for e in prev_execs if e not in granted]
        new_cfg = ConfigBase.from_dict(config.to_dict())
        new_cfg.user["elastic_recovery"] = {"attempt": prev_attempt + 1, "kind": kind,
                                            "lost_executors": lost,
                                            "resume_epoch": _resume_epoch(mgr, chain)}
        ev = job_logger(config.job_id).event(
            f"elastic_{kind}", attempt=prev_attempt + 1, executors=list(granted),
            lost_executors=lost, procs=sorted({self._proc_of(e) for e in granted}),
            planning_s=round(time.perf_counter() - t0, 6))
        events.append(dict(ev))
        self._keep_event(ev, config.job_id)
        return new_cfg, granted

    def _dispatch_once(self, config: JobConfig, executor_ids: List[str]) -> None:
        with trace_span("pod.dispatch", job_id=config.job_id,
                        attempt=elastic.config_attempt_key(config)):
            self._dispatch_once_inner(config, executor_ids)

    def _dispatch_once_inner(self, config: JobConfig, executor_ids: List[str]) -> None:
        if not executor_ids:
            # every executor retired (the lost followers' processes, and those
            # that shared a running job with them)
            self._fail_job(config, f"pod is broken ({self._pod_broken}); no usable "
                                   "executors are left for the job")
            return
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
        # the attempt key: the job id, or job@aN for an elastic recovery
        att = elastic.attempt_of(config)
        rkey = elastic.attempt_key(config.job_id, att)
        if pod_ordered:
            # known to the arbiter before any participant's first TU_WAIT; a
            # recovery attempt inherits its predecessor's fair-share deficit
            self.pod_units.register_job(
                rkey, procs,
                inherit_from=elastic.attempt_key(config.job_id, att - 1) if att else None)
        try:
            participants = sorted(p for p in procs if p != 0)
            run_local = 0 in procs
            with self._pod_cond:
                self._job_info[config.job_id] = participants
            if participants:
                log.info("pod: RUN_JOB %s to follower(s) %s (chief %d, local %s)",
                         config.job_id, participants, min(procs), run_local)
                msg = {"cmd": "RUN_JOB", "conf": config.to_dict(),
                       "executor_ids": list(executor_ids), "chief_pid": min(procs),
                       "trace": wire_context(), "pod_ordered": pod_ordered, "att": att,
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
                fut = self._future_of(config.job_id)
                local_report = {"ok": fut.exception() is None,
                                **_counter_delta(before, _job_counters()),
                                **self._unit_counts.pop(rkey, {})}
                exc = fut.exception()
                if exc is None:
                    local_report.update(_job_summary(fut.result()))
                else:
                    local_report["error"] = f"{type(exc).__name__}: {exc}"
                    if getattr(exc, "attempt_result", None):
                        # a fenced attempt: what it trained and restored
                        local_report.update(_job_summary(exc.attempt_result),
                                            elastic_fence=exc.elastic_fence)
            else:
                # the leader holds none of the job's slots: the chief
                # participant's report is the job's result
                self._resolve_remote(config, participants, rkey)
            reports = self._collect_reports(rkey, participants) if participants else {}
            if any(not r.get("ok") and r.get("infra_suspect") for r in reports.values()):
                # a participant gave up on an infra fault (it is alive): the
                # auto-resume evidence a death would be, nothing retired
                with self._pod_cond:
                    self._record_infra_failed_locked(config.job_id)
            dead = [pid for pid, r in reports.items() if r.get("infra")]
            if dead:
                # for an ELASTIC job a silenced pid is not presumed dead: the
                # monitor confined it, its socket is up, and wedging its
                # co-participants would retire the survivors the shrink
                # recovers on
                is_elastic = bool(config.user.get("elastic_shrink"))
                with self._pod_cond:
                    self._record_infra_failed_locked(config.job_id)
                    hard_dead = [p for p in dead if not is_elastic or p not in self._silenced]
                for pid in hard_dead:
                    self._on_follower_death(pid)
                if hard_dead:
                    self._mark_broken(f"follower(s) {hard_dead} never reported for "
                                      f"{config.job_id}", scope="partial")
            if local_report is not None:
                reports = {0: local_report, **reports}
            with self._pod_cond:
                self.pod_reports[rkey] = reports
                while len(self.pod_reports) > 256:
                    self.pod_reports.pop(next(iter(self.pod_reports)))
                for pid, rep in reports.items():
                    if pid != 0 and rep.get("has_deferred_eval"):
                        self._remote_evals[config.job_id] = pid
        finally:
            podplan.clear(config.job_id)
            if pod_ordered:
                # every participant's TU_DONEs precede its JOB_DONE on one
                # socket: nothing of this job is in flight at the arbiter
                self.pod_units.deregister_job(rkey)
            with self._pod_cond:
                # a plan for a finished job is refused, never kept
                self._job_info.pop(config.job_id, None)
                self.job_walls[rkey] = (t0, time.monotonic())
                while len(self.job_walls) > 1024:
                    self.job_walls.pop(next(iter(self.job_walls)))
                self._active_procs.pop(config.job_id, None)
                self._pod_cond.notify_all()

    def _maybe_auto_resume(self, config: JobConfig) -> None:
        """A ``user.auto_resume`` job with a chain that just failed on infra
        evidence (a participant died or went silent while it ran, or
        reported an ``infra_suspect`` give-up) is resubmitted with
        ``resume_from_chain``: the scheduler, whose lost executors retired,
        grants survivors, and the entity restores the newest chain entry.
        Never a job failing on its own terms, nor one already resumed."""
        with self._lock:
            fut = self._jobs.get(config.job_id)
        if fut is None or not fut.done() or fut.exception() is None:
            return
        if not (config.user.get("auto_resume") and config.params.model_chkp_period > 0
                and self._chkp_root and not config.user.get("resume_from_chain")):
            return
        with self._pod_cond:
            infra = config.job_id in self._infra_failed
            self._infra_failed.discard(config.job_id)
        infra = infra or bool(getattr(fut.exception(), "infra_suspect", False))
        if not infra:
            return
        from harmony_tpu_torch.checkpoint.manager import CheckpointManager

        mgr = CheckpointManager.for_job(self._chkp_root, config.job_id)
        if not any(c.startswith(f"{config.job_id}:") for c in mgr.list_checkpoints()):
            log.warning("auto-resume of %s skipped: no chain checkpoints yet", config.job_id)
            return
        new_cfg = ConfigBase.from_dict(config.to_dict())
        new_cfg.user["resume_from_chain"] = True
        with self._pod_cond:
            self.auto_resumed.append(config.job_id)
        self._record_pod_event("auto_resume", job_id=config.job_id,
                               error=f"{type(fut.exception()).__name__}: "
                                     f"{fut.exception()}"[:300])
        try:
            self.submit(new_cfg)
        except Exception as e:  # noqa: BLE001 - the original failure stands
            log.error("auto-resume submit for %s failed: %s", config.job_id, e)

    def _resolve_remote(self, config: JobConfig, participants: List[int],
                        rkey: Optional[str] = None) -> None:
        """A job wholly on followers: the lowest participant is its chief,
        and its JOB_DONE (under the attempt key ``rkey``) resolves the
        leader's future. A lost chief is infra evidence; a report's
        ``elastic_fence`` and ``infra_suspect`` markers ride the error."""
        future = self._future_of(config.job_id)
        chief = min(participants)
        try:
            rep = self._wait_report_live(rkey or config.job_id, chief)
            if rep is None:
                with self._pod_cond:
                    self._record_infra_failed_locked(config.job_id)
                raise RuntimeError(f"chief follower {chief} never reported for "
                                   f"{config.job_id} (connection lost or heartbeat silence)")
            if not rep.get("ok"):
                err = RuntimeError(f"remote job failed on follower {chief}: "
                                   f"{rep.get('error', 'unknown error')}")
                if rep.get("infra_suspect"):
                    with self._pod_cond:
                        self._record_infra_failed_locked(config.job_id)
                    err.infra_suspect = True
                if rep.get("elastic_fence"):
                    err.elastic_fence = str(rep["elastic_fence"])
                raise err
            future.set_result(rep.get("result") or {"job_id": config.job_id,
                                                    "workers": rep.get("workers", {})})
        except BaseException as e:  # noqa: BLE001 - delivered through the future
            future.set_exception(e)
        finally:
            self._scheduler.on_job_finish(config.job_id)

    def _entity_extras(self, config: JobConfig, executor_ids: List[str]) -> Dict[str, Any]:
        """For a job over several processes: the plan channel
        (``pod_plan_sink``, which the optimizer loop hands its plans to) and,
        unless ``user.pod_isolated``, the leader's leg of the unit
        protocol."""
        procs = {self.master.executor(e).slot.process_index for e in executor_ids}
        if len(procs) < 2:
            return {}
        extras: Dict[str, Any] = {"pod_plan_sink": self.schedule_pod_reshard,
                                  "pod_eval_channel": self._pod_eval_channel}
        if (config.app_type in ("dolphin", "pregel")
                and not bool(config.user.get("pod_isolated"))):
            rkey = elastic.config_attempt_key(config)
            client = leader_client(self.pod_units, rkey)
            counts = self._unit_counts[rkey] = {"units": 0}
            extras.update(pod_unit_scope=_counted(client.scope, counts),
                          pod_unit_contended=client.contended)
        if config.params.offline_model_eval and config.params.model_chkp_period > 0:
            # registered only for the jobs that will run the collective
            # evaluation: others must not evict a live entry
            with self._pod_cond:
                self._eval_participants[config.job_id] = sorted(p for p in procs if p != 0)
                while len(self._eval_participants) > 1024:
                    self._eval_participants.pop(next(iter(self._eval_participants)))
        return extras

    def _broadcast_eval_decision(self, participants: List[int], job_id: str,
                                 go: bool) -> None:
        """EVAL_GO or EVAL_ABORT to every participant. A GO that reaches
        some followers only marks the pod broken and raises: they enter
        collectives the others never join, and the leader must not enter its
        own."""
        cmd = "EVAL_GO" if go else "EVAL_ABORT"
        for pid in participants:
            try:
                self._send_to(pid, {"cmd": cmd, "job_id": job_id})
            except OSError as e:
                if not go:
                    continue  # an unreachable follower is out of the protocol
                self._mark_broken(f"EVAL_GO send failed: {e}")
                raise RuntimeError(f"EVAL_GO broadcast failed: {e}") from None

    def _pod_eval_channel(self, phase: str, job_id: str,
                          payload: Optional[Dict[str, Any]] = None,
                          timeout: float = 180.0) -> None:
        """The collective deferred evaluation's channel (module doc).
        ``"start"``: EVAL_COLLECTIVE, the followers' READY acks within
        ``timeout``, then GO when all are ready, else ABORT and raise, before
        anyone enters a collective. ``"finish"``: the EVAL_COLLECTIVE_DONE
        acks within ``timeout``; a follower silent or failed there marks the
        pod broken, never waited on forever."""
        with self._pod_cond:
            participants = self._eval_participants.get(job_id, [])
        if not participants:
            return
        if phase == "start":
            try:
                for pid in participants:
                    self._send_to(pid, {"cmd": "EVAL_COLLECTIVE", "job_id": job_id,
                                        **(payload or {})})
            except OSError as e:
                # the recipients wait for a decision on their socket, not in a
                # collective: abort them
                self._broadcast_eval_decision(participants, job_id, go=False)
                raise RuntimeError(f"EVAL_COLLECTIVE broadcast failed: {e}") from None
            deadline = time.monotonic() + timeout
            failures = []
            for pid in participants:
                rep = self._wait_report(f"__evalr__{job_id}", pid, deadline)
                if rep is None or not rep.get("ok"):
                    failures.append((pid, "no readiness ack" if rep is None
                                     else rep.get("error")))
            with self._pod_cond:
                for pid in participants:
                    self._reports.pop((f"__evalr__{job_id}", pid), None)
            if failures:
                self._broadcast_eval_decision(participants, job_id, go=False)
                with self._pod_cond:
                    self._eval_participants.pop(job_id, None)
                raise RuntimeError(
                    f"collective eval aborted (followers not ready): {failures}")
            self._broadcast_eval_decision(participants, job_id, go=True)
            return
        deadline = time.monotonic() + timeout
        for pid in participants:
            rep = self._wait_report(f"__evalc__{job_id}", pid, deadline)
            if rep is None or not rep.get("ok"):
                # silent: wedged in a collective; failed: it left before the
                # collectives the others entered. Either way they cannot all
                # complete
                why = "never acked" if rep is None else f"failed: {rep.get('error')}"
                self._mark_broken(f"collective eval for {job_id}: follower {pid} {why}")
        with self._pod_cond:
            for pid in participants:
                self._reports.pop((f"__evalc__{job_id}", pid), None)
            self._eval_participants.pop(job_id, None)

    def _query_remote_epoch(self, job_id: str, chief: int, timeout: float = 30.0) -> int:
        """The epoch the chief follower has observed of a job the leader
        does not run (PROGRESS_REQ/PROGRESS_REP, matched by a request id).
        A silent chief fails the query: a guessed 0 is the divergence the
        horizon check exists to prevent."""
        with self._pod_cond:
            self._progress_seq += 1
            req = self._progress_seq
            key = f"__prog__{job_id}#{req}"
            self._progress_waiting.add((key, chief))
        try:
            try:
                self._send_to(chief, {"cmd": "PROGRESS_REQ", "job_id": job_id, "req": req})
            except OSError as e:
                raise RuntimeError(f"progress query to follower {chief} failed: {e}") from None
            rep = self._wait_report(key, chief, time.monotonic() + timeout)
        finally:
            with self._pod_cond:
                self._progress_waiting.discard((key, chief))
                self._reports.pop((key, chief), None)
        if rep is None:
            raise RuntimeError(f"follower {chief} did not answer the progress query for "
                               f"{job_id}; the plan is refused (no observed epoch)")
        return int(rep.get("epoch", 0))

    def schedule_pod_reshard(self, job_id: str, src: str, dst: str, num_blocks: int,
                             epoch: int) -> None:
        """A move of ``num_blocks`` blocks from executor ``src`` to ``dst`` on
        a RUNNING pod job, applied by every process at its chief's hook of
        epoch ``epoch`` (``jobserver/podplan.py``). The epoch must lead the
        job's observed epoch (the leader's own entity, else the chief
        follower's) by the window horizon, ``EPOCH_WINDOW`` + 1: the window
        that covers the plan's epoch is decided after every process holds
        the plan. An unknown or finished job raises KeyError; a PLAN that
        reached some followers only marks the pod broken."""
        from harmony_tpu_torch.dolphin.worker import WorkerTasklet

        with self._pod_cond:
            participants = self._job_info.get(job_id)
        if participants is None:
            raise KeyError(f"unknown (or finished) pod job {job_id}")
        with self._lock:
            ent = self._entities.get(job_id)
        cur = 0
        if ent is not None and getattr(ent, "progress", None) is not None:
            cur = ent.progress.starting_epoch()
        elif participants:
            cur = self._query_remote_epoch(job_id, min(participants))
        horizon = WorkerTasklet.EPOCH_WINDOW + 1
        if epoch < cur + horizon:
            raise ValueError(
                f"plan epoch {epoch} is inside the window horizon (job at ~epoch {cur}; "
                f"need >= {cur + horizon}): a plan landing mid-window would apply at "
                "divergent points across processes")
        plan = {"epoch": int(epoch), "src": src, "dst": dst, "num_blocks": int(num_blocks)}
        try:
            for pid in participants:
                self._send_to(pid, {"cmd": "PLAN", "job_id": job_id, "plan": plan})
        except OSError as e:
            # a plan that some processes apply and others never see wedges
            # the job's next collective: poison, as a partial RUN_JOB does
            self._mark_broken(f"PLAN broadcast failed: {e}")
            raise
        podplan.schedule(job_id, plan)

    def _pod_reshard_command(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        self.schedule_pod_reshard(job_id=str(msg["job_id"]), src=str(msg["src"]),
                                  dst=str(msg["dst"]), num_blocks=int(msg["num_blocks"]),
                                  epoch=int(msg["epoch"]))
        return {"ok": True}

    def _on_closing(self, timeout: Optional[float] = 300.0) -> None:
        """The pod's teardown, once the jobs have drained: wait out the
        report collections still running, then SHUTDOWN every follower and
        close the control plane."""
        self._monitor_stop.set()
        with self._pod_cond:
            self._pod_cond.wait_for(lambda: not self._active_procs, timeout=30.0)
            # the late-join loop sees this within its accept timeout
            self._pod_closing = True
        for pid in sorted(self._followers):
            try:
                self._send_to(pid, {"cmd": "SHUTDOWN"})
            except OSError:
                pass
        # the chief followers run their jobs' deferred evaluations on SHUTDOWN:
        # collect their EVAL_DONEs before the sockets close
        with self._pod_cond:
            pending = dict(self._remote_evals)
            if pending:
                self._pod_cond.wait_for(
                    lambda: all(j in self._remote_eval_results or pid in self._dead_followers
                                for j, pid in pending.items()),
                    timeout=timeout or 300.0)
            for j, pid in pending.items():
                self.eval_results[j] = self._remote_eval_results.get(
                    j, {"error": f"follower {pid} never sent EVAL_DONE"})
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
                 pool=None, join_timeout: float = 300.0, reconnect: Optional[bool] = None,
                 leader_addrs: Optional[List[Tuple[str, int]]] = None) -> None:
        from harmony_tpu_torch.jobserver import ha
        from harmony_tpu_torch.metrics.manager import MetricManager
        from harmony_tpu_torch.runtime.master import ETMaster

        self.pid = pid
        self._join_timeout = join_timeout
        # control-plane HA: with it a lost leader connection is a LEADER
        # CHANGE, not the pod's end: the follower JOINs the (maybe new)
        # leader again, its executors, entities and job threads kept
        self._reconnect = ha.ha_enabled() if reconnect is None else bool(reconnect)
        self._leader_addrs = list(leader_addrs or [(leader_host, pod_port)])
        #: the highest leader epoch seen; a message below it is a deposed
        #: leader's late write, and is rejected
        self._leader_epoch = 0
        self.stale_rejected = 0
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
        self._jobs_started = 0
        #: attempt key -> live entity (listed by the heartbeats)
        self._entities: Dict[str, Any] = {}
        #: job id -> the deferred evaluation of a job this process chiefed,
        #: run at SHUTDOWN
        self._deferred_evals: Dict[str, Any] = {}
        #: job id -> (config, executor ids, chkp_root) of a job with a chain
        #: and offline_model_eval, for its collective evaluation at shutdown
        self._job_confs: Dict[str, Tuple[Any, List[str], Optional[str]]] = {}
        # this process's identity for the leader: a later JOIN under this pid
        # is reinstated only with the same token (PodJobServer._reinstate_follower)
        self.incarnation = f"{socket.gethostname()}:{os.getpid()}:{time.time_ns()}"
        _send(self._sock, {"cmd": "JOIN", "pid": pid, "incarnation": self.incarnation})
        self.master = ETMaster(pool)
        self.master.add_executors(num_executors)
        self.metrics = MetricManager()
        self.metrics.start_collection()
        # this process's /metrics endpoint (HARMONY_METRICS_PORT; None when
        # unset), advertised on every beat for the leader's scraper
        self.metrics_exporter = exporter_from_env()
        # the liveness beacon: the leader's report waits are gated on it,
        # never on a job's duration
        self._hb_period = float(os.environ.get("HARMONY_POD_HB_PERIOD", "5"))
        self._hb_stop = threading.Event()
        threading.Thread(target=self._heartbeat_loop, daemon=True,
                         name=f"pod-hb-{pid}").start()

    def _heartbeat_loop(self) -> None:
        """The beacon. The ``pod.heartbeat`` fault site drops a beat on a
        ``skip`` rule (the process alive but mute); the thread survives every
        injected action, as its silence confines this process."""
        from harmony_tpu_torch import faults

        while not self._hb_stop.wait(self._hb_period):
            try:
                jobs = sorted(self._entities)
            except RuntimeError:
                continue  # a job thread resized the dict: the next beat catches up
            if faults.armed():
                try:
                    # ``jobs_started``: the RUN_JOBs this process has taken,
                    # so a rule can count beats from a job's start
                    if faults.site("pod.heartbeat", pid=self.pid,
                                   jobs_started=self._jobs_started) == "skip":
                        continue
                except Exception:  # noqa: BLE001 - one beat lost, the beacon lives
                    continue
            try:
                self._report({"cmd": "HEARTBEAT", "pid": self.pid, "jobs": jobs,
                              "metrics_port": (self.metrics_exporter.port
                                               if self.metrics_exporter is not None
                                               else None)})
            except OSError:
                if self._reconnect:
                    continue  # a leader change: run()'s re-JOIN swaps the socket
                return  # the leader is gone; run() handles it

    def _report(self, payload: Dict[str, Any]) -> None:
        with self._send_lock:
            _send(self._sock, payload)

    def _reject_stale(self, msg: Dict[str, Any], epoch: int) -> None:
        """A deposed leader's late message (its epoch below the highest this
        follower has seen). A RUN_JOB gets an explicit failed report keyed by
        ITS attempt, so the stale leader's wait ends; anything else is
        dropped."""
        self.stale_rejected += 1
        log.warning("follower %d: rejected stale-epoch %d %r (current leader epoch %d)",
                    self.pid, epoch, msg.get("cmd"), self._leader_epoch)
        if msg.get("cmd") == "RUN_JOB":
            rkey = elastic.attempt_key(str(msg.get("conf", {}).get("job_id", "?")),
                                       int(msg.get("att", 0) or 0))
            try:
                self._report({"cmd": "JOB_DONE", "pid": self.pid, "job_id": rkey,
                              "ok": False, "stale_epoch": True,
                              "error": f"fenced: RUN_JOB from deposed leader epoch {epoch} "
                                       f"< {self._leader_epoch}"})
            except OSError:
                pass

    def _rejoin(self) -> bool:
        """The re-JOIN after a leader change: connect to the (maybe new)
        leader's control port and JOIN again under the SAME pid and the same
        incarnation token, so the leader's late-join path reinstates this
        process; executors, entities and running job threads all survive.
        False when no leader answers within the join timeout (the pod is
        gone, not just its leader)."""
        from harmony_tpu_torch.faults.partition import fault_connect

        deadline = time.monotonic() + self._join_timeout
        delay = 0.2
        while time.monotonic() < deadline:
            for host, port in self._leader_addrs:
                try:
                    sock = fault_connect((host, port), role="pod.rejoin", timeout=5.0)
                except OSError:
                    continue
                sock.settimeout(None)
                f = sock.makefile("r")
                with self._send_lock:
                    old = self._sock
                    try:
                        _send(sock, {"cmd": "JOIN", "pid": self.pid,
                                     "incarnation": self.incarnation})
                    except OSError:
                        try:
                            sock.close()
                        except OSError:
                            pass
                        continue
                    self._sock = sock
                    self._file = f
                try:
                    old.close()
                except OSError:
                    pass
                log.info("follower %d re-joined the leader at %s:%d after losing its "
                         "connection (running jobs kept)", self.pid, host, port)
                return True
            time.sleep(delay)
            delay = min(delay * 2, 2.0)
        log.error("follower %d: no leader answered within %.0f s; shutting down",
                  self.pid, self._join_timeout)
        return False

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
            if msg is None and self._reconnect and self._rejoin():
                continue  # a leader change: JOINed the (new) leader
            if msg is not None and msg.get("leader_epoch") is not None:
                ep = int(msg["leader_epoch"])
                if ep < self._leader_epoch:
                    # fenced before any dispatch, SHUTDOWN included: a deposed
                    # leader's exit must not end a follower its successor has
                    self._reject_stale(msg, ep)
                    continue
                self._leader_epoch = ep
            if msg is None or msg.get("cmd") == "SHUTDOWN":
                for t in self._job_threads:
                    t.join(timeout=60.0)
                # the deferred evaluations of the jobs this process chiefed:
                # the leader waits for their EVAL_DONEs
                for job_id, fn in list(self._deferred_evals.items()):
                    try:
                        result = _json_sanitize(fn(self.master))
                    except BaseException as e:  # noqa: BLE001 - reported
                        result = {"error": f"{type(e).__name__}: {e}"}
                    try:
                        self._report({"cmd": "EVAL_DONE", "job_id": job_id, "result": result})
                    except OSError:
                        break  # the leader is gone
                self._hb_stop.set()
                if self.metrics_exporter is not None:
                    self.metrics_exporter.stop()
                    self.metrics_exporter = None
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
            if cmd == "PLAN":
                podplan.schedule(str(msg["job_id"]), msg["plan"])
                continue
            if cmd == "JOIN_REFUSED":
                raise RuntimeError(str(msg.get("error", "JOIN refused by the pod leader")))
            if cmd == "PROGRESS_REQ":
                # the leader's horizon check for a job it does not run, keyed
                # by the job id or an attempt key (entities register under
                # attempt keys: the newest attempt of the job answers)
                jid = str(msg.get("job_id"))
                ent = self._entities.get(jid)
                if ent is None:
                    base = jid.split("@a", 1)[0]
                    for k in sorted(self._entities, reverse=True):
                        if k == base or k.startswith(base + "@a"):
                            ent = self._entities[k]
                            break
                ep = 0
                if ent is not None and getattr(ent, "progress", None) is not None:
                    ep = ent.progress.starting_epoch()
                self._report({"cmd": "PROGRESS_REP", "job_id": jid, "epoch": int(ep),
                              "req": msg.get("req")})
                continue
            if cmd == "EVAL_COLLECTIVE":
                # shutdown stage, no job running: the leader's evaluation is
                # a collective this process joins inline
                self._run_collective_eval(msg)
                continue
            if cmd != "RUN_JOB":
                log.warning("pod follower %d: unexpected %r", self.pid, cmd)
                continue
            self._jobs_started += 1
            t = threading.Thread(target=self._run_job, args=(msg, global_tu), daemon=True,
                                 name=f"pod-job-{msg.get('conf', {}).get('job_id', '?')}")
            self._job_threads = [x for x in self._job_threads if x.is_alive()]
            self._job_threads.append(t)
            t.start()

    def _run_collective_eval(self, msg: Dict[str, Any]) -> None:
        """This process's leg of a collective deferred evaluation: build the
        same checkpoint manager, trainer and test data the leader's closure
        resolves (all from the job's config), answer READY, and on EVAL_GO
        replay the chain with the leader, the restores and evaluations
        joining its collectives; the results are the leader's to keep.
        Everything that can fail runs on the host BEFORE the ack, where an
        abort is clean."""
        job_id = str(msg.get("job_id"))
        ready: Dict[str, Any] = {"cmd": "EVAL_COLLECTIVE_READY", "pid": self.pid,
                                 "job_id": job_id, "ok": False}
        staged = None
        try:
            from harmony_tpu_torch.checkpoint.manager import CheckpointManager
            from harmony_tpu_torch.dolphin.evaluator import resolve_eval_inputs

            config, executor_ids, chkp_root = self._job_confs[job_id]
            mgr = CheckpointManager.for_job(chkp_root, job_id)
            trainer, batch = resolve_eval_inputs(config)
            staged = (mgr, trainer, batch, executor_ids)
            ready["ok"] = True
        except BaseException as e:  # noqa: BLE001 - acked to the leader
            ready["error"] = f"{type(e).__name__}: {e}"
        self._report(ready)
        try:
            decision = _recv(self._file)
        except (OSError, ValueError):
            decision = None
        if not decision or decision.get("cmd") != "EVAL_GO":
            return  # aborted, or the leader hung up: nothing was dispatched
        report: Dict[str, Any] = {"cmd": "EVAL_COLLECTIVE_DONE", "pid": self.pid,
                                  "job_id": job_id, "ok": False}
        try:
            from harmony_tpu_torch.dolphin.evaluator import ModelEvaluator

            mgr, trainer, batch, executor_ids = staged
            ModelEvaluator(self.master, mgr).evaluate_checkpoints(
                list(msg.get("chkp_ids", [])), trainer, batch, executor_ids)
            report["ok"] = True
        except BaseException as e:  # noqa: BLE001 - acked to the leader
            report["error"] = f"{type(e).__name__}: {e}"
        self._report(report)

    def _run_job(self, msg: Dict[str, Any], global_tu) -> None:
        """One span a follower's leg, under the leader's dispatch span (the
        RUN_JOB's trace context)."""
        job_id = msg.get("conf", {}).get("job_id")
        with trace_span("pod.follower_job", parent=SpanContext.from_wire(msg.get("trace")),
                        job_id=job_id, pid=self.pid,
                        attempt=elastic.attempt_key(str(job_id), int(msg.get("att", 0) or 0))):
            self._run_job_inner(msg, global_tu)

    def _run_job_inner(self, msg: Dict[str, Any], global_tu) -> None:
        from harmony_tpu_torch.jobserver.entity import build_entity
        from harmony_tpu_torch.runtime.taskunit import LocalTaskUnitScheduler

        config = ConfigBase.from_dict(msg["conf"])
        executor_ids = msg["executor_ids"]
        if config.params.offline_model_eval and config.params.model_chkp_period > 0:
            # kept for the collective evaluation at shutdown, only for the jobs
            # that will run one
            self._job_confs[config.job_id] = (config, list(executor_ids), msg.get("chkp_root"))
            while len(self._job_confs) > 1024:
                self._job_confs.pop(next(iter(self._job_confs)))
        chief = int(msg.get("chief_pid", 0)) == self.pid
        # the attempt key: reports, the entity registry and the unit protocol
        # are per attempt, so a superseded attempt's stragglers never reach
        # the live one
        rkey = elastic.attempt_key(config.job_id, int(msg.get("att", 0) or 0))
        report: Dict[str, Any] = {"cmd": "JOB_DONE", "pid": self.pid, "job_id": rkey}
        unit_extras: Dict[str, Any] = {}
        counts = {"units": 0}
        if msg.get("pod_ordered"):
            client = follower_client(self._pod_units, rkey)
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
            self._entities[rkey] = entity
            entity.setup(self.master, executor_ids)
            result = entity.run()
            if chief:
                # registered before cleanup drops the tables (the evaluation
                # replays the chain from disk) and run at SHUTDOWN: one a job
                deferred = entity.deferred_evaluation()
                if deferred is not None:
                    self._deferred_evals[config.job_id] = deferred
                    report["has_deferred_eval"] = True
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
            if getattr(e, "elastic_fence", None):
                # a planned fence, not a failure: the leader's elastic loop
                # classifies on this marker and continues the submission
                report["elastic_fence"] = str(e.elastic_fence)
                if getattr(e, "attempt_result", None):
                    report.update(_job_summary(e.attempt_result))
            if getattr(e, "infra_suspect", False):
                # a bounded-retry give-up: infra-shaped, so an auto_resume job
                # may resubmit as after a death
                report["infra_suspect"] = True
        report.update(_counter_delta(before, _job_counters()), **counts)
        self._entities.pop(rkey, None)
        self._pod_units.forget(rkey)
        try:
            self._report(report)
        except OSError:
            pass  # the leader is gone
