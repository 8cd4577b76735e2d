"""JobServer — the in-process multi-tenant job server.

Counterpart of ``harmony_tpu/jobserver/server.py``, cut to the in-process
core: ``start`` allocates the executors (one slot each, from the
:class:`DevicePool`; a job's tables split over the slots it is granted) and
binds the scheduler; ``submit`` returns a ``Future``
of the job's result and hands the job to the scheduler; each launch runs on a
dispatch thread of its own (the entity's setup, run and cleanup), so the
default share-all scheduler runs every submitted job at once; ``shutdown``
stops accepting, waits for the jobs and joins their threads. Every job's
future resolves, to its result or to the exception that ended it, and the
scheduler hears of every finish. A job's entity comes from
``build_entity``'s app-type switch (``dolphin`` or ``pregel``). The pool is
every visible card unless the caller passes another
(``DevicePool([torch.device("cpu")])``, or ``DevicePool.virtual(device, n)``:
n slots on one device, a simulated mesh).

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

The TCP command plane (``serve_tcp``): one JSON object a connection each
way (``jobserver/client.py``), the reference's wire. A bounded accept queue
feeds a fixed pool of command workers; the overload monitor
(``jobserver/overload.py``) watches the queue and sheds with a structured
``BUSY``. Commands: ``SUBMIT`` (admission first, then ``submit``),
``STATUS``, ``WAIT`` (a bounded poll of one job's result), ``SERVING``
(starts the serving endpoint on demand and answers its address), ``SHUTDOWN``
and ``POD_RESHARD`` (answered ``not a pod server``, as the reference's plain
server answers it; ``jobserver/pod.py``'s server schedules the move through
``schedule_pod_reshard``). ``_entities`` maps a running job to its entity, set
before the entity's set-up and dropped when the job ends; the serving
endpoint reads a job's live table through it, and its pinned reads through
``chkp_root``. ``shutdown`` closes the command plane first and the serving
endpoint last.

Metrics: the server owns one ``MetricManager`` (``metrics``), collecting
from the start; every Dolphin entity gets its ``on_metric`` as the sink of
its workers' ``BatchMetrics`` and its ``ServerMetrics``, and the manager
itself for a job's optimizer loop (``JobConfig.optimizer``).

The pod's server (``jobserver/pod.py::PodJobServer``) extends this one
through three hooks: ``_entity_extras`` (what a job's entity gets beside the
server's schedulers and metrics), ``_pod_reshard_command`` and
``_on_closing`` (run by ``shutdown`` once the jobs have drained).

Control-plane HA (``jobserver/ha.py``): ``enable_ha`` makes this server one
replica of an HA control plane. It tees every structured joblog event into
the durable log (``jobserver/halog.py``), writes a first-class entry for each
submission (its whole config: a successor re-arms the same submission from
it), dispatch and completion, and takes the lease's epoch as its
``leader_epoch``, which stamps every entry (and, on the pod, every message to
the followers). Once the lease has lapsed the server is deposed: ``SUBMIT``,
``WAIT``, ``SERVING`` and ``POD_RESHARD`` answer ``NOT_LEADER`` with the
lease holder's address, durable appends are refused, and a submission whose
record was refused raises :class:`NotLeader`. STATUS and SHUTDOWN are not
gated. STATUS's ``ha`` field gives the role, the epoch, the lease's and the
log's stats and the takeovers.

Not ported yet: the policy engine, history and doctor, metrics scraping, and
the STATUS fields of those subsystems (ROADMAP A.10).
"""
from __future__ import annotations

import json
import queue as _queue
import socket
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Any, Dict, List, Optional, Union

import numpy as np

from harmony_tpu_torch.config.base import ConfigBase
from harmony_tpu_torch.config.params import JobConfig
from harmony_tpu_torch.jobserver import overload as _ov
from harmony_tpu_torch.jobserver.elastic import attempt_of
from harmony_tpu_torch.jobserver.entity import build_entity
from harmony_tpu_torch.jobserver.joblog import server_log as log
from harmony_tpu_torch.jobserver.overload import OverloadMonitor
from harmony_tpu_torch.jobserver.scheduler import (
    JobScheduler,
    ShareAllScheduler,
    make_scheduler,
)
from harmony_tpu_torch.metrics.manager import MetricManager
from harmony_tpu_torch.parallel.mesh import DevicePool, mesh_spans_processes
from harmony_tpu_torch.runtime.master import ETMaster
from harmony_tpu_torch.runtime.taskunit import (
    GlobalTaskUnitScheduler,
    LocalTaskUnitScheduler,
)
from harmony_tpu_torch.tracing.span import SpanContext, trace_span
from harmony_tpu_torch.utils.framing import close_listener


class NotLeader(RuntimeError):
    """Raised by ``submit`` when the durable submission record was refused
    because this leader's lease lapsed between the command gate and the
    append. The command plane answers ``NOT_LEADER``, so the client retries
    on the successor: an acknowledged submission is always in the log."""


def _json_sanitize(obj: Any) -> Any:
    """JSON projection of a job result for the wire (the reference's):
    plain scalars and containers pass, numpy scalars coerce, anything else
    (tensors, arrays) becomes its repr."""
    if isinstance(obj, dict):
        return {str(k): _json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_sanitize(v) for v in obj]
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    if isinstance(obj, np.generic):
        return obj.item()
    return repr(obj)


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
        self.metrics = MetricManager()
        self.metrics.start_collection()
        # job id -> the closure of its deferred offline evaluation
        self._deferred_evals: Dict[str, Any] = {}
        # job id -> the evaluations of its chain, or {"error": ...}
        self.eval_results: Dict[str, Any] = {}
        # job id -> its entity while it runs (the serving plane's live tables)
        self._entities: Dict[str, Any] = {}
        # the TCP command plane (serve_tcp): a bounded accept queue drained
        # by a fixed worker pool; the monitor sheds when it backs up
        self.overload = OverloadMonitor()
        self._tcp_thread: Optional[threading.Thread] = None
        self._tcp_sock: Optional[socket.socket] = None
        self._cmd_queue: Optional["_queue.Queue"] = None
        self._cmd_workers: List[threading.Thread] = []
        self._cmd_queue_cap = 0
        self.port: Optional[int] = None
        # the serving endpoint, started by the first SERVING command
        self.serving = None
        # control-plane HA, wired by enable_ha: leader_epoch stamps every
        # durable entry and pod message, so a deposed leader's late writes
        # are fenced everywhere
        self.ha_log = None
        self.ha_lease = None
        self.ha_replicator = None
        self.ha_replica_id: Optional[str] = None
        self.leader_epoch = 0
        self._ha_sink = None

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

    # -- control-plane HA ----------------------------------------------------

    def enable_ha(self, log, lease=None, replicator=None,
                  replica_id: Optional[str] = None) -> None:
        """Wire the durable log (and the lease and replicator) into this
        server: every structured joblog event tees into the log, submissions
        and completions get entries of their own, and the leader epoch fences
        what the server writes and sends. Called before ``start``."""
        from harmony_tpu_torch.jobserver import joblog

        def sink(job_id: str, ev: Dict[str, Any]) -> None:
            self._ha_append(ev.get("kind", "event"), job_id=job_id,
                            **{k: v for k, v in ev.items() if k not in ("kind", "ts")})

        with self._lock:
            self.ha_log = log
            self.ha_lease = lease
            self.ha_replicator = replicator
            self.ha_replica_id = replica_id
            self.leader_epoch = lease.epoch if lease is not None else log.fence_epoch
            self._ha_sink = sink
        log.set_epoch(self.leader_epoch)
        joblog.add_sink(sink)
        if replicator is not None:
            replicator.start()

    def _ha_leader_ok(self) -> bool:
        """False once a held lease has lapsed: the deposed state, in which
        the gated commands answer NOT_LEADER and durable appends are
        refused."""
        return self.ha_lease is None or self.ha_lease.is_valid()

    def _not_leader_reply(self) -> Dict[str, Any]:
        """The NOT_LEADER redirect, with the lease holder's advertised
        address when the lease file names a live one."""
        hint = None
        if self.ha_lease is not None:
            import os

            from harmony_tpu_torch.jobserver.lease import leader_hint

            hint = leader_hint(os.path.dirname(self.ha_lease.path),
                               own_holder_id=self.ha_lease.holder_id)
        return {"ok": False, "not_leader": True,
                "error": "NOT_LEADER: this replica's lease lapsed (deposed)", "leader": hint}

    #: the entry keys DurableJobLog.append owns; an event field of the same
    #: name (an elastic fence's own ``epoch``) is written as ``ev_<name>``
    _HA_RESERVED = ("seq", "epoch", "ts", "kind", "job")

    def _ha_append(self, kind: str, job_id: Optional[str] = None, **fields: Any) -> bool:
        """A guarded durable append: never fails the caller, dropped (with a
        warning) once this leader is deposed. False when the entry did NOT
        land (deposed, or the log's disk refused it): a caller whose reply
        depends on it (``submit``) refuses then."""
        if self.ha_log is None:
            return True
        if not self._ha_leader_ok():
            log.warning("halog append %r dropped: this leader's lease lapsed (deposed)", kind)
            return False
        try:
            fields = {(f"ev_{k}" if k in self._HA_RESERVED else k): v
                      for k, v in fields.items()}
            self.ha_log.append(kind, job_id=job_id, epoch=self.leader_epoch, **fields)
        except Exception as e:  # noqa: BLE001 - reported by the return value
            log.error("halog append %r failed: %s: %s", kind, type(e).__name__, e)
            return False
        return True

    def _ha_record_done(self, job_id: str, fut: Future) -> None:
        exc = fut.exception()
        if exc is None:
            self._ha_append("job_done", job_id=job_id, ok=True)
        else:
            self._ha_append("job_done", job_id=job_id, ok=False,
                            error=f"{type(exc).__name__}: {exc}"[:300])

    def _ha_status(self) -> Dict[str, Any]:
        from harmony_tpu_torch.jobserver import joblog

        if self.ha_log is None:
            return {"enabled": False}
        takeovers = [ev for ev in joblog.job_events("__ha__", limit=8)
                     if ev.get("kind") == "leader_takeover"]
        return {"enabled": True,
                "role": "leader" if self._ha_leader_ok() else "deposed",
                "replica": self.ha_replica_id, "leader_epoch": self.leader_epoch,
                "lease": self.ha_lease.stats() if self.ha_lease is not None else None,
                "log": self.ha_log.stats(),
                "replication": (self.ha_replicator.stats()
                                if self.ha_replicator is not None else None),
                "takeovers": takeovers}

    def _stop_ha(self) -> None:
        """HA's part of shutdown: unhook the joblog tee, stop the replication
        stream, release the lease (a standby takes over at once instead of
        waiting out the window) and close the log."""
        from harmony_tpu_torch.jobserver import joblog

        with self._lock:
            sink, self._ha_sink = self._ha_sink, None
            replicator, self.ha_replicator = self.ha_replicator, None
            lease, self.ha_lease = self.ha_lease, None
            ha_log, self.ha_log = self.ha_log, None
        if sink is not None:
            joblog.remove_sink(sink)
        if replicator is not None:
            replicator.stop()
        if lease is not None:
            lease.release()
        if ha_log is not None:
            ha_log.close()

    def submit(self, config: JobConfig) -> "Future[Dict[str, Any]]":
        """Schedule a job; the future resolves to the entity's result, or to the
        exception that ended the job. A job id still running is refused. Under
        HA the submission is acknowledged only once its durable record (the
        whole config) is in the log."""
        with self._lock:
            if self._state != "INIT":
                raise RuntimeError(f"server not accepting jobs (state={self._state})")
            existing = self._jobs.get(config.job_id)
            if existing is not None and not existing.done():
                raise ValueError(f"duplicate job id {config.job_id} (still running)")
            future: Future = Future()
            self._jobs[config.job_id] = future
        if self.ha_log is not None:
            # acknowledging a submission no successor could replay would lose
            # it with this leader: unwind and refuse instead
            if not self._ha_append("submission", job_id=config.job_id,
                                   config=config.to_dict()):
                with self._lock:
                    self._jobs.pop(config.job_id, None)
                if not self._ha_leader_ok():
                    raise NotLeader(f"submission {config.job_id} not durable: lease "
                                    "lapsed (deposed)")
                raise RuntimeError(f"submission {config.job_id} not durable: log append "
                                   "failed (sick log store); retry")
            future.add_done_callback(lambda f, j=config.job_id: self._ha_record_done(j, f))
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

    def _future_of(self, job_id: str) -> Future:
        """The future one dispatch of ``job_id`` resolves: its submission's
        (the pod's elastic loop gives each attempt a future of its own)."""
        return self._jobs[job_id]

    def _dispatch(self, config: JobConfig, executor_ids: List[str]) -> None:
        future = self._future_of(config.job_id)
        self._ha_append("dispatch", job_id=config.job_id, executors=list(executor_ids),
                        attempt=attempt_of(config))
        try:
            entity = build_entity(config, chkp_root=self._chkp_root,
                                  global_taskunit=self.global_taskunit,
                                  local_taskunit=self.local_taskunit,
                                  metric_sink=self.metrics.on_metric,
                                  metric_manager=self.metrics,
                                  **self._entity_extras(config, executor_ids))
            with self._lock:
                self._entities[config.job_id] = entity
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
            with self._lock:
                self._entities.pop(config.job_id, None)
            self._scheduler.on_job_finish(config.job_id)

    def _entity_extras(self, config: JobConfig, executor_ids: List[str]) -> Dict[str, Any]:
        """More arguments for a job's entity (none here; the pod's server
        adds its unit protocol's client)."""
        return {}

    def _on_closing(self, timeout: Optional[float]) -> None:
        """Run by :meth:`shutdown` after the deferred evaluations, before
        the state turns CLOSED (nothing here; the pod's server tears its
        control plane down)."""

    def _pod_reshard_command(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return {"ok": False, "error": "not a pod server"}

    def running_jobs(self) -> List[str]:
        with self._lock:
            return [j for j, f in self._jobs.items() if not f.done()]

    def shutdown(self, timeout: Optional[float] = 300.0) -> None:
        """Stop accepting jobs, wait for the submitted ones (including those a
        scheduler still queues) and join their threads. ``timeout`` bounds the
        whole wait; a job still running after it stays visible in its future.
        Then the deferred evaluations run (see :meth:`_run_deferred_evals`),
        with a budget of their own."""
        with self._lock:
            state = self._state
            if state == "INIT":
                self._state = "CLOSING"
        if state != "INIT":
            if state == "NOT_INIT":
                self._stop_ha()  # a takeover that failed before start()
            return
        self._stop_tcp()
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
        self._stop_serving()
        self._on_closing(timeout)
        self._stop_ha()
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

    # -- serving ------------------------------------------------------------

    def _ensure_serving(self):
        """Start the serving endpoint once (first SERVING command) and return
        it. Live lookups resolve through ``_entities``, the tables the
        trainers update; pinned lookups through this server's ``chkp_root``;
        admission through the overload monitor."""
        with self._lock:
            if self.serving is not None:
                return self.serving
            from harmony_tpu_torch.serving import ServingEndpoint

            def live_table(job_id: str):
                with self._lock:
                    entity = self._entities.get(job_id)
                handle = (getattr(entity, "table_handle", None)
                          if entity is not None else None)
                table = handle.table if handle is not None else None
                if table is not None and mesh_spans_processes(table.mesh):
                    # its read is a collective that every process would join,
                    # and the reference's read from one serving thread has no
                    # working form either
                    raise LookupError(
                        f"job {job_id!r}: a live read of a table over several processes "
                        "is refused (ROADMAP C, known differences: live reads over "
                        "processes, a fault of the reference)")
                return table

            svc = ServingEndpoint(table_fn=live_table, chkp_root=self._chkp_root,
                                  overload=self.overload)
            svc.start()
            self.serving = svc
        return svc

    def _stop_serving(self) -> None:
        with self._lock:
            svc, self.serving = self.serving, None
        if svc is not None:
            svc.stop()

    def _status(self) -> Dict[str, Any]:
        """STATUS reply: the fields of the subsystems this port has (``ha``:
        ``{"enabled": false}`` outside an HA control plane). The reference's
        other fields (stragglers, tenants, phase budget, history, diagnoses,
        policy, incidents, input service, flight records) are absent until
        those subsystems are ported (ROADMAP A.10).
        ``job_events`` is this process's structured event rings
        (``jobserver/joblog.py``), by job."""
        from harmony_tpu_torch.jobserver import joblog

        with self._lock:
            serving = self.serving
        return {
            "ok": True,
            "state": self.state,
            "running": self.running_jobs(),
            "evaluated": sorted(self.eval_results),
            "serving": serving.stats() if serving is not None else None,
            "overload": self.overload.status(),
            "ha": self._ha_status(),
            "job_events": joblog.job_events(),
        }

    # -- TCP command endpoint ------------------------------------------------

    #: byte cap on ONE command message: a client streaming forever costs a
    #: bounded buffer
    _MAX_CMD_BYTES = 16 << 20

    def serve_tcp(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Listen on ``host:port`` (0 picks a free port); returns the bound
        port. One JSON object a connection each way. The accept loop feeds a
        bounded queue drained by a fixed worker pool (``HARMONY_CMD_WORKERS``,
        ``HARMONY_CMD_QUEUE``); a full queue answers ``BUSY`` at accept."""
        from harmony_tpu_torch import faults

        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        sock.listen(64)
        cap = _ov.cmd_queue_cap()
        q: "_queue.Queue" = _queue.Queue(maxsize=cap)
        workers: List[threading.Thread] = []
        for i in range(_ov.cmd_workers()):
            t = threading.Thread(target=self._cmd_worker, args=(q, cap),
                                 daemon=True, name=f"jobserver-cmd-{i}")
            t.start()
            workers.append(t)
        with self._lock:
            self._tcp_sock = sock
            self._cmd_queue = q
            self._cmd_workers = workers
            self._cmd_queue_cap = cap
        self.port = sock.getsockname()[1]

        def loop() -> None:
            while True:
                try:
                    conn, _ = sock.accept()
                except OSError:
                    return  # socket closed
                if faults.armed():
                    try:
                        faults.site("server.accept", depth=q.qsize())
                    except Exception:
                        # an injected accept fault drops this connection only
                        try:
                            conn.close()
                        except OSError:
                            pass
                        continue
                try:
                    q.put_nowait((conn, time.monotonic()))
                except _queue.Full:
                    # shed at the door: a structured BUSY beats an
                    # accepted-then-starved connection
                    self.overload.note_queue(q.qsize(), cap)
                    self.overload.count_shed("accept_shed")
                    self._send_busy(conn, self.overload.retry_after_ms())
                    self.overload.step()

        self._tcp_thread = threading.Thread(target=loop, daemon=True, name="jobserver-tcp")
        self._tcp_thread.start()
        return self.port

    def _send_busy(self, conn: socket.socket, retry_after_ms: int) -> None:
        """Best-effort BUSY reply on a connection being shed (bounded: the
        accept loop never blocks on a slow client)."""
        reply = {"ok": False, "busy": True, "retry_after_ms": int(retry_after_ms),
                 "error": "BUSY: control plane overloaded"}
        try:
            conn.settimeout(1.0)
            conn.sendall((json.dumps(reply) + "\n").encode())
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _cmd_worker(self, q: "_queue.Queue", cap: int) -> None:
        """One pool worker: drain the accept queue until a None sentinel. The
        queue's lag (how long a connection waited) feeds the monitor."""
        while True:
            item = q.get()
            if item is None:
                return
            conn, enq_t = item
            self.overload.note_queue(q.qsize(), cap, lag_sec=time.monotonic() - enq_t)
            self.overload.step()
            try:
                self._handle_conn(conn)
            except Exception:  # noqa: BLE001 - a handler fault must not
                pass           # end the pool worker

    def _read_command(self, conn: socket.socket, deadline: float) -> bytes:
        """One newline-terminated command, capped in bytes and wall clock (a
        trickling client cannot hold a worker past the deadline)."""
        data = b""
        while not data.endswith(b"\n"):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.overload.count_shed("slowloris_evict")
                raise TimeoutError("command read exceeded its wall-clock deadline "
                                   "(slow client evicted)")
            conn.settimeout(min(5.0, remaining))
            try:
                chunk = conn.recv(65536)
            except socket.timeout:
                continue
            if not chunk:
                break
            data += chunk
            if len(data) > self._MAX_CMD_BYTES:
                self.overload.count_shed("oversize_evict")
                raise ValueError(f"command exceeds {self._MAX_CMD_BYTES} byte cap")
        return data

    def _handle_conn(self, conn: socket.socket) -> None:
        from harmony_tpu_torch import faults

        deadline = time.monotonic() + _ov.cmd_deadline_sec()
        # the reply goes out before `with conn` closes the socket
        with conn:
            try:
                data = self._read_command(conn, deadline)
                msg = json.loads(data.decode())
                cmd = msg.get("command")
                if faults.armed():
                    faults.site("server.command", cmd=str(cmd))
                if (cmd in ("SUBMIT", "POD_RESHARD", "WAIT", "SERVING")
                        and not self._ha_leader_ok()):
                    # deposed: the commands that act or answer for the leader
                    # redirect to the lease holder
                    reply = self._not_leader_reply()
                elif cmd == "SUBMIT":
                    reply = self._submit_command(msg)
                elif cmd == "STATUS":
                    reply = self._status()
                elif cmd == "WAIT":
                    reply = self._wait_command(msg, deadline)
                elif cmd == "POD_RESHARD":
                    reply = self._pod_reshard_command(msg)
                elif cmd == "SERVING":
                    svc = self._ensure_serving()
                    reply = {"ok": True, "port": svc.port, "host": svc.address[0]}
                elif cmd == "SHUTDOWN":
                    threading.Thread(target=self.shutdown, daemon=True).start()
                    reply = {"ok": True}
                else:
                    reply = {"ok": False, "error": f"unknown command {cmd!r}"}
            except Exception as e:  # noqa: BLE001 - reported to the client
                reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            try:
                conn.sendall((json.dumps(reply) + "\n").encode())
            except OSError:
                pass  # the client went away

    def _submit_command(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Admission before anything is registered: a rejected submission
        leaves no trace, an admitted one goes to ``submit``."""
        with self._lock:
            q = self._cmd_queue
        retry_ms = self.overload.admit_submit(
            queue_depth=q.qsize() if q is not None else 0,
            queue_cap=self._cmd_queue_cap or 1,
            inflight=len(self.running_jobs()))
        if retry_ms is not None:
            return {"ok": False, "busy": True, "retry_after_ms": retry_ms,
                    "error": f"BUSY: control plane overloaded; retry after {retry_ms}ms"}
        config = ConfigBase.from_dict(msg["conf"])
        try:
            with trace_span("jobserver.submit", parent=SpanContext.from_wire(msg.get("trace")),
                            job_id=config.job_id):
                self.submit(config)
        except NotLeader:
            # deposed between the gate and the durable append: the submission
            # was unwound, so redirect rather than acknowledge
            return self._not_leader_reply()
        return {"ok": True, "job_id": config.job_id}

    def _wait_command(self, msg: Dict[str, Any], deadline: float) -> Dict[str, Any]:
        """A bounded wait on one job's result, capped by the command deadline
        (a WAIT holds a pool worker; clients poll in a loop)."""
        job_id = str(msg.get("job_id"))
        timeout = min(float(msg.get("timeout", 30.0)), 300.0,
                      max(0.5, deadline - time.monotonic()))
        with self._lock:
            future = self._jobs.get(job_id)
        if future is None:
            return {"ok": False, "known": False, "error": f"unknown job {job_id!r}"}
        try:
            result = future.result(timeout=timeout)
        except (TimeoutError, FuturesTimeoutError):
            return {"ok": True, "done": False, "running": job_id in self.running_jobs()}
        except BaseException as e:  # noqa: BLE001 - the job's failure
            return {"ok": False, "known": True, "done": True,
                    "error": f"{type(e).__name__}: {e}"}
        return {"ok": True, "done": True, "result": _json_sanitize(result)}

    def _stop_tcp(self) -> None:
        """Close the listener, answer the queued connections with EOF and stop
        the pool (under the lock: two SHUTDOWNs may race here)."""
        with self._lock:
            sock, self._tcp_sock = self._tcp_sock, None
            q, self._cmd_queue = self._cmd_queue, None
            workers, self._cmd_workers = self._cmd_workers, []
        if sock is not None:
            close_listener(sock)   # wakes the accept loop
        if q is None:
            return
        while True:
            try:
                item = q.get_nowait()
            except _queue.Empty:
                break
            if item is not None:
                try:
                    item[0].close()
                except OSError:
                    pass
        for _ in workers:
            try:
                q.put(None, timeout=1.0)
            except _queue.Full:
                break  # workers are daemons: leak rather than hang
        # a worker mid-WAIT holds its slot up to the command deadline
        for t in workers:
            if t is not threading.current_thread():
                t.join(timeout=0.5)
