"""Warm-standby JobServer failover: the control plane's HA.

Counterpart of ``harmony_tpu/jobserver/ha.py``. It composes the two
primitives beside it:

  * :mod:`harmony_tpu_torch.jobserver.halog`: the durable, replicated,
    CRC-framed log of control-plane transitions;
  * :mod:`harmony_tpu_torch.jobserver.lease`: the file lease with fenced
    (monotonic) leader epochs.

A control-plane replica runs ONE :class:`HAController`:

  * **standby**: a small TCP endpoint answers on the submit port at once
    (STATUS with ``role=standby``; everything else a ``NOT_LEADER`` reply
    carrying the current leader's advertised address, which the failover
    client follows), and, with peer replication, a
    :class:`~halog.LogReceiver` applies the leader's stream to the local
    copy of the log. The replica contends on the lease at a fraction of its
    period. It builds no server, so it holds no executor and no CUDA
    context.
  * **takeover**: once the lease lands (the old leader died or stopped
    renewing), renew it from that moment, replay the log (fenced), build
    the JobServer through the caller's factory, wire the log and the lease
    into it (``JobServer.enable_ha``), serve the SAME submit port the
    standby endpoint just vacated, and RE-ARM every in-flight submission:
    elastic jobs continue their attempt sequence, chained jobs resume from
    their chain (``resume_from_chain``), chainless ones run again from the
    start. A WAIT for a job that finished under the old leader answers done
    (:meth:`HAController._seed_done`).

One ``kind="leader_takeover"`` joblog event records every takeover (old and
new leader, replay ms, entries replayed, re-armed jobs); it rides STATUS's
``ha`` field and the durable log itself. The fault site
``jobserver.takeover`` sits at the start of a takeover.

Not ported with it: the reference's takeover also adopts the replayed
incidents into its incident engine and posts the event to its dashboard;
the port has neither subsystem yet (ROADMAP A item 6), so ``ReplayState``
keeps the incidents and nothing adopts them.
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional

from harmony_tpu_torch.jobserver import joblog
from harmony_tpu_torch.jobserver.halog import (
    LOG_FILENAME,
    DurableJobLog,
    LogReceiver,
    LogReplicator,
    ReplayState,
)
from harmony_tpu_torch.jobserver.joblog import server_log
from harmony_tpu_torch.jobserver.lease import LeaseManager, replica_peers

#: the pseudo-job id the HA events are recorded under
HA_JOB = "__ha__"


def ha_enabled() -> bool:
    from harmony_tpu_torch.jobserver.lease import ha_log_dir

    return ha_log_dir() is not None


class StandbyEndpoint:
    """The small TCP responder a standby runs on the submit port: STATUS
    answers (operators see the replica and who leads), everything else gets
    ``NOT_LEADER`` with the leader's advertised address, so the failover
    client redirects instead of guessing."""

    def __init__(self, port: int, info_fn: Callable[[], Dict[str, Any]],
                 leader_hint_fn: Callable[[], Optional[str]],
                 host: str = "127.0.0.1") -> None:
        self._port = port
        self._host = host
        self._info_fn = info_fn
        self._leader_hint_fn = leader_hint_fn
        self._sock: Optional[socket.socket] = None
        self.port: Optional[int] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self._host, self._port))
        sock.listen(16)
        sock.settimeout(0.5)
        self._sock = sock
        self.port = sock.getsockname()[1]
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ha-standby-tcp")
        self._thread.start()
        return self.port

    def stop(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        # a thread inside accept() keeps the port bound until it returns, and
        # the takeover binds this very port for the real server
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        while True:
            sock = self._sock
            if sock is None:
                return
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # a one-line reply under a 10 s timeout a connection
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        with conn:
            try:
                conn.settimeout(10.0)
                data = b""
                while not data.endswith(b"\n"):
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    data += chunk
                try:
                    cmd = json.loads(data.decode()).get("command")
                except ValueError:
                    cmd = None
                if cmd == "STATUS":
                    reply: Dict[str, Any] = {"ok": True, "state": "STANDBY", "running": [],
                                             "ha": self._info_fn()}
                else:
                    reply = {"ok": False, "not_leader": True,
                             "error": "NOT_LEADER: this replica is a warm standby",
                             "leader": self._leader_hint_fn()}
                conn.sendall((json.dumps(reply) + "\n").encode())
            except OSError:
                pass


class HAController:
    """One control-plane replica: standby until the lease lands, then take
    over (module doc). ``server_factory()`` returns an UNSTARTED JobServer."""

    def __init__(
        self,
        server_factory: Callable[[], Any],
        log_dir: str,
        replica_id: str,
        submit_port: int = 0,
        advertise_addr: Optional[str] = None,
        recv_port: Optional[int] = None,
        peers: Optional[List[str]] = None,
        lease_s: Optional[float] = None,
        bind_host: str = "127.0.0.1",
    ) -> None:
        self._factory = server_factory
        self.log_dir = log_dir
        self.replica_id = replica_id
        self.submit_port = submit_port
        self.advertise_addr = advertise_addr
        self._recv_port = recv_port
        self.peers = peers if peers is not None else replica_peers()
        self._lease_s = lease_s
        #: the interface the standby endpoint and the server bind
        self.bind_host = bind_host
        self.log_path = os.path.join(log_dir, LOG_FILENAME)
        self.lease: Optional[LeaseManager] = None
        self.server: Optional[Any] = None
        self.receiver: Optional[LogReceiver] = None
        self.standby: Optional[StandbyEndpoint] = None
        self.port: Optional[int] = None
        self.replay_ms: Optional[float] = None
        self.replayed_entries = 0
        self.rearmed: List[str] = []
        self._stop = threading.Event()
        self._leader_ready = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: guards port, receiver, server and the replay's bookkeeping:
        #: start() runs on the caller's thread, _takeover on the controller's
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def _new_lease(self) -> LeaseManager:
        return LeaseManager(self.log_dir, self.replica_id, lease_s=self._lease_s,
                            addr=self.advertise_addr or f"127.0.0.1:{self.port}",
                            on_lost=self._on_deposed)

    def start(self) -> "HAController":
        """Begin the standby-to-leader state machine on a thread of its own;
        the standby endpoint answers the submit port before this returns."""
        standby = StandbyEndpoint(self.submit_port, self._standby_info, self._leader_hint,
                                  host=self.bind_host)
        port = standby.start()
        with self._lock:
            self.standby = standby
            self.port = port
        if self._recv_port is not None:
            # peer replication: the LOCAL copy is fed by the leader's stream
            # (with a shared directory the file is opened only at takeover)
            receiver = LogReceiver(DurableJobLog(self.log_path), port=self._recv_port)
            receiver.start()
            with self._lock:
                self.receiver = receiver
        with self._lock:
            self.lease = self._new_lease()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"ha-{self.replica_id}")
        self._thread.start()
        return self

    def wait_leader(self, timeout: Optional[float] = None) -> bool:
        """Block until THIS replica has completed a takeover."""
        return self._leader_ready.wait(timeout)

    def stop(self, shutdown_timeout: float = 60.0) -> None:
        self._stop.set()
        if self.lease is not None:
            self.lease.stop()
        if self.standby is not None:
            self.standby.stop()
        # a takeover in progress ends before its server is shut down here
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=shutdown_timeout)
        with self._lock:
            receiver, self.receiver = self.receiver, None
            server, self.server = self.server, None
        if receiver is not None:
            receiver.stop()
            receiver.log.close()
        if server is not None:
            try:
                server.shutdown(timeout=shutdown_timeout)
            except Exception:  # noqa: BLE001 - the lease is released below
                pass
        if self.lease is not None:
            self.lease.release()

    # -- standby -------------------------------------------------------------

    def _standby_info(self) -> Dict[str, Any]:
        return {"enabled": True, "role": "standby", "replica": self.replica_id,
                "leader": self._leader_hint(),
                "log": self.receiver.stats() if self.receiver is not None else None}

    def _leader_hint(self) -> Optional[str]:
        """The live leader's advertised submit address from the lease file:
        the redirect target of NOT_LEADER replies."""
        from harmony_tpu_torch.jobserver.lease import leader_hint, read_lease

        cur = read_lease(self.log_dir)
        if cur and cur.get("holder") == self.replica_id:
            return self.advertise_addr
        return leader_hint(self.log_dir)

    def _on_deposed(self) -> None:
        """This replica lost a lease it held. Its server is already fenced
        (the lease is invalid, so submits answer NOT_LEADER and durable
        appends are refused); say so loudly."""
        server_log.error("HA replica %s DEPOSED at epoch %s: a successor holds the lease; "
                         "this server now answers NOT_LEADER", self.replica_id,
                         self.lease.epoch if self.lease is not None else "?")

    # -- takeover ------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            if not self.lease.wait_acquire():
                return  # stopped while standing by
            if self._stop.is_set():
                return
            # renew from the moment the lease lands: the takeover (building
            # the server, replaying the log) can outlast a lease window, and a
            # lapsed lease would let a peer run the same re-armed jobs
            self.lease.start_renewal()
            try:
                self._takeover()
                return
            except Exception as e:  # noqa: BLE001 - release, then stand by again
                server_log.error("HA takeover by %s FAILED: %s: %s", self.replica_id,
                                 type(e).__name__, e)
                self.lease.release()
                if self._stop.wait(max(0.2, self.lease.lease_s / 2.0)):
                    return
                self._restandby()

    def _restandby(self) -> None:
        """The standby phase again after a failed takeover: the endpoint on
        the same port (the takeover stopped it) and a fresh lease manager
        (release() stopped the old one's renewal)."""
        standby = StandbyEndpoint(self.port or self.submit_port, self._standby_info,
                                  self._leader_hint, host=self.bind_host)
        with self._lock:
            self.standby = standby
        try:
            port = standby.start()
            with self._lock:
                self.port = port
        except OSError as e:
            # the port may be briefly unreleasable after a failed bind; the
            # replica keeps contending without the endpoint
            server_log.warning("HA %s: standby endpoint re-bind failed (%s); standing by "
                               "without it", self.replica_id, e)
        with self._lock:
            self.lease = self._new_lease()

    def _takeover(self) -> None:
        from harmony_tpu_torch import faults

        t0 = time.perf_counter()
        prev = self.lease.previous or {}
        if faults.armed():
            faults.site("jobserver.takeover", replica=self.replica_id, epoch=self.lease.epoch)
        # the standby endpoint vacates the submit port; leadership supersedes
        # the receiver's stream
        with self._lock:
            receiver, self.receiver = self.receiver, None
        if receiver is not None:
            receiver.stop()
            receiver.log.close()
        self.standby.stop()
        log = DurableJobLog(self.log_path)  # truncates a torn tail
        server = None
        try:
            log.set_epoch(self.lease.epoch)
            state = ReplayState.from_entries(log.entries())
            # the replayed takeover history seeds this process's event ring
            # before enable_ha hooks the durable sink (nothing re-appended)
            for e in state.takeovers[-8:]:
                joblog.record_event(HA_JOB, "leader_takeover", **{
                    k: v for k, v in e.items() if k not in ("seq", "epoch", "kind", "job")})
            replicator = LogReplicator(log, self.peers) if self.peers else None
            server = self._factory()
            server.enable_ha(log, lease=self.lease, replicator=replicator,
                             replica_id=self.replica_id)
            server.start()
            port = server.serve_tcp(self.submit_port or (self.port or 0), host=self.bind_host)
            if not self.lease.is_valid():
                # the lease lapsed mid-takeover despite the renewals: a
                # successor may already lead, so re-arm nothing
                raise RuntimeError("lease lapsed during takeover")
            rearmed = self._rearm(server, state)
            self._seed_done(server, state)
        except BaseException:
            # a half-done takeover leaks no running server, open log or sink
            if server is not None:
                try:
                    server.shutdown(timeout=15.0)  # _stop_ha closes the log
                except Exception:  # noqa: BLE001 - re-raised below
                    pass
            else:
                log.close()
            raise
        with self._lock:
            self.port = port
            self.rearmed = rearmed
            self.replayed_entries = state.entries_applied
            self.replay_ms = round((time.perf_counter() - t0) * 1000.0, 2)
            self.server = server
        joblog.record_event(HA_JOB, "leader_takeover", old_leader=prev.get("holder"),
                            new_leader=self.replica_id, epoch=self.lease.epoch,
                            replay_ms=self.replay_ms, replayed_entries=state.entries_applied,
                            rejected_stale=state.rejected_stale, rearmed=list(self.rearmed),
                            readopted_pods=sorted(getattr(server, "_followers", {}) or {}))
        server_log.info("HA takeover complete: %s leads at epoch %d (replay %.1f ms, %d "
                        "in-flight submission(s) re-armed, port %d)", self.replica_id,
                        self.lease.epoch, self.replay_ms, len(self.rearmed), self.port)
        self._leader_ready.set()

    def _rearm(self, server: Any, state: ReplayState) -> List[str]:
        """Re-arm every in-flight submission of the replayed log: elastic
        jobs continue their attempt sequence, chained jobs resume from their
        newest chain entry, chainless ones run again from the start. One
        failing re-arm does not stop the rest."""
        from harmony_tpu_torch.config.base import ConfigBase

        rearmed: List[str] = []
        for job in state.in_flight():
            try:
                cfg = ConfigBase.from_dict(state.submissions[job])
                has_chain = self._has_chain(server, job)
                if has_chain and cfg.user.get("elastic_shrink"):
                    # the attempt key keeps a straggling report of the dead
                    # leader's attempt out of this one
                    cfg.user["elastic_recovery"] = {
                        "attempt": state.attempts.get(job, 0) + 1,
                        "kind": "shrink", "lost_executors": []}
                elif has_chain:
                    cfg.user["resume_from_chain"] = True
                server.submit(cfg)
                rearmed.append(job)
            except Exception as e:  # noqa: BLE001 - re-arm the rest
                server_log.error("takeover re-arm of %s failed: %s: %s", job,
                                 type(e).__name__, e)
        return rearmed

    @staticmethod
    def _seed_done(server: Any, state: ReplayState) -> None:
        """Register every COMPLETED submission's outcome from the replayed
        log, so a WAIT on the successor answers done for it instead of
        "unknown job". The workers' result died with the old leader; only
        the terminal ok or error rides the log, and the seeded result says
        so."""
        for job, entry in state.done.items():
            if job not in state.submissions:
                continue
            fut: Future = Future()
            if entry.get("ok"):
                fut.set_result({"done": True, "ok": True, "replayed": True,
                                "epoch": entry.get("epoch")})
            else:
                fut.set_exception(RuntimeError(
                    f"job {job} failed under a previous leader: {entry.get('error')}"))
            with server._lock:
                server._jobs.setdefault(job, fut)

    @staticmethod
    def _has_chain(server: Any, job: str) -> bool:
        root = getattr(server, "_chkp_root", None)
        if not root:
            return False
        try:
            from harmony_tpu_torch.checkpoint.manager import CheckpointManager

            prefix = f"{job}:"
            return any(c.startswith(prefix)
                       for c in CheckpointManager.for_job(root, job).list_checkpoints())
        except Exception:  # noqa: BLE001 - no readable chain is no chain
            return False
