"""The durable replicated job log: the control plane's source of truth.

Counterpart of ``harmony_tpu/jobserver/halog.py``, copied. The structured
joblog events (``jobserver/joblog.py``) live in one process's memory, so
when the JobServer leader dies every submission, attempt, fence and chain
pointer dies with it. This module keeps them in an append-only, fsync'd,
CRC-framed file of control-plane transitions: the submission (its whole
config, so a takeover re-arms the SAME submission), the dispatch, the
elastic attempts and fences, completion. A log written by either package
replays in the other: the file name (``job.walog``), the frame and the
payload's bytes are the reference's.

  * :class:`DurableJobLog`: the file. One record an entry: ``u32 length |
    u32 crc32(payload) | payload`` (little-endian, a JSON payload with
    sorted keys). An append is one write, flush and fsync (a group commit
    under a burst), so a committed record survives the process; opening the
    file truncates a TORN TAIL (a crash mid-append) at the last whole,
    CRC-valid record.
  * :class:`LogReplicator` / :class:`LogReceiver`: leader-to-standby
    streaming over the framed wire (``utils/framing.py``): the receiver
    opens with its last applied seq, the replicator streams the missing
    suffix from disk and then the live entries; a reconnect re-runs the
    same handshake, so replication is idempotent by seq, and the receiver
    keeps the leader's seq verbatim.
  * :class:`ReplayState`: what a new leader needs, rebuilt from the
    entries: in-flight submissions (accepted minus completed), the last
    attempt of each job, chain pointers, the takeover history and the
    incidents. FENCED: an entry stamped with a leader epoch lower than one
    already replayed is a deposed leader's late write and is rejected.

Fault sites (the reference's names and keys): ``jobserver.log_append``,
``disk.write`` and ``disk.fsync`` with ``kind="halog"``, and ``net.connect``
and ``net.send`` with ``role="halog.repl"`` (``faults/partition.py``).
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from harmony_tpu_torch import faults
from harmony_tpu_torch.jobserver.joblog import server_log
from harmony_tpu_torch.utils.framing import read_exact, send_frame_parts, set_nodelay

_HEADER = struct.Struct("<II")  # payload length, crc32(payload)
#: a bound on one record: a length field past it is torn or garbage
_MAX_RECORD = 16 << 20
#: the log's file name under HARMONY_HA_LOG_DIR
LOG_FILENAME = "job.walog"


class StaleEpochError(RuntimeError):
    """A write stamped with a leader epoch older than one the log has
    already accepted: a deposed leader's late append, refused."""

    def __init__(self, entry_epoch: int, fence_epoch: int) -> None:
        super().__init__(f"fenced: entry epoch {entry_epoch} < log epoch {fence_epoch} "
                         "(a deposed leader's late write)")
        self.entry_epoch = entry_epoch
        self.fence_epoch = fence_epoch


def encode_record(payload: bytes) -> bytes:
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def scan_records(path: str) -> Tuple[List[Dict[str, Any]], int, int]:
    """Scan the log file: (entries, good_bytes, torn_bytes). ``good_bytes``
    ends the last whole CRC-valid record; anything past it (a torn tail, or
    trailing corruption) counts in ``torn_bytes`` and is not decoded."""
    entries: List[Dict[str, Any]] = []
    good = 0
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            while True:
                head = f.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    break
                length, crc = _HEADER.unpack(head)
                if length > _MAX_RECORD:
                    break
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    break
                try:
                    entries.append(json.loads(payload.decode()))
                except (ValueError, UnicodeDecodeError):
                    break  # framed but unparseable: torn
                good = f.tell()
    except FileNotFoundError:
        return [], 0, 0
    return entries, good, max(0, size - good)


class DurableJobLog:
    """The append-only fsync'd control-plane log (module doc).

    ``fence_epoch`` is the highest leader epoch the log has accepted;
    :meth:`append` refuses a lower one with :class:`StaleEpochError`. An
    append reaches the registered sinks (the replicator) only AFTER its
    record is durable: a standby never holds an entry the leader's disk
    does not."""

    def __init__(self, path: str) -> None:
        self.path = path
        entries, good, torn = scan_records(path)
        if torn:
            server_log.warning("halog: truncating %d torn byte(s) at the tail of %s "
                               "(%d whole record(s) kept)", torn, path, len(entries))
            with open(path, "rb+") as f:
                f.truncate(good)
        self.torn_recovered = torn
        self._lock = threading.Lock()
        self._seq = max((int(e.get("seq", 0)) for e in entries), default=0)
        self.fence_epoch = max((int(e.get("epoch", 0)) for e in entries), default=0)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab")
        self._sinks: List[Callable[[Dict[str, Any], bytes], None]] = []
        self.appends = 0
        self.append_bytes = 0
        #: seconds spent inside durable appends (write, flush, fsync)
        self.append_seconds = 0.0
        # group commit: ``_lock`` orders writes (seq, file write, pending
        # queue); ``_commit_lock`` serialises flush, fsync and sink delivery.
        # Under a burst the committer fsyncs every record written so far in
        # one call, and the writers it covered return without their own; at
        # low load each append is still one write, flush and fsync.
        self._commit_lock = threading.Lock()
        self._wrote_n = 0    # a monotonic write token (not the wire seq:
        self._durable_n = 0  # a receiver mirrors the leader's seqs)
        #: written, not yet sunk entries, in seq order
        self._pending: List[Tuple[int, Dict[str, Any], bytes]] = []
        #: fsync calls made: appends / group_commits is the batching factor
        self.group_commits = 0
        self._closed = False

    # -- the write side ------------------------------------------------------

    def set_epoch(self, epoch: int) -> None:
        """Raise the fence (a new leader stamps its lease epoch here before
        its first append)."""
        with self._lock:
            if epoch < self.fence_epoch:
                raise StaleEpochError(epoch, self.fence_epoch)
            self.fence_epoch = int(epoch)

    def append(self, kind: str, job_id: Optional[str] = None, epoch: Optional[int] = None,
               seq: Optional[int] = None, **fields: Any) -> Dict[str, Any]:
        """Append one durable entry; returns it (with seq, epoch, ts). Raises
        StaleEpochError for a fenced write. ``seq`` keeps an upstream
        sequence number (the receiver passes the LEADER's seq verbatim);
        local writers leave it None and get the next local seq."""
        t0 = time.perf_counter()
        with self._lock:
            ep = self.fence_epoch if epoch is None else int(epoch)
            if ep < self.fence_epoch:
                raise StaleEpochError(ep, self.fence_epoch)
            self.fence_epoch = ep
            prev_seq = self._seq
            self._seq = int(seq) if seq is not None else self._seq + 1
            entry = {"seq": self._seq, "epoch": ep, "ts": time.time(),
                     "kind": kind, "job": job_id, **fields}
            # the tail-repair bracket: flush so the buffer is empty, note the
            # durable size, and truncate back to it on ANY write failure, or
            # a torn append would leave half a record mid-stream and hide
            # every later entry from replay
            self._f.flush()
            good_off = os.fstat(self._f.fileno()).st_size
            try:
                if faults.armed():
                    # "raise": a failing log disk; "delay": a slow fsync
                    faults.site("jobserver.log_append", kind=kind, seq=self._seq)
                payload = json.dumps(entry, sort_keys=True, default=repr).encode()
                rec = encode_record(payload)
                if faults.armed():
                    # ENOSPC/EIO raise here; "corrupt" is a torn write: a
                    # prefix of the record lands and the append dies
                    act = faults.site("disk.write", kind="halog", seq=self._seq)
                    if act == "corrupt":
                        self._f.write(rec[:max(1, len(rec) // 2)])
                        self._f.flush()
                        raise faults.DiskIOError(f"injected torn halog write [seq={self._seq}]")
                self._f.write(rec)
            except Exception:
                self._seq = prev_seq
                try:
                    self._f.flush()
                except OSError:
                    pass  # the truncate below repairs whatever landed
                try:
                    os.ftruncate(self._f.fileno(), good_off)
                except OSError:
                    pass  # reopening truncates the tail too
                raise
            self._wrote_n += 1
            token = self._wrote_n
            self._pending.append((token, entry, rec))
            self.appends += 1
            self.append_bytes += len(rec)
        # durability and sinks outside the write lock: writers keep
        # appending while one committer fsyncs the batch
        self._commit(token)
        self.append_seconds += time.perf_counter() - t0
        return entry

    def _commit(self, token: int) -> None:
        """Make every record written up to ``token`` durable, then hand the
        covered entries to the sinks in seq order (``_commit_lock``
        serialises committers; a lower seq reaching the replicator late
        would be dropped by the receiver as a duplicate)."""
        with self._commit_lock:
            with self._lock:
                if self._durable_n >= token or self._closed:
                    return  # an earlier committer covered it
                self._f.flush()
                top = self._wrote_n
                sinks = list(self._sinks)
            # a lying disk that never syncs is a "skip" rule
            if not faults.armed() or faults.site("disk.fsync", kind="halog") != "skip":
                os.fsync(self._f.fileno())
            self.group_commits += 1
            with self._lock:
                self._durable_n = top
                batch: List[Tuple[int, Dict[str, Any], bytes]] = []
                while self._pending and self._pending[0][0] <= top:
                    batch.append(self._pending.pop(0))
            # sinks under the commit lock, not the write lock: the
            # replicator reads last_seq (the write lock) and never takes
            # this one
            for _tok, entry, rec in batch:
                for sink in sinks:
                    try:
                        sink(entry, rec)
                    except Exception:  # noqa: BLE001 - catch-up repairs a gap
                        pass

    def add_sink(self, fn: Callable[[Dict[str, Any], bytes], None]) -> None:
        with self._lock:
            self._sinks.append(fn)

    def remove_sink(self, fn) -> None:
        with self._lock:
            if fn in self._sinks:
                self._sinks.remove(fn)

    # -- the read side -------------------------------------------------------

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def entries(self, since_seq: int = 0) -> List[Dict[str, Any]]:
        """A whole-file scan (a torn tail skipped, not truncated), the
        entries past ``since_seq``: the replicator's catch-up and the
        takeover's replay."""
        with self._lock:
            self._f.flush()
        out, _good, _torn = scan_records(self.path)
        return [e for e in out if int(e.get("seq", 0)) > since_seq]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"path": self.path, "last_seq": self._seq,
                    "fence_epoch": self.fence_epoch, "appends": self.appends,
                    "append_bytes": self.append_bytes,
                    "append_seconds": round(self.append_seconds, 6),
                    "group_commits": self.group_commits,
                    "torn_recovered_bytes": self.torn_recovered,
                    "sinks": len(self._sinks)}

    def close(self) -> None:
        """One last commit, so nothing written stays un-fsynced, and the
        pending tail reaches the sinks."""
        with self._commit_lock:
            with self._lock:
                self._closed = True
                sinks = list(self._sinks)
                batch = list(self._pending)
                self._pending.clear()
                if batch:
                    self._durable_n = max(self._durable_n, batch[-1][0])
                try:
                    self._f.flush()
                    os.fsync(self._f.fileno())
                except (OSError, ValueError):
                    pass  # already closed
                try:
                    self._f.close()
                except OSError:
                    pass
            for _tok, entry, rec in batch:
                for sink in sinks:
                    try:
                        sink(entry, rec)
                    except Exception:  # noqa: BLE001 - as in _commit
                        pass


# -- replication ---------------------------------------------------------------


def _send_record(sock: socket.socket, payload: bytes) -> None:
    send_frame_parts(sock, _HEADER.pack(len(payload), zlib.crc32(payload)), [payload],
                     role="halog.repl")


def _recv_record(sock: socket.socket) -> Optional[bytes]:
    head = read_exact(sock, _HEADER.size)
    if head is None:
        return None
    length, crc = _HEADER.unpack(bytes(head))
    if length > _MAX_RECORD:
        raise ValueError(f"replication frame length {length} exceeds cap")
    payload = read_exact(sock, length)
    if payload is None:
        return None
    payload = bytes(payload)
    if zlib.crc32(payload) != crc:
        raise ValueError("replication frame CRC mismatch")
    return payload


class LogReplicator:
    """The leader's side: stream every durable entry to the standby
    receivers ``peers`` (``host:port``, HARMONY_HA_REPLICAS). A daemon
    thread a peer: connect (bounded backoff), read the receiver's
    ``{"last_seq": n}`` hello, send the missing suffix from disk, then drain
    the live queue. Any error drops the connection, and the reconnect's
    handshake repairs the gap."""

    def __init__(self, log: DurableJobLog, peers: List[str],
                 connect_timeout: float = 5.0) -> None:
        self.log = log
        self.peers = list(peers)
        self._connect_timeout = connect_timeout
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._queues: Dict[str, List[bytes]] = {p: [] for p in self.peers}
        self._cond = threading.Condition(self._lock)
        self._state: Dict[str, Dict[str, Any]] = {
            p: {"connected": False, "sent_seq": 0, "reconnects": 0, "resync": False}
            for p in self.peers}
        self._threads: List[threading.Thread] = []

    def start(self) -> None:
        self.log.add_sink(self._on_append)
        for peer in self.peers:
            t = threading.Thread(target=self._peer_loop, args=(peer,), daemon=True,
                                 name=f"halog-repl-{peer}")
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self.log.remove_sink(self._on_append)
        self._stop.set()
        with self._cond:
            self._cond.notify_all()

    def _on_append(self, entry: Dict[str, Any], rec: bytes) -> None:
        with self._cond:
            for peer, q in self._queues.items():
                q.append(rec)
                # a slow or dead standby: drop the backlog AND force that
                # peer to resync from disk (a silent drop would be a gap)
                if len(q) > 4096:
                    q.clear()
                    self._state[peer]["resync"] = True
            self._cond.notify_all()

    def _peer_loop(self, peer: str) -> None:
        from harmony_tpu_torch.faults.partition import fault_connect, frame_dropped

        host, _, port = peer.rpartition(":")
        delay = 0.2
        while not self._stop.is_set():
            try:
                with fault_connect((host or "127.0.0.1", int(port)), role="halog.repl",
                                   timeout=self._connect_timeout) as sock:
                    set_nodelay(sock)
                    sock.settimeout(30.0)
                    hello = _recv_record(sock)
                    if hello is None:
                        raise OSError("receiver closed during hello")
                    last_seq = int(json.loads(hello.decode()).get("last_seq", 0))
                    with self._cond:
                        self._queues[peer].clear()
                        self._state[peer]["connected"] = True
                        self._state[peer]["resync"] = False
                    # catch-up: what the receiver is missing, framed from disk
                    sent = last_seq
                    for e in self.log.entries(since_seq=last_seq):
                        _send_record(sock, json.dumps(e, sort_keys=True,
                                                      default=repr).encode())
                        sent = int(e["seq"])
                    with self._cond:
                        self._state[peer]["sent_seq"] = sent
                    delay = 0.2
                    while not self._stop.is_set():
                        with self._cond:
                            while (not self._queues[peer] and not self._state[peer]["resync"]
                                   and not self._stop.is_set()):
                                self._cond.wait(timeout=1.0)
                            if self._state[peer]["resync"]:
                                raise OSError("replication backlog overflow")
                            batch = self._queues[peer][:]
                            self._queues[peer].clear()
                        for rec in batch:
                            if faults.armed() and frame_dropped(sock, role="halog.repl"):
                                continue
                            sock.sendall(rec)
                        if batch:
                            # the log's seq BEFORE the cond: append holds the
                            # log's lock while the sink takes the cond
                            last = self.log.last_seq
                            with self._cond:
                                self._state[peer]["sent_seq"] = last
            except (OSError, ValueError) as e:
                with self._cond:
                    if self._state[peer]["connected"]:
                        server_log.warning("halog replicator: peer %s dropped (%s); will "
                                           "catch up on reconnect", peer, e)
                    self._state[peer]["connected"] = False
                    self._state[peer]["reconnects"] += 1
                if self._stop.wait(delay):
                    return
                delay = min(delay * 2, 5.0)

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {p: dict(s) for p, s in self._state.items()}


class LogReceiver:
    """The standby's side: accept the leader's stream and append what it
    receives to the LOCAL durable log, so a takeover replays from this
    replica's own disk. Idempotent by seq (a catch-up overlap is skipped)
    and fenced (an entry below the local fence epoch is refused and
    counted). It binds the loopback interface, as the reference's does."""

    def __init__(self, log: DurableJobLog, port: int = 0) -> None:
        self.log = log
        self._port = port
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.port: Optional[int] = None
        self.received = 0
        self.rejected_stale = 0
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", self._port))
        sock.listen(4)
        sock.settimeout(1.0)
        self._sock = sock
        self.port = sock.getsockname()[1]
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name="halog-recv")
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._thread is not None:
            # the accept loop holds the port until it returns
            self._thread.join(timeout=3.0)
            self._thread = None

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except (OSError, AttributeError):
                return
            # one long-lived connection a leader epoch
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True,
                             name="halog-recv-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            try:
                set_nodelay(conn)
                conn.settimeout(60.0)
                _send_record(conn, json.dumps({"last_seq": self.log.last_seq}).encode())
                while not self._stop.is_set():
                    payload = _recv_record(conn)
                    if payload is None:
                        return
                    self._apply(json.loads(payload.decode()))
            except (OSError, ValueError) as e:
                if not self._stop.is_set():
                    server_log.warning("halog receiver: stream error (%s); awaiting "
                                       "reconnect", e)

    def _apply(self, entry: Dict[str, Any]) -> None:
        with self._lock:
            if int(entry.get("seq", 0)) <= self.log.last_seq:
                return  # a catch-up overlap
            try:
                fields = {k: v for k, v in entry.items()
                          if k not in ("seq", "epoch", "ts", "kind", "job")}
                self.log.append(entry["kind"], job_id=entry.get("job"),
                                epoch=int(entry.get("epoch", 0)), seq=int(entry["seq"]),
                                **fields)
                self.received += 1
            except StaleEpochError:
                self.rejected_stale += 1

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"port": self.port, "received": self.received,
                    "rejected_stale": self.rejected_stale, "last_seq": self.log.last_seq}


# -- replay --------------------------------------------------------------------


class ReplayState:
    """Control-plane state rebuilt from log entries (fenced): what a newly
    elected leader needs to re-arm the cluster."""

    def __init__(self) -> None:
        #: job -> its accepted JobConfig dict (kind="submission")
        self.submissions: Dict[str, Dict[str, Any]] = {}
        #: job -> its terminal entry (kind="job_done")
        self.done: Dict[str, Dict[str, Any]] = {}
        #: job -> the highest elastic attempt seen
        self.attempts: Dict[str, int] = {}
        #: job -> its newest committed chain entry (kind="chkp_chain")
        self.chains: Dict[str, str] = {}
        #: takeover history, oldest first
        self.takeovers: List[Dict[str, Any]] = []
        #: incident id -> its newest transition (kind="incident"); kept so
        #: the replay is the reference's, though the port has no incident
        #: engine to adopt them yet (ROADMAP A item 6)
        self.incidents: Dict[str, Dict[str, Any]] = {}
        self.max_epoch = 0
        self.max_seq = 0
        #: deposed-leader writes rejected during replay
        self.rejected_stale = 0
        self.entries_applied = 0

    @classmethod
    def from_entries(cls, entries: List[Dict[str, Any]]) -> "ReplayState":
        st = cls()
        for e in sorted(entries, key=lambda e: int(e.get("seq", 0))):
            ep = int(e.get("epoch", 0))
            if ep < st.max_epoch:
                st.rejected_stale += 1
                continue  # fenced: a deposed leader's late write
            st.max_epoch = ep
            st.max_seq = max(st.max_seq, int(e.get("seq", 0)))
            st.entries_applied += 1
            kind = e.get("kind")
            job = e.get("job")
            if kind == "submission" and job:
                st.submissions[job] = e.get("config") or {}
                # a resubmission of a finished id is a new lifecycle
                st.done.pop(job, None)
            elif kind == "job_done" and job:
                st.done[job] = e
            elif kind == "chkp_chain" and job and e.get("chkp_id"):
                st.chains[job] = str(e["chkp_id"])
            elif kind == "leader_takeover":
                st.takeovers.append(e)
            elif kind == "incident" and e.get("incident_id"):
                st.incidents[str(e["incident_id"])] = e
            if job and "attempt" in e:
                try:
                    st.attempts[job] = max(st.attempts.get(job, 0), int(e["attempt"]))
                except (TypeError, ValueError):
                    pass
        return st

    def in_flight(self) -> List[str]:
        """Submissions accepted but never completed: what a takeover
        re-arms, in the order they were accepted."""
        return [j for j in self.submissions if j not in self.done]

    def to_dict(self) -> Dict[str, Any]:
        return {"submissions": len(self.submissions), "in_flight": self.in_flight(),
                "done": len(self.done), "chains": len(self.chains),
                "takeovers": len(self.takeovers), "incidents": len(self.incidents),
                "max_epoch": self.max_epoch, "max_seq": self.max_seq,
                "rejected_stale": self.rejected_stale}


def replay_file(path: str) -> ReplayState:
    entries, _good, _torn = scan_records(path)
    return ReplayState.from_entries(entries)
