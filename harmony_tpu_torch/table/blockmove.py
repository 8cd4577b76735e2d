"""Block-granular migration of a table: between the slots of one process, and
between the processes of a pod.

Counterpart of ``harmony_tpu/table/blockmove.py``. The reference moves N
blocks point-to-point between executors at a cost proportional to the bytes
moved (its MigrationExecutor and ``AllocatedTable.moveBlocks``): the move
PLAN, which block travels from whom to whom, is a pure function of (old
sharding, new sharding), and only the blocks that leave their holder travel.

A sharding is a ``table/table.py::BlockSharding`` over slots
(``parallel/mesh.py``). :func:`migrate_blocks` rebuilds a table's storage on
the new sharding by one of two routes, chosen from the two meshes alone.

In one process (every slot of both meshes lies here), planned by slot index:

  * a slot whose block range is unchanged keeps its shard tensor as it is:
    nothing is copied;
  * a slot whose range changed gets a new shard: the blocks it already held
    are copied on its own device, and each block it lacks is copied from the
    block's owner in the old layout (the lowest slot index holding it,
    :func:`block_owners`), device to device, one copy for each contiguous run
    of blocks with one source (:func:`_contiguous_runs`).

Between processes (the two meshes' slots lie in two or more processes),
planned by process (``unit=_process_of``), as the reference's:

  * only the blocks LEAVING a process go to the host, one copy for each
    contiguous run of them in a source shard;
  * they travel point-to-point, over TCP (:func:`_tcp_exchange`: each
    receiver listens on a port of its own and publishes its address in the
    pod's ``torch.distributed`` store, ``parallel/multihost.py::store``; a
    sender sends one framed stream a destination, striped over up to
    ``HARMONY_MOVE_PARALLEL`` streams once a leg passes 16 MiB) or through
    files under a stage root every process sees (:func:`_file_exchange`:
    each block written once and renamed into place; fences over the union's
    processes order the writes before the reads and the reads before the
    staging is removed). ``HARMONY_POD_BLOCKMOVE=tcp|file`` forces one;
    ``auto`` takes tcp exactly when the pod's store exists, a fact every
    process sees alike. A leg retries under ``RetryPolicy.from_env()`` and
    gives up with :class:`MigrationTransportError` within
    ``HARMONY_POD_MOVE_TIMEOUT`` seconds (120); nothing falls back to the
    other transport;
  * each process rebuilds only its OWN new shards: blocks it held are copied
    on the card, received ones go to the card one copy a contiguous run,
    under the destination's device guard. No process holds the whole table.
    A process that holds no slot of the new mesh keeps an empty
    ``ShardedArray``; one that held no slot of the old takes part all the
    same.

Every process of the two meshes calls :func:`migrate_blocks` at the same
logical point (a pod job's plan at the chief's epoch hook, inside a pod
unit: ``jobserver/pod.py``). The rendezvous keys and the staging directory
are named by the union's processes and the count of moves over that union
in this process (:func:`_next_seq`), which its members count alike; the
reference counts every move of a process, which moves over two different
process sets would set apart.

The frame codec (:func:`_frame_parts`, :func:`_unpack_frame`) writes the
reference's frames byte for byte, torch's bfloat16 under the name
``"bfloat16"`` as the reference writes its extension dtypes, so a frame
crosses the packages in both directions. A hash table's (slot_keys, values)
pair moves in one exchange, frame for frame: part ``k`` of block ``b`` is
frame ``b * 2 + k`` (a dense table's frame ``b`` is block ``b``).

Every copy is enqueued on the current streams, under the destination's device
guard; the caller (``DenseTable.reshard``, ``DeviceHashTable.reshard``) holds
the table lock and has ordered those streams after the table's last writes
and reads. Each old shard is marked as used by its device's current stream,
so the caching allocator does not hand its memory out while a copy reads it.

The planner functions (:func:`axis0_bounds`, :func:`process_blocks`,
:func:`block_owners`, :func:`plan_moves`) take anything with the reference's
``devices_indices_map(shape)`` (``BlockSharding`` has one) and group by
``unit(device)``: a device's ``process_index`` by default, as in the
reference.

Every move is counted in the process's metric registry (``metrics/
registry.py``), on both routes: :func:`_record_move_metrics` adds to
``harmony_blockmove_migrations_total``, ``_sent_blocks_total`` and
``_sent_bytes_total`` (labelled by ``transport``: ``tcp`` or ``file``
between processes, where a process counts what it sent; ``device`` in one
process, where the blocks copied from another slot count) and
``_transport_retries_total``, and observes ``harmony_blockmove_transfer_bytes``;
``harmony_move_leg_seconds{transport}`` times each leg (a TCP stream, a
staged block's write or read, or the rebuild of one process's storage). The
blocks counter is the port's own; the reference counts bytes only.

Left out: the fault-injection sites (``faults.site("blockmove.exchange")``
and the legs' sites, ROADMAP A item 7).
"""
from __future__ import annotations

import contextlib
import datetime
import itertools
import json
import os
import shutil
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from harmony_tpu_torch.faults.retry import InfraTransientError, RetryError, call_with_retry
from harmony_tpu_torch.parallel.mesh import is_local, this_process
from harmony_tpu_torch.tracing.span import trace_span
from harmony_tpu_torch.utils import framing as _framing

# Telemetry of the most recent migrate_blocks call in this process.
last_move_stats: Dict[str, Any] = {}

# The CUDA events around the last cross-process move's copies to the host
# ("off") and onto the cards ("on"), read by last_move_device_ms.
_LAST_EVENTS: Dict[str, List[Tuple[Any, Any]]] = {"off": [], "on": []}

# union of processes -> the count of moves over it in this process
_MOVE_SEQ: Dict[Tuple[int, ...], "itertools.count[int]"] = {}
_SEQ_LOCK = threading.Lock()

#: A leg carrying more than this splits into several framed streams when
#: the pool has spare parallelism; the receiver keys frames by id, so
#: streams to one destination are order-free.
_LEG_SPLIT_BYTES = 16 << 20


def _observe_leg_seconds(transport: str, seconds: float) -> None:
    """harmony_move_leg_seconds{transport}: per-leg transfer latency.
    Best-effort: observability never fails a migration."""
    try:
        from harmony_tpu_torch.metrics.registry import get_registry

        get_registry().histogram(
            "harmony_move_leg_seconds",
            "Block-migration transport leg latency",
            ("transport",),
        ).labels(transport=transport).observe(seconds)
    except Exception:
        pass


def _record_move_metrics(transport: str, blocks: int, nbytes: int, retries: int) -> None:
    """Fold one migration into the process's registry: cumulative counters
    (unlike the per-move :data:`last_move_stats`, these stay monotone for
    scrapers) plus the fixed-boundary transfer-size histogram."""
    try:
        from harmony_tpu_torch.metrics.registry import (
            TRANSFER_SIZE_BUCKETS,
            get_registry,
        )

        reg = get_registry()
        reg.counter(
            "harmony_blockmove_migrations_total",
            "Completed block migrations", ("transport",),
        ).labels(transport=transport).inc()
        reg.counter(
            "harmony_blockmove_sent_blocks_total",
            "Blocks this process transmitted across block migrations",
            ("transport",),
        ).labels(transport=transport).inc(int(blocks))
        reg.counter(
            "harmony_blockmove_sent_bytes_total",
            "Bytes this process transmitted across block migrations",
            ("transport",),
        ).labels(transport=transport).inc(int(nbytes))
        reg.counter(
            "harmony_blockmove_transport_retries_total",
            "Transport legs re-attempted under the retry policy",
        ).inc(int(retries))
        reg.histogram(
            "harmony_blockmove_transfer_bytes",
            "Per-migration bytes transmitted by this process",
            buckets=TRANSFER_SIZE_BUCKETS,
        ).observe(float(nbytes))
    except Exception:
        pass  # observability must never fail a migration


class MigrationTransportError(InfraTransientError):
    """A block-migration transport leg gave up after bounded retries (the
    transport died, not the job's own logic)."""


def _retry_policy():
    from harmony_tpu_torch.config.params import RetryPolicy

    return RetryPolicy.from_env()


def _move_timeout() -> float:
    return float(os.environ.get("HARMONY_POD_MOVE_TIMEOUT", "120"))


def _stage_root() -> str:
    """Where the file transport stages: ``HARMONY_POD_STAGE_ROOT``, else
    ``HARMONY_POD_CHKP_ROOT``, else the host's temporary directory (the
    processes of one host share it)."""
    import tempfile

    return (os.environ.get("HARMONY_POD_STAGE_ROOT")
            or os.environ.get("HARMONY_POD_CHKP_ROOT")
            or tempfile.gettempdir())


def _transport_mode() -> str:
    """tcp | file, the same in every process: ``HARMONY_POD_BLOCKMOVE``
    forces it; auto takes tcp exactly when the pod's store exists."""
    from harmony_tpu_torch.parallel import multihost

    forced = os.environ.get("HARMONY_POD_BLOCKMOVE", "auto").lower()
    if forced in ("tcp", "file"):
        return forced
    return "tcp" if multihost.store() is not None else "file"


def _move_parallel() -> int:
    """Concurrent transport legs (``HARMONY_MOVE_PARALLEL``; 1 is serial)."""
    try:
        return max(1, int(os.environ.get("HARMONY_MOVE_PARALLEL", "4")))
    except ValueError:
        return 4


def _next_seq(union: Tuple[int, ...]) -> int:
    with _SEQ_LOCK:
        return next(_MOVE_SEQ.setdefault(union, itertools.count()))


# -- the move plan -------------------------------------------------------


def _process_of(d) -> int:
    return d.process_index


def _slot_index(s) -> int:
    return s.index


def axis0_bounds(idx: Tuple, nb: int) -> Tuple[int, int]:
    sl = idx[0] if idx else slice(None)
    return sl.start or 0, nb if sl.stop is None else sl.stop


def process_blocks(sharding, shape: Tuple[int, ...],
                   unit: Callable[[Any], int] = _process_of) -> Dict[int, Set[int]]:
    """unit -> set of blocks that unit holds (any of its devices holds a
    copy). Block == index along axis 0; table shardings only ever partition
    axis 0 (table.block_sharding)."""
    nb = shape[0]
    out: Dict[int, Set[int]] = {}
    for d, idx in sharding.devices_indices_map(shape).items():
        start, stop = axis0_bounds(idx, nb)
        out.setdefault(unit(d), set()).update(range(start, stop))
    return out


def block_owners(sharding, shape: Tuple[int, ...],
                 unit: Callable[[Any], int] = _process_of) -> Dict[int, int]:
    """block -> owning unit, deduped by the lowest-owner rule (the same rule
    the reference's owned_addressable_blocks uses, so checkpoint staging and
    migration sourcing agree on who holds the authoritative copy)."""
    owners: Dict[int, int] = {}
    for pid, blocks in process_blocks(sharding, shape, unit).items():
        for b in blocks:
            if owners.get(b, pid + 1) > pid:
                owners[b] = pid
    return owners


class MovePlan:
    """The deterministic exchange: ``sends[src]`` is the sorted list of
    (block, dst) pairs src must transmit; ``recvs[dst]`` the set of blocks
    dst will receive. Computed from the two shardings alone."""

    __slots__ = ("sends", "recvs", "block_nbytes")

    def __init__(self, sends: Dict[int, List[Tuple[int, int]]],
                 recvs: Dict[int, Set[int]], block_nbytes: int) -> None:
        self.sends = sends
        self.recvs = recvs
        self.block_nbytes = block_nbytes

    @property
    def total_moves(self) -> int:
        return sum(len(v) for v in self.sends.values())


def plan_moves(old_sharding, new_sharding, shape: Tuple[int, ...], itemsize: int,
               unit: Callable[[Any], int] = _process_of) -> MovePlan:
    old_blocks = process_blocks(old_sharding, shape, unit)
    new_blocks = process_blocks(new_sharding, shape, unit)
    owners = block_owners(old_sharding, shape, unit)
    sends: Dict[int, List[Tuple[int, int]]] = {}
    recvs: Dict[int, Set[int]] = {}
    for pid, need in sorted(new_blocks.items()):
        missing = need - old_blocks.get(pid, set())
        for b in sorted(missing):
            src = owners.get(b)
            if src is None:
                raise ValueError(
                    f"block {b} has no owner in the old layout — the old "
                    "sharding does not cover the table"
                )
            sends.setdefault(src, []).append((b, pid))
            recvs.setdefault(pid, set()).add(b)
    for v in sends.values():
        v.sort()
    block_nbytes = itemsize * int(np.prod(shape[1:])) if len(shape) > 1 else itemsize
    return MovePlan(sends, recvs, block_nbytes)


# -- the frame codec -----------------------------------------------------


def _dtype_tag(t: torch.Tensor) -> str:
    """The reference's header dtype: ``dtype.str`` (byte order included),
    and the name for bfloat16 (an extension dtype there)."""
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return torch.empty(0, dtype=t.dtype).numpy().dtype.str


def _frame_parts(block: int, arr) -> Tuple[bytes, Any]:
    """One wire/disk frame as (length-prefixed JSON header, payload buffer):
    the reference's frame for a host array or a tensor (copied to the host
    when it lies on a card). The payload is a zero-copy view of a host
    array's bytes."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        tag = _dtype_tag(t)
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        payload = raw.numpy()
        shape, nbytes = list(t.shape), t.numel() * t.element_size()
    else:
        payload = np.ascontiguousarray(arr)
        dt = payload.dtype
        tag = dt.name if dt.kind == "V" else dt.str
        shape, nbytes = list(payload.shape), int(payload.nbytes)
    header = json.dumps({
        "b": int(block), "dtype": tag, "shape": shape, "n": int(nbytes),
    }).encode()
    try:
        body: Any = memoryview(payload).cast("B")
    except (TypeError, ValueError):
        body = payload.tobytes()
    return struct.pack("<I", len(header)) + header, body


def _decode(hdr: Dict[str, Any], data) -> torch.Tensor:
    """A frame's payload as a tensor: a ``"bfloat16"`` frame as bfloat16,
    any other in native byte order."""
    if hdr["dtype"] == "bfloat16":
        t = torch.frombuffer(bytearray(data), dtype=torch.int16).view(torch.bfloat16)
    else:
        dt = np.dtype(hdr["dtype"])
        arr = np.frombuffer(data, dtype=dt)
        if not dt.isnative:
            arr = arr.astype(dt.newbyteorder("="))
        elif not isinstance(data, bytearray):
            arr = arr.copy()   # a read-only buffer: torch wants a writable one
        t = torch.from_numpy(arr)
    return t.reshape(hdr["shape"])


def _unpack_frame(buf: bytes) -> Tuple[int, torch.Tensor]:
    """Decode one whole frame (the concatenation of both :func:`_frame_parts`
    halves) into (block, tensor): the file transport's read side."""
    if len(buf) < 4:
        raise OSError("truncated block frame (no header length)")
    hlen = struct.unpack("<I", buf[:4])[0]
    if len(buf) < 4 + hlen:
        raise OSError("truncated block frame (short header)")
    hdr = json.loads(bytes(buf[4:4 + hlen]))
    data = buf[4 + hlen:]
    if len(data) != hdr["n"]:
        raise OSError(
            f"truncated block frame for block {hdr['b']}: "
            f"{len(data)} of {hdr['n']} payload bytes")
    return int(hdr["b"]), _decode(hdr, data)


def _send_frame(sock: socket.socket, block: int, arr) -> None:
    """One block frame, one write (``utils/framing.py``)."""
    head, body = _frame_parts(block, arr)
    _framing.send_frame_parts(sock, head, (body,), role="blockmove")


def _read_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    """Exactly ``n`` bytes (``utils/framing.read_exact``), None on EOF."""
    return _framing.read_exact(sock, n)


# -- the TCP transport -----------------------------------------------------


def _my_host() -> str:
    """The address peers connect to: ``HARMONY_POD_DCN_HOST``, else the
    interface that routes to the pod's coordinator (a UDP socket's connect
    sends nothing, it resolves the route), which is loopback for a pod on
    one host or on a file store."""
    from harmony_tpu_torch.parallel import multihost

    host = os.environ.get("HARMONY_POD_DCN_HOST")
    if host:
        return host
    coord = multihost.coordinator_host()
    if coord is None or coord in ("127.0.0.1", "localhost", "::1"):
        return "127.0.0.1"
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect((coord, 1))
            return s.getsockname()[0]
    except OSError:
        return socket.gethostbyname(socket.gethostname())


class _TcpReceiver:
    """Background accept loop collecting exactly the expected frames (a
    frame id each). Started, and its address published, before any process
    begins sending, so a published address implies a live listener."""

    #: after a connection error, how long wait() lets the sender's retried
    #: resend land before giving up (the sender's backoff tops out at
    #: HARMONY_RETRY_MAX_DELAY, 2 s by default)
    ERR_GRACE = 10.0

    def __init__(self, expected: Set[int]) -> None:
        self.expected = set(expected)
        self.blocks: Dict[int, torch.Tensor] = {}
        self._done = threading.Event()
        self._err: Optional[BaseException] = None
        self._err_time = 0.0
        self._frames = 0       # every frame received, resends included
        self._err_frames = -1
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("", 0))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        if not self.expected:
            self._done.set()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name="blockmove-accept")
        self._thread.start()

    def _accept_loop(self) -> None:
        self._srv.settimeout(0.5)
        drains: List[threading.Thread] = []
        try:
            while not self._done.is_set():
                try:
                    conn, _ = self._srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return  # listener closed
                # one thread a sending stream: bounded by the pod's size
                t = threading.Thread(target=self._drain, args=(conn,), daemon=True,
                                     name="blockmove-drain")
                t.start()
                drains.append(t)
        finally:
            for t in drains:
                t.join(timeout=1.0)

    def _drain(self, conn: socket.socket) -> None:
        try:
            with conn:
                _framing.set_nodelay(conn)
                while True:
                    raw = _read_exact(conn, 4)
                    if raw is None:
                        return  # the sender closed cleanly
                    head = _read_exact(conn, struct.unpack("<I", raw)[0])
                    if head is None:
                        raise OSError("truncated block frame header")
                    hdr = json.loads(bytes(head))
                    data = _read_exact(conn, hdr["n"])
                    if data is None:
                        raise OSError(f"truncated block {hdr['b']}")
                    t = _decode(hdr, data)
                    with self._lock:
                        self.blocks[int(hdr["b"])] = t
                        self._frames += 1
                        if self.expected <= set(self.blocks):
                            self._done.set()
        except BaseException as e:  # noqa: BLE001 - surfaced in wait()
            # a broken connection is not a broken move: the sender resends
            # the whole leg on a fresh one, and frames that landed are
            # overwritten by identical bytes
            with self._lock:
                self._err = e
                self._err_time = time.monotonic()
                self._err_frames = self._frames

    def wait(self, deadline: float) -> Dict[int, torch.Tensor]:
        """Block until every expected frame is in. A recorded stream error
        fails the wait after ERR_GRACE with no progress; the deadline fails
        it naming the missing frames."""
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            if self._done.wait(timeout=min(0.5, remaining)):
                return self.blocks
            with self._lock:
                err, err_t = self._err, self._err_time
                if err is not None and self._frames != self._err_frames:
                    # a resend is landing: an active recovery is never cut
                    self._err_time = err_t = time.monotonic()
                    self._err_frames = self._frames
            if err is not None and time.monotonic() - err_t > self.ERR_GRACE:
                raise err
        missing = sorted(self.expected - set(self.blocks))
        detail = f"; last connection error: {self._err!r}" if self._err is not None else ""
        raise TimeoutError(
            f"block migration: {len(missing)} inbound blocks missing after "
            f"{_move_timeout()}s (first: {missing[:8]}) — a source process died "
            f"or the channel is unreachable{detail}")

    def close(self) -> None:
        self._done.set()
        try:
            self._srv.close()
        except OSError:
            pass


class _PoolStopped(Exception):
    """A queued leg skipped because a sibling already failed (never
    surfaced: the sibling's own error is raised)."""


def _run_pooled(items: Sequence[Any], fn, parallel: int, label: str) -> List[Any]:
    """``fn(item)`` for every item, in item order when ``parallel`` is 1,
    else on a bounded pool; results in item order, the first failure (by
    item order) raised, and queued items skipped once one has failed."""
    if parallel <= 1 or len(items) <= 1:
        return [fn(it) for it in items]
    from concurrent.futures import ThreadPoolExecutor

    stop = threading.Event()

    def guarded(it):
        if stop.is_set():
            raise _PoolStopped()
        try:
            return fn(it)
        except BaseException:
            stop.set()
            raise

    with ThreadPoolExecutor(max_workers=min(parallel, len(items)),
                            thread_name_prefix=label) as pool:
        futs = [pool.submit(guarded, it) for it in items]
        out: List[Any] = []
        first_err: Optional[BaseException] = None
        for f in futs:
            try:
                out.append(f.result())
            except _PoolStopped:
                pass
            except BaseException as e:  # noqa: BLE001 - raised below
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return out


def _leg_streams(by_dst: Dict[int, List[int]], nbytes: Dict[int, int],
                 parallel: int) -> List[Tuple[int, List[int]]]:
    """The exchange's work list: ``(dst, frame ids)`` a framed stream, in a
    fixed order: one stream a destination, or, with spare parallelism, a leg
    over ``_LEG_SPLIT_BYTES`` striped round-robin over up to ``parallel``
    streams of at least that many bytes each."""
    legs: List[Tuple[int, List[int]]] = []
    for dst in sorted(by_dst):
        frames = by_dst[dst]
        nstreams = 1
        if parallel > 1:
            total = sum(nbytes[f] for f in frames)
            nstreams = max(1, min(parallel, len(frames), int(total // _LEG_SPLIT_BYTES)))
        for i in range(nstreams):
            stripe = frames[i::nstreams]
            if stripe:
                legs.append((dst, stripe))
    return legs


def _store_get(store, key: str, deadline: float) -> str:
    """``key``'s value once it is set, waiting until ``deadline``; a
    TimeoutError (retryable) past it."""
    remaining = max(0.001, deadline - time.monotonic())
    try:
        store.wait([key], datetime.timedelta(seconds=remaining))
    except RuntimeError as e:
        raise TimeoutError(f"no receiver address under {key}: {e}") from None
    return store.get(key).decode()


def _tcp_exchange(plan: MovePlan, outgoing: Dict[int, torch.Tensor],
                  expected: Set[int], tag: str, legs_out: List[Dict[str, Any]],
                  retries: List[int]) -> Tuple[Dict[int, torch.Tensor], int]:
    """This process's legs over TCP, concurrently across destinations on a
    bounded pool. ``outgoing`` maps frame id -> host tensor for every frame
    this process sends, ``expected`` the frames it receives. Returns (the
    received frames, the wire bytes sent: counted by leg, so a block sent to
    two processes counts twice)."""
    from harmony_tpu_torch.parallel import multihost

    store = multihost.store()
    if store is None:
        raise RuntimeError(
            "the tcp block transport needs the pod's store "
            "(parallel/multihost.initialize_distributed); set "
            "HARMONY_POD_BLOCKMOVE=file for the staged-file transport")
    pid = this_process()
    deadline = time.monotonic() + _move_timeout()
    receiver = _TcpReceiver(expected) if expected else None
    key = f"harmony/blockmove/{tag}/{pid}"
    if receiver is not None:
        store.set(key, f"{_my_host()}:{receiver.port}")
    try:
        by_dst: Dict[int, List[int]] = {}
        for f, dst in sorted(plan.sends.get(pid, [])):
            by_dst.setdefault(dst, []).append(f)
        parallel = _move_parallel()
        sizes = {f: t.numel() * t.element_size() for f, t in outgoing.items()}
        lock = threading.Lock()
        policy = _retry_policy()
        # every destination's address, read on this thread before any leg
        # starts: the legs' threads never share the store's client
        addrs = {dst: _store_get(store, f"harmony/blockmove/{tag}/{dst}", deadline).rsplit(":", 1)
                 for dst in sorted(by_dst)}

        def run_leg(leg: Tuple[int, List[int]]) -> None:
            dst, frames = leg
            t0 = time.perf_counter()

            def attempt():
                # the whole leg retries on a fresh connection; the receiver
                # keys frames by id, so a resend overwrites what landed
                host, port = addrs[dst]
                with socket.create_connection(
                        (host, int(port)),
                        timeout=max(0.1, deadline - time.monotonic())) as sock:
                    _framing.set_nodelay(sock)
                    for f in frames:
                        _send_frame(sock, f, outgoing[f])

            def on_retry(attempt_no, err):
                with lock:
                    retries[0] += 1

            try:
                call_with_retry(attempt, policy, op="blockmove.send", on_retry=on_retry,
                                deadline=deadline)
            except RetryError as e:
                raise MigrationTransportError(
                    f"block migration to process {dst} (frames {frames[:8]}...) "
                    f"failed: {e}") from e
            dt = time.perf_counter() - t0
            _observe_leg_seconds("tcp", dt)
            with lock:
                legs_out.append({"dst": dst, "frames": len(frames),
                                 "bytes": sum(sizes[f] for f in frames),
                                 "seconds": dt})

        _run_pooled(_leg_streams(by_dst, sizes, parallel), run_leg, parallel, "blockmove-leg")
        sent = sum(leg["bytes"] for leg in legs_out)
        if receiver is None:
            return {}, sent
        try:
            return receiver.wait(deadline), sent
        except (OSError, ValueError, TypeError, KeyError) as e:
            # a timeout, a truncated stream or a garbled header: the inbound
            # leg failed, as infra-shaped as a send that gave up
            raise MigrationTransportError(f"block migration inbound leg failed: {e}") from e
    finally:
        if receiver is not None:
            receiver.close()
            try:
                store.delete_key(key)
            except Exception:  # noqa: BLE001 - a leftover key names a finished move
                pass


# -- the staged-file transport ----------------------------------------------


def _fence(union: Tuple[int, ...], failed: bool) -> int:
    """How many of the union's processes failed; returns once every one of
    them has called (the union's barrier)."""
    from harmony_tpu_torch.parallel.collectives import process_all_gather

    parts = process_all_gather(torch.tensor([1.0 if failed else 0.0], dtype=torch.float64),
                               union)
    return int(sum(float(p[0]) for p in parts))


def _file_exchange(plan: MovePlan, outgoing: Dict[int, torch.Tensor],
                   expected: Set[int], tag: str, union: Tuple[int, ...],
                   retries: List[int]) -> Tuple[Dict[int, torch.Tensor], int]:
    """Per-frame staged files under the stage root: each source writes only
    the frames leaving it (write, then rename into place), a fence over the
    union orders the writes before the reads, each receiver reads only its
    frames, and a second fence lets the union's lowest process remove the
    staging. Each frame is written once, however many processes read it.
    The fences carry failures, so every process raises alike. Two pods must
    not share a stage root. Returns (the received frames, bytes written)."""
    pid = this_process()
    stage = os.path.join(_stage_root(), f"harmony-move-{tag}")
    err: Optional[BaseException] = None
    mine = sorted(outgoing)
    written = 0
    policy = _retry_policy()
    parallel = _move_parallel()
    lock = threading.Lock()

    def on_retry(attempt_no, err_):
        with lock:
            retries[0] += 1

    if mine:
        try:
            os.makedirs(stage, exist_ok=True)

            def stage_one(f: int) -> int:
                tmp = os.path.join(stage, f"b{f}.blk.writing-{pid}")
                dst = os.path.join(stage, f"b{f}.blk")
                # a crashed earlier move may have left either name: a
                # reader must never take a stale payload (only f's source
                # touches f's paths before the first fence)
                for stale in (tmp, dst):
                    try:
                        os.unlink(stale)
                    except FileNotFoundError:
                        pass

                def write_block():
                    head, body = _frame_parts(f, outgoing[f])
                    with open(tmp, "wb") as fh:
                        fh.write(head)
                        fh.write(body)
                    os.rename(tmp, dst)

                t0 = time.perf_counter()
                try:
                    call_with_retry(write_block, policy, op="blockmove.stage_write",
                                    on_retry=on_retry)
                except RetryError as e:
                    raise MigrationTransportError(
                        f"staging block frame {f} under {stage} failed: {e}") from e
                _observe_leg_seconds("file", time.perf_counter() - t0)
                return outgoing[f].numel() * outgoing[f].element_size()

            written = sum(_run_pooled(mine, stage_one, parallel, "blockmove-stage"))
        except BaseException as e:  # noqa: BLE001 - reported through the fence
            err = e
    if _fence(union, err is not None):
        if pid == union[0]:
            shutil.rmtree(stage, ignore_errors=True)
        if err is not None:
            raise err
        raise MigrationTransportError(
            f"block migration staging failed on a source process (stage {stage})")
    received: Dict[int, torch.Tensor] = {}
    try:
        def fetch_one(f: int) -> Tuple[int, torch.Tensor]:
            def read_block():
                with open(os.path.join(stage, f"b{f}.blk"), "rb") as fh:
                    fid, t = _unpack_frame(fh.read())
                if fid != f:
                    raise OSError(f"staged frame b{f}.blk names frame {fid}")
                return t

            t0 = time.perf_counter()
            try:
                t = call_with_retry(read_block, policy, op="blockmove.stage_read",
                                    on_retry=on_retry)
                _observe_leg_seconds("file", time.perf_counter() - t0)
                return f, t
            except RetryError as e:
                raise MigrationTransportError(
                    f"reading staged block frame {f} under {stage} failed: {e}") from e

        received = dict(_run_pooled(sorted(expected), fetch_one, parallel, "blockmove-fetch"))
    except BaseException as e:  # noqa: BLE001 - reported through the fence
        err = e
    failures = _fence(union, err is not None)
    if pid == union[0]:
        shutil.rmtree(stage, ignore_errors=True)
    if failures:
        if err is not None:
            raise err
        raise MigrationTransportError(
            f"block migration staging read failed on a receiving process (stage {stage})")
    return received, written


# -- the migration -------------------------------------------------------


def _contiguous_runs(blocks: Sequence[int]) -> List[Tuple[int, int]]:
    """Sorted block ids -> [start, stop) runs."""
    runs: List[Tuple[int, int]] = []
    for b in sorted(blocks):
        if runs and runs[-1][1] == b:
            runs[-1] = (runs[-1][0], b + 1)
        else:
            runs.append((b, b + 1))
    return runs


def _as_shards(storage, sharding) -> Tuple[Dict[Any, Tuple[torch.Tensor, ...]], bool]:
    """The storage as slot -> tuple of part tensors (a dense table's one part,
    a hash table's slot keys and values), this process's slots only, and
    whether it is a tuple (False when this process holds none)."""
    from harmony_tpu_torch.table.table import ShardedArray

    if isinstance(storage, ShardedArray):
        shards = storage.shards
        if not shards:
            return {}, False
        paired = isinstance(next(iter(shards.values())), tuple)
        return {s: (t if paired else (t,)) for s, t in shards.items()}, paired
    paired = isinstance(storage, tuple)
    (slot,) = sharding.mesh.slots
    return {slot: tuple(storage) if paired else (storage,)}, paired


def _guard(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _copy_run(dst: torch.Tensor, at: int, src: torch.Tensor, lo: int, n: int) -> None:
    """dst[at:at+n] = src[lo:lo+n], enqueued under dst's device guard."""
    with _guard(dst.device):
        dst[at:at + n].copy_(src[lo:lo + n], non_blocking=True)


def _event_pair(device: torch.device, kind: str):
    """A (start, end) pair of CUDA events kept for last_move_device_ms, or
    None off the card."""
    if device.type != "cuda":
        return None
    pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    _LAST_EVENTS[kind].append(pair)
    return pair


def last_move_device_ms() -> Dict[str, float]:
    """The device milliseconds of the last cross-process move's copies to
    the host (``copy_off_ms``) and onto the cards (``copy_on_ms``), summed
    over its runs; waits for those copies. Zeros off the card."""
    out = {}
    for kind in ("off", "on"):
        total = 0.0
        for start, end in _LAST_EVENTS[kind]:
            end.synchronize()
            total += start.elapsed_time(end)
        out[f"copy_{kind}_ms"] = total
    return out


def spans_processes(old_sharding, new_sharding) -> bool:
    """True when a move from ``old_sharding`` to ``new_sharding`` involves
    two or more processes: the route of :func:`migrate_blocks`."""
    return len(set(old_sharding.mesh.processes) | set(new_sharding.mesh.processes)) > 1


def migrate_blocks(storage, old_sharding, new_sharding, like=None):
    """``storage`` (a tensor, a hash table's (slot_keys, values) pair, or a
    ``ShardedArray`` of either) rebuilt on ``new_sharding``: the same kind,
    a ``ShardedArray`` over a mesh of several slots, or one with no shards in
    a process that holds no slot of the new mesh. ``like`` is the storage's
    parts as ((block shape, dtype), ...), needed where this process holds
    none of the old storage. See the module doc."""
    from harmony_tpu_torch.table.table import ShardedArray

    if (isinstance(storage, ShardedArray) and not storage.shards
            and this_process() not in new_sharding.mesh.processes):
        # a process of neither mesh: it held nothing and holds nothing
        return ShardedArray(new_sharding, {})
    with trace_span("blockmove.migrate") as sp:
        st = last_move_stats
        if spans_processes(old_sharding, new_sharding):
            out = _migrate_across_processes(storage, old_sharding, new_sharding, like)
            keys = ("seq", "transport", "blocks_sent", "bytes_sent", "blocks_received",
                    "transport_retries")
            _record_move_metrics(st["transport"], st["blocks_sent"], st["bytes_sent"],
                                 st["transport_retries"])
        else:
            out = _migrate_in_process(storage, old_sharding, new_sharding)
            keys = ("blocks_moved", "bytes_moved", "blocks_copied_locally", "shards_reused")
            _observe_leg_seconds("device", st["seconds"])
            _record_move_metrics("device", st["blocks_moved"], st["bytes_moved"], 0)
        if sp is not None:
            for k in keys:
                sp.annotate(k, last_move_stats.get(k))
        return out


def _migrate_in_process(storage, old_sharding, new_sharding):
    from harmony_tpu_torch.table.table import ShardedArray

    t0 = time.perf_counter()
    old, paired = _as_shards(storage, old_sharding)
    first = next(iter(old.values()))
    nb = old_sharding.num_blocks
    block_bytes = sum(p[0].numel() * p.element_size() for p in first) if nb else 0
    plan = plan_moves(old_sharding, new_sharding, (nb,), 1, unit=_slot_index)
    owners = block_owners(old_sharding, (nb,), unit=_slot_index)
    by_index = {s.index: (s, parts) for s, parts in old.items()}
    new: Dict[Any, Tuple[torch.Tensor, ...]] = {}
    kept = reused = 0
    for slot in new_sharding.mesh.slots:
        want = new_sharding.slot_blocks(slot)
        mine = old.get(slot)
        have = old_sharding.slot_blocks(slot) if mine is not None else range(0)
        if mine is not None and have == want:
            new[slot] = mine          # its blocks stay in place
            reused += 1
            continue
        parts = tuple(torch.empty((len(want), *p.shape[1:]), dtype=p.dtype,
                                  device=slot.device) for p in first)
        local = [b for b in want if b in have]
        for a, z in _contiguous_runs(local):
            for dst, src in zip(parts, mine):
                _copy_run(dst, a - want.start, src, a - have.start, z - a)
        kept += len(local)
        recv = plan.recvs.get(slot.index, set())
        by_src: Dict[int, List[int]] = {}
        for b in recv:
            by_src.setdefault(owners[b], []).append(b)
        for src_index, blocks in sorted(by_src.items()):
            src_slot, src_parts = by_index[src_index]
            base = old_sharding.slot_blocks(src_slot).start
            for a, z in _contiguous_runs(blocks):
                for dst, src in zip(parts, src_parts):
                    _copy_run(dst, a - want.start, src, a - base, z - a)
        new[slot] = parts
    _release_old(old, new)
    last_move_stats.clear()
    last_move_stats.update({
        "blocks_moved": plan.total_moves,
        "bytes_moved": plan.total_moves * block_bytes,
        "blocks_copied_locally": kept,
        "shards_reused": reused,
        "block_nbytes": block_bytes,
        "seconds": time.perf_counter() - t0,
    })
    shards = {s: (p if paired else p[0]) for s, p in new.items()}
    if new_sharding.mesh.size > 1:
        return ShardedArray(new_sharding, shards)
    (only,) = shards.values()
    return only


def _release_old(old: Dict[Any, Tuple[torch.Tensor, ...]],
                 new: Dict[Any, Tuple[torch.Tensor, ...]]) -> None:
    """The copies may read every old shard on its card's current stream: the
    allocator waits for them before it reuses a dropped shard's memory."""
    for slot, parts in old.items():
        if new.get(slot) is not parts:
            for t in parts:
                if t.device.type == "cuda":
                    t.record_stream(torch.cuda.current_stream(t.device))


def _migrate_across_processes(storage, old_sharding, new_sharding, like):
    from harmony_tpu_torch.table.table import ShardedArray

    from harmony_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    pid = this_process()
    union = tuple(sorted(set(old_sharding.mesh.processes) | set(new_sharding.mesh.processes)))
    if not multihost.is_multihost():
        raise RuntimeError(
            f"a block move between processes {union} needs the pod's runtime "
            "(parallel/multihost.initialize_distributed)")
    if pid not in union:
        raise RuntimeError(f"process {pid} holds no slot of a move over processes {union}")
    seq = _next_seq(union)
    tag = "p" + "-".join(str(p) for p in union) + f"-{seq}"
    old = {s: p for s, p in _as_shards(storage, old_sharding)[0].items() if is_local(s)}
    if old:
        like = tuple((tuple(p.shape[1:]), p.dtype) for p in next(iter(old.values())))
    elif like is None:
        raise ValueError(f"process {pid} holds none of the table: the move needs its "
                         "parts' shapes and dtypes (like=)")
    nparts = len(like)
    paired = nparts > 1
    nb = old_sharding.num_blocks
    block_nbytes = sum(int(np.prod(shape)) * torch.empty(0, dtype=dtype).element_size()
                       for shape, dtype in like)
    plan = plan_moves(old_sharding, new_sharding, (nb,), 1)
    plan.block_nbytes = block_nbytes
    my_sends = plan.sends.get(pid, [])
    my_recv = plan.recvs.get(pid, set())

    # each block this process holds, from the lowest-indexed slot holding it
    local_of: Dict[int, Tuple[Any, int]] = {}
    for slot in sorted(old, key=lambda s: s.index):
        rng = old_sharding.slot_blocks(slot)
        for b in rng:
            local_of.setdefault(b, (slot, rng.start))
    for kind in _LAST_EVENTS:
        _LAST_EVENTS[kind].clear()

    # to the host: exactly the blocks leaving this process, one copy a run
    outgoing: Dict[int, torch.Tensor] = {}
    send_ids = sorted({b for b, _ in my_sends})
    missing_src = [b for b in send_ids if b not in local_of]
    if missing_src:
        raise RuntimeError(f"the move plan sources blocks {missing_src[:8]} from process "
                           f"{pid}, but no shard here holds them")
    t_off = time.perf_counter()
    runs: List[Tuple[Any, int, int, int]] = []
    for a, z in _contiguous_runs(send_ids):
        b = a
        while b < z:   # split a run where its source shard changes
            slot, lo = local_of[b]
            e = b
            while e < z and local_of[e][0] is slot:
                e += 1
            runs.append((slot, lo, b, e))
            b = e
    for slot, lo, a, z in runs:
        parts = old[slot]
        ev = _event_pair(parts[0].device, "off")
        if ev is not None:
            ev[0].record(torch.cuda.current_stream(parts[0].device))
        host = [p[a - lo:z - lo].to("cpu") for p in parts]
        if ev is not None:
            ev[1].record(torch.cuda.current_stream(parts[0].device))
        for b in range(a, z):
            for k, h in enumerate(host):
                outgoing[b * nparts + k] = h[b - a]
    copy_off_s = time.perf_counter() - t_off

    frame_plan = MovePlan(
        {src: [(b * nparts + k, dst) for b, dst in sends for k in range(nparts)]
         for src, sends in plan.sends.items()},
        {dst: {b * nparts + k for b in blocks for k in range(nparts)}
         for dst, blocks in plan.recvs.items()}, block_nbytes)
    expected = frame_plan.recvs.get(pid, set())
    mode = _transport_mode()
    legs: List[Dict[str, Any]] = []
    retries = [0]
    t_x = time.perf_counter()
    if plan.total_moves == 0:
        frames, sent_bytes = {}, 0
    elif mode == "tcp":
        frames, sent_bytes = _tcp_exchange(frame_plan, outgoing, expected, tag, legs, retries)
    else:
        frames, sent_bytes = _file_exchange(frame_plan, outgoing, expected, tag, union, retries)
    exchange_s = time.perf_counter() - t_x

    # rebuild this process's new shards from its own blocks (on the card)
    # and the received ones (one copy onto the card a contiguous run)
    t_on = time.perf_counter()
    new: Dict[Any, Tuple[torch.Tensor, ...]] = {}
    reused = 0
    for slot in filter(is_local, new_sharding.mesh.slots):
        want = new_sharding.slot_blocks(slot)
        mine = old.get(slot)
        if mine is not None and old_sharding.slot_blocks(slot) == want:
            new[slot] = mine
            reused += 1
            continue
        parts = tuple(torch.empty((len(want), *shape), dtype=dtype, device=slot.device)
                      for shape, dtype in like)
        b = want.start
        while b < want.stop:
            if b in local_of:
                src_slot, lo = local_of[b]
                z = b
                while z < want.stop and z in local_of and local_of[z][0] is src_slot:
                    z += 1
                for dst, src in zip(parts, old[src_slot]):
                    _copy_run(dst, b - want.start, src, b - lo, z - b)
            else:
                z = b
                while z < want.stop and z not in local_of:
                    if z not in my_recv:
                        raise RuntimeError(
                            f"rebuild on process {pid} needs block {z}, neither held "
                            "nor received: an inconsistent move plan")
                    z += 1
                hosts = []
                for k, dst in enumerate(parts):
                    host = torch.stack([frames[i * nparts + k] for i in range(b, z)])
                    if host.dtype != dst.dtype:
                        raise TypeError(f"received block frames of {host.dtype} for a "
                                        f"part of {dst.dtype}")
                    # pinned, so the copy runs async; the host allocator keeps
                    # the buffer until the copy is done
                    hosts.append(host.pin_memory() if dst.device.type == "cuda" else host)
                ev = _event_pair(slot.device, "on")
                with _guard(slot.device):
                    if ev is not None:
                        ev[0].record(torch.cuda.current_stream(slot.device))
                    for dst, host in zip(parts, hosts):
                        dst[b - want.start:z - want.start].copy_(host, non_blocking=True)
                    if ev is not None:
                        ev[1].record(torch.cuda.current_stream(slot.device))
            b = z
        new[slot] = parts
    _release_old(old, new)
    copy_on_s = time.perf_counter() - t_on
    received = {f // nparts for f in frames}
    last_move_stats.clear()
    last_move_stats.update({
        "seq": seq,
        "transport": mode,
        # tcp: frames a destination, as blocks; file: each block written once
        "blocks_sent": len(my_sends) if mode == "tcp" else len(send_ids),
        "bytes_sent": sent_bytes,
        "blocks_received": len(received),
        "bytes_received": sum(t.numel() * t.element_size() for t in frames.values()),
        "total_moves": plan.total_moves,
        "block_nbytes": block_nbytes,
        "transport_retries": retries[0],
        "seconds": time.perf_counter() - t0,
        "processes": list(union),
        "copy_off_s": copy_off_s,
        "exchange_s": exchange_s,
        "copy_on_s": copy_on_s,
        "shards_reused": reused,
        "legs": sorted(legs, key=lambda leg: leg["dst"]),
    })
    shards = {s: (p if paired else p[0]) for s, p in new.items()}
    if new_sharding.mesh.size > 1 or not shards:
        return ShardedArray(new_sharding, shards)
    (only,) = shards.values()
    return only
