"""Two-stage checkpointing of a model table.

Counterpart of ``harmony_tpu/checkpoint/manager.py`` (the reference's
checkpoint protocol, SURVEY.md §3.5), on one device:

  * stage 1 (temp): a checkpoint's blocks are written under
    ``<temp_root>/<chkp_id>``, each block its own file;
  * stage 2 (commit): the directory moves to durable storage through a
    :class:`~harmony_tpu_torch.checkpoint.backends.CommitBackend`;
  * sampling ratio: a dense checkpoint may keep only a prefix fraction of
    each block's keys; the restore fills the rest with init values;
  * restore creates the table anew on any executors of the master and
    installs the blocks.

Format, the reference's own, so that a checkpoint written by either package
restores in the other: one file per block, ``<bid>.blk`` (the native
CRC32-checked codec, ``harmony_tpu_torch/native``) or ``<bid>.npy`` where the
codec did not build, and a ``manifest.json`` written last, carrying the table
config, the block ownership, the commit state, the sampling ratio, the
application's tag (a chain's ``{"epoch": e}``) and a CRC32 of each block's
logical bytes. A hash table's block is its (slot_keys, values) pair packed
into one byte array (:func:`_pack_hash_block`). A manifest names its table's
update fn; a durable factory name of this package is written under the
reference's module prefix and mapped back on read, so the two packages'
manifests carry the same string (see :func:`_manifest_update_fn`).

Block I/O runs on ``HARMONY_CHKP_IO_THREADS`` threads (default 4; 1 is the
serial route, the same files and checksums), each block written or read with
the ``chkp.block_write`` / ``chkp.block_read`` fault sites and bounded retry.

On a table whose mesh spans the processes of a pod, :meth:`CheckpointManager.checkpoint`
is a collective (``_pod_checkpoint``): each process stages only the blocks it
owns, with a checksum sidecar of its own, and the mesh's lowest process merges
the sidecars into the manifest, renames the directory into place and commits,
between fences of ``parallel/multihost.py::mesh_sum`` that carry every
process's error flag. ``restore`` onto such a mesh installs only this
process's shards, and :meth:`CheckpointManager.restore_partial` (elastic
recovery's restore) reads only the blocks of them that this process's
recovery cache (``recovery_blocks``, filled when ``recovery_retain`` is set)
does not hold.

Not ported: the reference's read accounting and I/O histograms (the metrics
registry), and the tenant-accounting and joblog hooks (ROADMAP A.10).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from harmony_tpu_torch import faults, native
from harmony_tpu_torch.config.base import _REGISTRY, ConfigBase
from harmony_tpu_torch.config.params import RetryPolicy, TableConfig
from harmony_tpu_torch.faults.retry import call_with_retry
from harmony_tpu_torch.parallel import multihost
from harmony_tpu_torch.parallel.mesh import is_local, mesh_spans_processes
from harmony_tpu_torch.runtime.master import ETMaster, TableHandle
from harmony_tpu_torch.tracing.span import SpanContext, trace_span, wire_context

# -- parallel block I/O (HARMONY_CHKP_IO_THREADS) -------------------------
#
# Every block of a checkpoint is an independent file with an independent
# checksum, so write and read legs parallelize freely: the file I/O and the
# CRC run outside the GIL (native codec / zlib over a memoryview). Serial
# (threads == 1) takes the one-thread loop. In-flight bytes on the WRITE side
# are bounded (backpressure against the device-to-host producer), so a slow
# disk never turns into an unbounded host-memory spike of staged blocks.

#: write-side in-flight budget per worker thread (bytes)
_INFLIGHT_PER_THREAD = 256 << 20

#: blocks per import_blocks call on the pipelined restore route
_RESTORE_CHUNK_BLOCKS = 16


# -- per-process recovery cache (elastic recovery) --------------------------
#
# One entry a table id: the host copies of the blocks THIS process staged for
# its newest checkpoint, kept while a job opted in
# (CheckpointManager.recovery_retain). A partial restore takes every cached
# block from here and reads only the others from storage. Module-global, not a
# manager's: each recovery attempt builds a fresh CheckpointManager.

_RECOVERY_CACHE: Dict[str, Tuple[str, Dict[int, np.ndarray]]] = {}
_RECOVERY_LOCK = threading.Lock()
_RECOVERY_MAX_TABLES = 8


def _recovery_put(table_id: str, chkp_id: str, blocks: Dict[int, np.ndarray]) -> None:
    with _RECOVERY_LOCK:
        _RECOVERY_CACHE.pop(table_id, None)
        _RECOVERY_CACHE[table_id] = (chkp_id, blocks)
        while len(_RECOVERY_CACHE) > _RECOVERY_MAX_TABLES:
            _RECOVERY_CACHE.pop(next(iter(_RECOVERY_CACHE)))


def recovery_blocks(chkp_id: str) -> Optional[Dict[int, np.ndarray]]:
    """This process's cached block copies of EXACTLY ``chkp_id``, or None: an
    older checkpoint of the same table is never returned (mixing epochs would
    break the recovery's consistent cut)."""
    with _RECOVERY_LOCK:
        for cid, blocks in _RECOVERY_CACHE.values():
            if cid == chkp_id:
                return dict(blocks)
    return None


def drop_recovery_cache(table_id: Optional[str] = None,
                        prefix: Optional[str] = None) -> None:
    """Release retained block copies: one table, every table whose id starts
    with ``prefix`` (a job's private tables are ``<job_id>:...``), or all."""
    with _RECOVERY_LOCK:
        if table_id is None and prefix is None:
            _RECOVERY_CACHE.clear()
            return
        if table_id is not None:
            _RECOVERY_CACHE.pop(table_id, None)
        if prefix is not None:
            for tid in [t for t in _RECOVERY_CACHE if t.startswith(prefix)]:
                _RECOVERY_CACHE.pop(tid, None)


def _chkp_io_threads() -> int:
    """Worker count for checkpoint block I/O (HARMONY_CHKP_IO_THREADS; 1 =
    the serial route)."""
    try:
        return max(1, int(os.environ.get("HARMONY_CHKP_IO_THREADS", "4")))
    except ValueError:
        return 4


class _InflightBudget:
    """Write-side backpressure: ``acquire(nbytes)`` blocks until the
    in-flight total fits under the cap, so the producer stalls instead of
    buffering the whole table ahead of a slow disk. A single block larger
    than the cap is admitted alone (never deadlocks)."""

    def __init__(self, cap_bytes: int) -> None:
        self._cap = max(1, int(cap_bytes))
        self._inflight = 0
        self._cv = threading.Condition()

    def acquire(self, n: int) -> None:
        with self._cv:
            while self._inflight > 0 and self._inflight + n > self._cap:
                self._cv.wait()
            self._inflight += n

    def release(self, n: int) -> None:
        with self._cv:
            self._inflight -= n
            self._cv.notify_all()


def _stage_blocks(staging: str, arrs, policy: RetryPolicy) -> Dict[str, int]:
    """Write an ORDERED iterable of ``(bid, host block)`` pairs under
    ``staging`` and return the manifest checksum map ``{str(bid): crc}``.

    Serial when HARMONY_CHKP_IO_THREADS == 1. Otherwise the caller's iterator
    keeps producing (device-to-host copies, packing) on THIS thread while the
    block writes and CRCs run on the pool; producing stalls only when the
    in-flight budget is spent."""
    threads = _chkp_io_threads()
    if threads == 1:
        return {str(bid): _write_block(staging, bid, arr, policy) for bid, arr in arrs}
    from concurrent.futures import Future, ThreadPoolExecutor

    budget = _InflightBudget(threads * _INFLIGHT_PER_THREAD)
    failed = threading.Event()
    futures: Dict[int, "Future"] = {}

    def write_one(bid: int, arr: np.ndarray) -> int:
        try:
            return _write_block(staging, bid, arr, policy)
        except BaseException:
            failed.set()  # stop the producer: no point staging more
            raise
        finally:
            budget.release(arr.nbytes)

    with ThreadPoolExecutor(max_workers=threads, thread_name_prefix="chkp-io") as pool:
        for bid, arr in arrs:
            if failed.is_set():
                break
            budget.acquire(arr.nbytes)
            futures[bid] = pool.submit(write_one, bid, arr)
    out = {}
    first_err: Optional[BaseException] = None
    for bid in sorted(futures):
        try:
            out[str(bid)] = futures[bid].result()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err
    return out


def _fetch_blocks(d: str, bids, crcs: Dict[str, int],
                  policy: RetryPolicy) -> Dict[int, np.ndarray]:
    """Read many blocks from checkpoint dir ``d`` (parallel when
    HARMONY_CHKP_IO_THREADS > 1; each block is checked against its manifest
    checksum). The first failing block's error is raised after the
    outstanding reads are cancelled or drained."""

    def read_one(bid: int):
        return bid, _read_block(d, bid, expected_crc=crcs.get(str(bid)), policy=policy)

    bids = list(bids)
    threads = min(_chkp_io_threads(), max(1, len(bids)))
    if threads == 1:
        return dict(read_one(b) for b in bids)
    from concurrent.futures import ThreadPoolExecutor, as_completed

    pool = ThreadPoolExecutor(max_workers=threads, thread_name_prefix="chkp-io")
    try:
        futs = [pool.submit(read_one, b) for b in bids]
        out: Dict[int, np.ndarray] = {}
        for f in as_completed(futs):
            bid, arr = f.result()  # the first corrupt or lost block raises here
            out[bid] = arr
        return out
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


class CheckpointCorruptError(native.BlockCorruptError):
    """A checkpoint failed an integrity check on restore: a block's bytes do
    not match the manifest checksum, a block file is torn (codec CRC), or the
    manifest itself is unreadable. Not retryable, but recoverable: the
    chain-resume path quarantines the checkpoint and falls back to the
    previous committed entry (``jobserver/entity.py``)."""


def _block_crc(arr: np.ndarray) -> int:
    """CRC32 of a block's LOGICAL bytes (dtype-ordered array content, not
    the container file): the same digest whether the block was staged as
    .blk or .npy. zlib.crc32 over a memoryview, no copy."""
    import zlib

    a = np.ascontiguousarray(arr)
    try:
        buf = memoryview(a).cast("B")
    except (TypeError, ValueError):
        buf = a.tobytes()
    return zlib.crc32(buf) & 0xFFFFFFFF


def _write_block(d: str, bid: int, arr: np.ndarray,
                 policy: Optional[RetryPolicy] = None) -> int:
    """Write one block (a CRC-trailed .blk when the native codec is up, .npy
    otherwise), retrying transient I/O errors under ``policy``. Returns the
    block's content checksum for the manifest."""

    def attempt() -> None:
        if faults.armed():
            faults.site("chkp.block_write", block=bid)
            # "corrupt" is a torn block: a truncated container lands on disk
            # (the CRC trailer / manifest checksum must catch it at read time)
            act = faults.site("disk.write", kind="chkp.block", block=bid)
            if act == "corrupt":
                torn = os.path.join(d, f"{bid}.blk" if native.available() else f"{bid}.npy")
                with open(torn, "wb") as f:
                    f.write(b"\x93NUMPY-TORN")
                return
        if native.available():
            native.blk_write(os.path.join(d, f"{bid}.blk"), arr)
        else:
            np.save(os.path.join(d, f"{bid}.npy"), arr)

    call_with_retry(attempt, policy or RetryPolicy.from_env(), op="chkp.block_write")
    return _block_crc(arr)


def _read_block(d: str, bid: int, expected_crc: Optional[int] = None,
                policy: Optional[RetryPolicy] = None) -> np.ndarray:
    """Read a block in either format, retrying transient I/O. Corruption is
    fatal to the read, never retried: the codec's CRC trailer catches torn
    container files, ``expected_crc`` (from the manifest) everything else.
    Both raise :class:`CheckpointCorruptError`."""

    def attempt() -> np.ndarray:
        if faults.armed():
            faults.site("chkp.block_read", block=bid)
            # "corrupt" flips a byte after a clean read (bit rot under a
            # valid container): the manifest checksum below must fire
            if faults.site("disk.read", kind="chkp.block", block=bid) == "corrupt":
                arr = attempt_clean()
                raw = bytearray(arr.tobytes())
                if raw:
                    raw[0] ^= 0xFF
                    return np.frombuffer(bytes(raw), dtype=arr.dtype).reshape(arr.shape)
                return arr
        return attempt_clean()

    def attempt_clean() -> np.ndarray:
        blk = os.path.join(d, f"{bid}.blk")
        try:
            if os.path.exists(blk):
                return native.blk_read(blk)
            return np.load(os.path.join(d, f"{bid}.npy"))
        except native.BlockCorruptError as e:
            raise CheckpointCorruptError(str(e)) from e
        except (ValueError, EOFError) as e:
            # np.load of a torn .npy raises ValueError, of an empty file
            # EOFError: a corrupt container, as a CRC failure is
            raise CheckpointCorruptError(f"unreadable block {bid} under {d}: {e}") from e

    arr = call_with_retry(attempt, policy or RetryPolicy.from_env(), op="chkp.block_read",
                          fatal=(CheckpointCorruptError, FileNotFoundError))
    if expected_crc is not None:
        got = _block_crc(arr)
        if got != expected_crc:
            raise CheckpointCorruptError(
                f"block {bid} under {d} fails its manifest checksum "
                f"(expected {expected_crc}, got {got})")
    return arr


def _pack_hash_block(sk: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Hash-table block (slot_keys, values) -> ONE uint8 array for the block
    codec: [int64 n_slots, int64 value_nbytes] + keys + value bytes. Shapes
    and dtypes come back from the table config at restore."""
    head = np.asarray([sk.shape[0], v.nbytes], np.int64).tobytes()
    payload = head + np.ascontiguousarray(sk, np.int32).tobytes()
    payload += np.ascontiguousarray(v).tobytes()
    return np.frombuffer(payload, np.uint8)


def _unpack_hash_block(raw: np.ndarray, spec) -> "tuple[np.ndarray, np.ndarray]":
    buf = raw.tobytes()
    n_slots, v_nbytes = np.frombuffer(buf[:16], np.int64)
    if n_slots != spec.block_slots:
        raise IOError(f"hash block slot count {n_slots} != config {spec.block_slots}")
    koff = 16 + int(n_slots) * 4
    sk = np.frombuffer(buf[16:koff], np.int32)
    v = np.frombuffer(buf[koff: koff + int(v_nbytes)], np.dtype(spec.config.dtype)).reshape(
        spec.block_slots, *spec.value_shape)
    return sk, v


# -- the update fn's name in a manifest ------------------------------------
#
# A hash table's durable init is a factory reference, "pkg.mod:factory?k=v".
# Each package's factory gate admits only its own modules, so a manifest
# written with this package's prefix would not restore in the reference. The
# manifest carries the reference's module prefix; a read maps it back to this
# package's counterpart module (a string mapping, nothing of the reference is
# imported). Registered plain names ("add", "assign", ...) pass unchanged.

_MANIFEST_PREFIX = "harmony_tpu."
_PACKAGE_PREFIX = "harmony_tpu_torch."


def _manifest_update_fn(name: str) -> str:
    """This package's update-fn name as a manifest writes it."""
    if name.startswith(_PACKAGE_PREFIX):
        return _MANIFEST_PREFIX + name[len(_PACKAGE_PREFIX):]
    return name


def _package_update_fn(name: str) -> str:
    """A manifest's update-fn name as this package resolves it."""
    if name.startswith(_MANIFEST_PREFIX):
        return _PACKAGE_PREFIX + name[len(_MANIFEST_PREFIX):]
    return name


def _check_update_fn(name: str) -> None:
    """Raise when a factory name read from a manifest has no counterpart
    module in this package (the checkpoint is sound; this package cannot
    rebuild its table)."""
    module = name.partition("?")[0].partition(":")[0]
    if ":" not in name or not module.startswith(_PACKAGE_PREFIX):
        return
    try:
        found = importlib.util.find_spec(module) is not None
    except ModuleNotFoundError:
        found = False
    if not found:
        raise ValueError(
            f"the checkpoint's update fn {_manifest_update_fn(name)!r} names module "
            f"{_manifest_update_fn(module)!r}, which has no counterpart {module!r} "
            "in harmony_tpu_torch")


@dataclasses.dataclass
class CheckpointInfo:
    chkp_id: str
    table_config: TableConfig
    block_ids: List[int]
    ownership: List[int]          # block -> executor index at checkpoint time
    executors: List[str]
    sampling_ratio: float
    committed: bool
    created_at: float
    #: application-level tag (a chain's {"epoch": N}); optional
    app_meta: Optional[Dict[str, float]] = None
    #: per-block content checksums (str(block_id) -> CRC32 of the block's
    #: logical bytes); optional, restore verifies blocks only when present
    block_checksums: Optional[Dict[str, int]] = None

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["table_config"] = self.table_config.to_dict()
        d["table_config"]["update_fn"] = _manifest_update_fn(self.table_config.update_fn)
        return json.dumps(d, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "CheckpointInfo":
        # Forward compatibility at both nesting levels: a newer writer's extra
        # fields (on the manifest or on its table config) are dropped, not
        # raised on (a TypeError here would read as a torn manifest and the
        # chain scan would quarantine a valid checkpoint). Missing REQUIRED
        # fields still raise.
        d = json.loads(s)
        tc = d["table_config"]
        if isinstance(tc, dict):
            cls = _REGISTRY.get(tc.get("_type"))
            if cls is not None and dataclasses.is_dataclass(cls):
                keep = {f.name for f in dataclasses.fields(cls)} | {"_type"}
                tc = {k: v for k, v in tc.items() if k in keep}
        cfg = ConfigBase.from_dict(tc)
        d["table_config"] = cfg.replace(update_fn=_package_update_fn(cfg.update_fn))
        known = {f.name for f in dataclasses.fields(CheckpointInfo)}
        return CheckpointInfo(**{k: v for k, v in d.items() if k in known})


class CheckpointStillWriting(TimeoutError):
    """wait(timeout) expired while the writer is still running (distinct from
    a writer that FAILED with a TimeoutError of its own)."""


class PendingCheckpoint:
    """Handle of an in-flight async checkpoint (see
    :meth:`CheckpointManager.checkpoint_async`). Besides the id it records
    what the checkpoint cost: ``snapshot_seconds`` on the caller's thread,
    and once written, ``write_seconds`` on the writer thread and
    ``bytes_written`` (the blocks' host bytes)."""

    def __init__(self, chkp_id: str) -> None:
        self.chkp_id = chkp_id
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self.snapshot_seconds = 0.0
        self.write_seconds: Optional[float] = None
        self.bytes_written: Optional[int] = None

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until the write finishes; raises the writer's exception if it
        failed, else returns the checkpoint id."""
        if not self._done.wait(timeout):
            raise CheckpointStillWriting(f"checkpoint {self.chkp_id} still writing")
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            raise self._error
        return self.chkp_id


class CheckpointManager:
    """Checkpoint coordinator (the reference's ChkpManagerMaster) with the
    block I/O of its slaves collapsed in: the manager reaches every block
    through the table's export and import."""

    @classmethod
    def for_job(cls, chkp_root: str, job_id: str) -> "CheckpointManager":
        """The per-job layout, ``<root>/<job>/temp`` and ``<root>/<job>/commit``
        (the reference's ``HARMONY_CHKP_BACKEND`` switch selects its Orbax
        backend, which is not ported)."""
        return cls(os.path.join(chkp_root, job_id, "temp"),
                   os.path.join(chkp_root, job_id, "commit"))

    def __init__(self, temp_root: str, commit_root: str, backend=None) -> None:
        """``commit_root`` is the durable store, a directory; ``backend`` a
        name ("posix") or a CommitBackend instance (see backends.py)."""
        from harmony_tpu_torch.checkpoint.backends import make_commit_backend

        self.temp_root = temp_root
        self.commit_root = commit_root
        self._backend = make_commit_backend(commit_root, backend)
        os.makedirs(temp_root, exist_ok=True)
        self._lock = threading.Lock()
        self._counter = 0
        #: set for elastic jobs: each full-ratio checkpoint also keeps this
        #: process's staged host copies in the recovery cache, so a later
        #: partial restore reads only the blocks it lacks
        self.recovery_retain = False
        #: this process's share of its newest pod checkpoint: the chkp id, the
        #: ids, count and bytes of the blocks it staged, and the seconds the
        #: staging took (the host copies and the block writes)
        self.last_staged: Dict[str, Any] = {}

    def advance_counter(self, base: int) -> None:
        """Start id counters past ``base``: a RESUMED job's chain continues
        the original chain's numbering."""
        with self._lock:
            self._counter = max(self._counter, int(base))

    # -- write path ------------------------------------------------------

    def _snapshot(self, handle: TableHandle, sampling_ratio: float,
                  app_meta: Optional[Dict[str, float]] = None):
        """The synchronous prefix of sync and async checkpoints: the id and a
        device-side copy of the blocks taken under the table lock."""
        if not (0.0 < sampling_ratio <= 1.0):
            raise ValueError(f"bad sampling_ratio {sampling_ratio}")
        if handle.table.spec.config.sparse and sampling_ratio < 1.0:
            raise ValueError(
                "sampling is undefined for sparse (hash) tables: slot order is "
                "not key order, so a prefix is not a sample")
        with self._lock:
            self._counter += 1
            chkp_id = f"{handle.table_id}-{self._counter}-{int(time.time() * 1000)}"
        snap = handle.table.snapshot_blocks()
        info = CheckpointInfo(
            chkp_id=chkp_id,
            table_config=handle.table.spec.config,
            block_ids=sorted(snap),
            ownership=handle.ownership_vector(),
            executors=list(handle.executors),
            sampling_ratio=sampling_ratio,
            committed=False,
            created_at=time.time(),
            app_meta=app_meta,
        )
        return chkp_id, snap, info

    def _write(self, info: CheckpointInfo, snap, block_size: int, commit: bool) -> int:
        """Stage the snapshot to temp files (and commit): the device-to-host
        copies and the file I/O, runnable on any thread. Returns the bytes of
        the blocks staged.

        Writes into a ``.writing`` directory and renames it into place,
        manifest last, so delete/info/restore/list never see a half-written
        checkpoint."""
        tdir = os.path.join(self.temp_root, info.chkp_id)
        staging = tdir + ".writing"
        os.makedirs(staging)
        staged_bytes = 0
        try:
            keep = None
            if info.sampling_ratio < 1.0:
                keep = max(1, int(block_size * info.sampling_ratio))
            sparse = info.table_config.sparse
            policy = RetryPolicy.from_env()
            retained: Optional[Dict[int, np.ndarray]] = (
                {} if self.recovery_retain and keep is None else None)
            # one device-to-host copy of each part; the device copy goes with it
            ids, parts = snap.ids, snap.to_host()
            snap.parts = ()

            def host_blocks():
                nonlocal staged_bytes
                for i in sorted(range(len(ids)), key=ids.__getitem__):
                    if sparse:
                        arr = _pack_hash_block(parts[0][i], parts[1][i])
                    else:
                        arr = parts[0][i]
                        arr = arr[:keep] if keep else arr
                    if retained is not None:
                        retained[ids[i]] = arr
                    staged_bytes += int(arr.nbytes)
                    yield ids[i], arr

            info.block_checksums = _stage_blocks(staging, host_blocks(), policy)
            if retained is not None:
                _recovery_put(info.table_config.table_id, info.chkp_id, retained)
            with open(os.path.join(staging, "manifest.json"), "w") as f:
                f.write(info.to_json())
            os.rename(staging, tdir)
        except BaseException:
            # never leak an unreachable partial dir (list and delete skip
            # '.writing', so nothing else would clean it up)
            shutil.rmtree(staging, ignore_errors=True)
            raise
        if commit:
            self.commit(info.chkp_id)
        return staged_bytes

    def checkpoint(self, handle: TableHandle, sampling_ratio: float = 1.0,
                   commit: bool = False,
                   app_meta: Optional[Dict[str, float]] = None) -> str:
        """Stage the table's blocks to temp storage, optionally commit. Returns
        the checkpoint id (``tableId-seq-timestamp``).

        On a mesh over several processes this is a collective
        (:meth:`_pod_checkpoint`): every process of the mesh calls it with the
        same arguments at the same point of its call sequence."""
        with trace_span("checkpoint.write", table=handle.table_id) as sp:
            if mesh_spans_processes(handle.table.mesh):
                chkp_id = self._pod_checkpoint(handle, sampling_ratio, commit, app_meta)
            else:
                chkp_id, snap, info = self._snapshot(handle, sampling_ratio, app_meta)
                self._write(info, snap, handle.table.spec.block_size, commit)
            if sp is not None:
                sp.annotate("chkp_id", chkp_id)
            return chkp_id

    def _pod_checkpoint(self, handle: TableHandle, sampling_ratio: float, commit: bool,
                        app_meta: Optional[Dict[str, float]] = None) -> str:
        """The pod's two-stage checkpoint (the reference's
        ``_pod_checkpoint``): each process stages the blocks it owns from its
        own shards, no process touching another's bytes; then the mesh's
        lowest process writes the manifest, renames the staging directory
        into place and commits. Three fences (``mesh_sum``) order it:
        cleared, staged and done, each carrying every process's error flag,
        so a one-sided failure makes every process raise, none waiting.

        ``temp_root`` must be storage every process of the mesh sees. The id
        comes from the per-process counter, never a clock, so every process
        names the same checkpoint: the counter is bumped past ids already in
        storage (a resubmitted job's fresh manager would reuse them), and the
        scan never reads ``.writing`` staging, which peers create mid-scan."""
        if sampling_ratio != 1.0:
            raise ValueError(
                "sampling is single-process only: a sampled pod restore would "
                "need the cross-process pad path")
        with self._lock:
            while True:
                self._counter += 1
                chkp_id = f"{handle.table_id}-{self._counter}-pod"
                if not self._backend.exists(chkp_id) and not os.path.isdir(
                        os.path.join(self.temp_root, chkp_id)):
                    break
        mesh = handle.table.mesh
        me = multihost.process_index()
        leader = min(mesh.processes)
        info = CheckpointInfo(
            chkp_id=chkp_id,
            table_config=handle.table.spec.config,
            block_ids=list(range(handle.table.spec.num_blocks)),
            ownership=handle.ownership_vector(),
            executors=list(handle.executors),
            sampling_ratio=1.0,
            committed=False,
            created_at=time.time(),
            app_meta=app_meta,
        )
        tdir = os.path.join(self.temp_root, chkp_id)
        staging = tdir + ".writing"
        # a crashed run of the same job may have left block files in the
        # staging directory: the leader clears it before anyone writes
        err: Optional[BaseException] = None
        try:
            if me == leader:
                shutil.rmtree(staging, ignore_errors=True)
                os.makedirs(staging, exist_ok=True)
        except BaseException as e:  # noqa: BLE001 - reported through the fence
            err = e
        if multihost.mesh_sum(mesh, 1.0 if err else 0.0, f"chkp-cleared:{chkp_id}"):
            if err is not None:
                raise err
            raise RuntimeError(f"leader failed clearing the staging dir for {chkp_id}")
        t0 = time.perf_counter()
        staged: Dict[str, Any] = {"chkp_id": chkp_id, "block_ids": [], "blocks": 0, "bytes": 0}
        try:
            os.makedirs(staging, exist_ok=True)
            sparse = info.table_config.sparse
            mine = handle.table.addressable_blocks()
            retained: Optional[Dict[int, np.ndarray]] = {} if self.recovery_retain else None

            def host_blocks():
                for bid in sorted(mine):
                    item = mine.pop(bid)
                    arr = _pack_hash_block(*item) if sparse else item
                    if retained is not None:
                        retained[bid] = arr
                    staged["block_ids"].append(bid)
                    staged["bytes"] += int(arr.nbytes)
                    yield bid, arr

            crcs = _stage_blocks(staging, host_blocks(), RetryPolicy.from_env())
            staged["blocks"] = len(staged["block_ids"])
            if retained is not None:
                _recovery_put(info.table_config.table_id, chkp_id, retained)
            # only this process knows its blocks' checksums: the leader merges
            # every sidecar after the staged fence
            side = os.path.join(staging, f"_crc.{me}.json")
            with open(side + ".tmp", "w") as f:
                json.dump(crcs, f, sort_keys=True)
            os.replace(side + ".tmp", side)
        except BaseException as e:  # noqa: BLE001 - reported through the fence
            err = e
        staged["seconds"] = time.perf_counter() - t0
        failures = multihost.mesh_sum(mesh, 1.0 if err else 0.0, f"chkp-staged:{chkp_id}")
        if failures:
            if me == leader:
                shutil.rmtree(staging, ignore_errors=True)
            if err is not None:
                raise err
            raise RuntimeError(f"{int(failures)} process(es) failed staging {chkp_id}")
        if me == leader:
            try:
                merged: Dict[str, int] = {}
                for name in sorted(os.listdir(staging)):
                    if name.startswith("_crc.") and name.endswith(".json"):
                        path = os.path.join(staging, name)
                        with open(path) as f:
                            merged.update(json.load(f))
                        os.remove(path)
                info.block_checksums = merged or None
                with open(os.path.join(staging, "manifest.json"), "w") as f:
                    f.write(info.to_json())
                os.rename(staging, tdir)
                if commit:
                    self.commit(chkp_id)
            except BaseException as e:  # noqa: BLE001 - reported through the fence
                err = e
                shutil.rmtree(staging, ignore_errors=True)
        if multihost.mesh_sum(mesh, 1.0 if err else 0.0, f"chkp-done:{chkp_id}"):
            if err is not None:
                raise err
            raise RuntimeError(f"leader failed finalizing {chkp_id} (manifest/commit)")
        self.last_staged = staged
        return chkp_id

    def checkpoint_async(self, handle: TableHandle, sampling_ratio: float = 1.0,
                         commit: bool = False,
                         app_meta: Optional[Dict[str, float]] = None) -> PendingCheckpoint:
        """Non-blocking checkpoint: the device-side snapshot is taken NOW (a
        copy under the table lock, so steps that update the table in place
        afterwards do not reach it); the device-to-host copies and the file
        I/O run on a background thread. The id resolves to a readable
        directory only once ``wait()`` returns. Refused on a mesh over several
        processes: the pod's fences on a background thread would race the
        pod's lockstep dispatch order, so its checkpoints are synchronous."""
        if mesh_spans_processes(handle.table.mesh):
            raise ValueError("checkpoint_async is single-process only; call "
                             "checkpoint() collectively on a multi-process mesh")
        t0 = time.perf_counter()
        chkp_id, snap, info = self._snapshot(handle, sampling_ratio, app_meta)
        pending = PendingCheckpoint(chkp_id)
        pending.snapshot_seconds = time.perf_counter() - t0
        block_size = handle.table.spec.block_size
        # the writer thread has no ambient span: carry the caller's context
        parent_wire = wire_context()

        def run():
            try:
                with trace_span("checkpoint.write_async",
                                parent=SpanContext.from_wire(parent_wire), chkp_id=chkp_id):
                    t1 = time.perf_counter()
                    pending.bytes_written = self._write(info, snap, block_size, commit)
                    pending.write_seconds = time.perf_counter() - t1
            except BaseException as e:  # surfaced by wait()
                pending._error = e
            finally:
                pending._done.set()

        t = threading.Thread(target=run, name=f"chkp-{chkp_id}", daemon=True)
        pending._thread = t
        t.start()
        return pending

    def commit(self, chkp_id: str) -> None:
        """Stage 2: temp -> durable, through the commit backend. The temp copy
        is removed only after the durable write lands; idempotent."""
        with trace_span("checkpoint.commit", chkp_id=chkp_id):
            if faults.armed():
                faults.site("chkp.commit", chkp_id=chkp_id)
                faults.site("disk.fsync", kind="chkp.commit", chkp_id=chkp_id)
            src = os.path.join(self.temp_root, chkp_id)
            if self._backend.exists(chkp_id):
                shutil.rmtree(src, ignore_errors=True)
                return
            if not os.path.isdir(src):
                raise FileNotFoundError(f"no temp checkpoint {chkp_id}")
            self._backend.commit(chkp_id, src)
            shutil.rmtree(src)

    def quarantine(self, chkp_id: str) -> None:
        """Move a DAMAGED checkpoint out of the restorable namespace, keeping
        the evidence (``<id>.quarantined``, skipped by every listing).
        Idempotent."""
        from harmony_tpu_torch.checkpoint.backends import quarantine_dir

        self._backend.quarantine(chkp_id)
        quarantine_dir(os.path.join(self.temp_root, chkp_id))

    # -- read path -------------------------------------------------------

    def _dir_of(self, chkp_id: str) -> str:
        committed = self._backend.fetch(chkp_id)
        if committed is not None:
            return committed
        temp = os.path.join(self.temp_root, chkp_id)
        if os.path.isdir(temp):
            return temp
        raise FileNotFoundError(f"checkpoint {chkp_id} not found")

    @staticmethod
    def _load_manifest(d: str) -> CheckpointInfo:
        """A directory whose manifest is missing or unparseable is a torn
        commit (the manifest is written last): CheckpointCorruptError."""
        path = os.path.join(d, "manifest.json")
        try:
            with open(path) as f:
                return CheckpointInfo.from_json(f.read())
        except FileNotFoundError as e:
            raise CheckpointCorruptError(f"torn checkpoint at {d}: no manifest.json") from e
        except (ValueError, KeyError, TypeError) as e:
            raise CheckpointCorruptError(
                f"torn/corrupt manifest at {path}: {type(e).__name__}: {e}") from e

    def info(self, chkp_id: str) -> CheckpointInfo:
        """The manifest only; no block data is read."""
        text = self._backend.fetch_manifest(chkp_id)
        if text is not None:
            try:
                return CheckpointInfo.from_json(text)
            except (ValueError, KeyError, TypeError) as e:
                raise CheckpointCorruptError(
                    f"torn/corrupt manifest for {chkp_id}: {type(e).__name__}: {e}") from e
        temp = os.path.join(self.temp_root, chkp_id)
        if os.path.isdir(temp):
            return self._load_manifest(temp)
        raise FileNotFoundError(f"checkpoint {chkp_id} not found")

    def list_checkpoints(self) -> List[str]:
        temp = set(
            d for d in os.listdir(self.temp_root)
            if not d.endswith(".staging") and not d.endswith(".writing")
            and not d.endswith(".quarantined")
            and os.path.isdir(os.path.join(self.temp_root, d)))
        return sorted(temp | set(self._backend.list_ids()))

    def restore(self, master: ETMaster, chkp_id: str, associators: Sequence[str],
                data_axis: int = 1, table_id: Optional[str] = None) -> TableHandle:
        """Create the table on ``associators`` (any number of them, whatever
        wrote the checkpoint: the blocks are split over their mesh,
        ``data_axis`` rows deep) and install the checkpoint's blocks. A
        sampled checkpoint's unsampled keys keep their init values. A failed
        restore drops the table it created.

        Onto a mesh over several processes each process reads every block
        (so each sees a corrupt one) and installs only its own shards, in one
        import whatever its ``HARMONY_CHKP_IO_THREADS``, so every process
        makes the same calls; a sampled checkpoint is refused there."""
        with trace_span("checkpoint.restore", chkp_id=chkp_id):
            return self._restore_inner(master, chkp_id, associators, data_axis, table_id)

    def _restore_inner(self, master: ETMaster, chkp_id: str,
                       associators: Sequence[str], data_axis: int,
                       table_id: Optional[str]) -> TableHandle:
        d = self._dir_of(chkp_id)
        info = self._load_manifest(d)
        cfg = info.table_config
        _check_update_fn(cfg.update_fn)
        if table_id is not None:
            cfg = cfg.replace(table_id=table_id)
        handle = TableHandle(master, master.create_table(cfg, associators, data_axis),
                             associators)
        pool = None
        try:
            spec = handle.table.spec
            crcs = info.block_checksums or {}
            policy = RetryPolicy.from_env()
            threads = min(_chkp_io_threads(), max(1, len(info.block_ids)))
            spans = mesh_spans_processes(handle.table.mesh)
            pipelined = (threads > 1 and not cfg.sparse and info.sampling_ratio >= 1.0
                         and not spans)
            raw: Dict[int, Any] = {}
            if pipelined:
                # dense full-ratio: reads stream off the I/O pool while
                # finished chunks install, in block-id order (deterministic)
                from concurrent.futures import ThreadPoolExecutor

                pool = ThreadPoolExecutor(max_workers=threads, thread_name_prefix="chkp-io")
                raw = {bid: pool.submit(_read_block, d, bid, crcs.get(str(bid)), policy)
                       for bid in info.block_ids}
            else:
                # sparse / sampled blocks need per-block processing: read all
                # first (still parallel)
                raw = _fetch_blocks(d, info.block_ids, crcs, policy)
            blocks: Dict[int, Any] = {}
            for bid in info.block_ids:
                arr = raw.pop(bid)
                if pipelined:
                    arr = arr.result()
                if cfg.sparse:
                    blocks[bid] = _unpack_hash_block(arr, spec)
                    continue
                if arr.shape[0] < spec.block_size:
                    if spans:
                        raise ValueError(
                            f"checkpoint {chkp_id} is sampled; its init pad reads whole "
                            "blocks on the host and is single-process only: restore "
                            "onto a single-process mesh")
                    # sampled: pad with the block's init values
                    full = np.array(handle.table.export_blocks([bid])[bid])
                    full[: arr.shape[0]] = arr
                    arr = full
                blocks[bid] = arr
                if pipelined and len(blocks) >= _RESTORE_CHUNK_BLOCKS:
                    handle.table.import_blocks(blocks)
                    blocks = {}
            handle.table.import_blocks(blocks)
        except BaseException:
            handle.drop()  # no half-restored orphan table
            raise
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
        return handle

    def restore_partial(self, master: ETMaster, chkp_id: str, associators: Sequence[str],
                        data_axis: int = 1, table_id: Optional[str] = None
                        ) -> "Tuple[TableHandle, Dict[str, int]]":
        """Elastic recovery's restore: create the table on ``associators``
        and read from storage ONLY the blocks of this process's shards that
        its recovery cache does not hold (O(lost bytes), where ``restore``
        reads the whole model). Read blocks are checked against the manifest
        like a full restore's; cached blocks are the host copies whose
        checksums the manifest records. On a mesh over several processes each
        process installs only its own shards.

        Returns ``(handle, stats)``, stats = {partial, blocks_total,
        blocks_needed, blocks_local, blocks_read, bytes_read}. A sparse or
        sampled checkpoint falls back to the full restore (``partial`` 0,
        ``bytes_read`` -1)."""
        with trace_span("checkpoint.restore_partial", chkp_id=chkp_id) as sp:
            handle, stats = self._restore_partial_inner(master, chkp_id, associators,
                                                        data_axis, table_id)
            if sp is not None:
                for k, v in stats.items():
                    sp.annotate(k, v)
            return handle, stats

    def _restore_partial_inner(self, master: ETMaster, chkp_id: str,
                               associators: Sequence[str], data_axis: int,
                               table_id: Optional[str]):
        d = self._dir_of(chkp_id)
        info = self._load_manifest(d)
        cfg = info.table_config
        _check_update_fn(cfg.update_fn)
        if table_id is not None:
            cfg = cfg.replace(table_id=table_id)
        if cfg.sparse or info.sampling_ratio < 1.0:
            handle = self.restore(master, chkp_id, associators, data_axis, table_id)
            nb = len(info.block_ids)
            return handle, {"partial": 0, "blocks_total": nb, "blocks_needed": nb,
                            "blocks_local": 0, "blocks_read": nb, "bytes_read": -1}
        local = recovery_blocks(chkp_id) or {}
        handle = TableHandle(master, master.create_table(cfg, associators, data_axis),
                             associators)
        pool = None
        try:
            table = handle.table
            sh = table.sharding
            needed = sorted({b for s in sh.mesh.slots if is_local(s)
                             for b in sh.slot_blocks(s)})
            crcs = info.block_checksums or {}
            policy = RetryPolicy.from_env()
            stats = {"partial": 1, "blocks_total": len(info.block_ids),
                     "blocks_needed": len(needed), "blocks_local": 0,
                     "blocks_read": 0, "bytes_read": 0}

            def read_one(bid: int) -> np.ndarray:
                if faults.armed():
                    faults.site("chkp.partial_read", block=bid, chkp_id=chkp_id)
                arr = _read_block(d, bid, expected_crc=crcs.get(str(bid)), policy=policy)
                if arr.shape[0] < table.spec.block_size:
                    raise CheckpointCorruptError(
                        f"partial restore of {chkp_id}: block {bid} is short "
                        f"({arr.shape[0]} rows) in a full-ratio checkpoint")
                return arr

            # the blocks to read stream off the I/O pool while the cached ones,
            # and the installs of finished chunks, proceed on this thread
            to_read = [b for b in needed if b not in local]
            futures: Dict[int, Any] = {}
            if to_read and _chkp_io_threads() > 1:
                from concurrent.futures import ThreadPoolExecutor

                pool = ThreadPoolExecutor(max_workers=min(_chkp_io_threads(), len(to_read)),
                                          thread_name_prefix="chkp-io")
                futures = {bid: pool.submit(read_one, bid) for bid in to_read}
            # chunked installs in block-id order on one process; over several,
            # one install, so every process makes the same calls
            chunked = pool is not None and not mesh_spans_processes(sh.mesh)
            chunk: Dict[int, np.ndarray] = {}
            for bid in needed:
                arr = local.get(bid)
                if arr is not None:
                    stats["blocks_local"] += 1
                else:
                    fut = futures.get(bid)
                    arr = fut.result() if fut is not None else read_one(bid)
                    stats["blocks_read"] += 1
                    stats["bytes_read"] += int(arr.nbytes)
                chunk[bid] = arr
                if chunked and len(chunk) >= _RESTORE_CHUNK_BLOCKS:
                    table.import_blocks(chunk)
                    chunk = {}
            table.import_blocks(chunk)
        except BaseException:
            handle.drop()  # no half-restored orphan table
            raise
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
        return handle, stats

    def delete(self, chkp_id: str) -> None:
        """Remove every copy (a crashed commit can leave one in both roots)."""
        temp = os.path.join(self.temp_root, chkp_id)
        if not self._backend.exists(chkp_id) and not os.path.isdir(temp):
            raise FileNotFoundError(f"checkpoint {chkp_id} not found")
        self._backend.delete(chkp_id)
        if os.path.isdir(temp):
            shutil.rmtree(temp)
