"""ServingEndpoint: low-latency reads from live training state.

Counterpart of ``harmony_tpu/serving/service.py``. The jobserver embeds one
endpoint (started on demand by the first ``SERVING`` command) that answers
framed lookup streams (serving/protocol.py) against the tables its entities
are training. Three layers between the socket and the storage:

  * **micro-batching** — concurrent lookups against one view coalesce
    within a bounded window (``HARMONY_SERVE_BATCH_WINDOW_MS`` /
    ``HARMONY_SERVE_BATCH_MAX``) into ONE keyed gather through the table's
    ``multi_get``: ``TableSpec.pull``'s ``gather_rows`` (K1) on a dense
    table, ``HashTableSpec.lookup``'s probe and K1 on a hash table; then
    per-request slices go back to their response frames. The read is
    dispatched under the table lock after the last committed step (the
    tables' ``StreamOrder``), and waits for its rows outside the lock;
    serving never writes a table;
  * **hot-row cache** — a ``data/devcache.py`` ByteLRU
    (``HARMONY_SERVE_CACHE_MB``) over gathered rows, keyed by the job, the
    table object's generation (a job id submitted again reads its new
    table, never the dropped one), the table's layout AND data versions
    and the key (a training write retires the cached generation), and
    dropped by the table's layout announcements (``LayoutAnnouncerMixin``);
  * **read modes** — ``live`` returns the latest table state (staleness
    bounded by one in-flight train step); ``pinned`` serves the newest
    committed checkpoint-chain epoch through ``CheckpointManager``'s
    manifest and CRC-verified block reads, so a batch of reads never
    observes a torn mid-step state. The pinned epoch and chkp id ride
    every response. A hash table's chain is refused: its blocks are packed
    slot keys and values, not rows at a key's offset (the reference reads
    them as rows; ROADMAP C).

Admission control is the jobserver's overload monitor: while the control
plane is shedding, lookups get a structured ``busy`` frame with a retry
hint. ``stats()`` reports per-tenant p50/p99 latency, batch occupancy and
the cache's figures. The observers are the reference's, each in a ``try``
(they never fail a lookup): ``harmony_serving_requests_total{mode}`` and
``harmony_serving_shed_total`` in the registry; every ``_LEDGER_FLUSH_S``
a tenant's window (qps, p50/p99, its SLO, batch occupancy, cache hit rate)
goes into the tenant ledger (``set_serving_state``), which the history
scraper folds as ``tenant.serving.*`` series for the doctor's
``serving_slo_breach`` rule; and a window whose p99 exceeds the tenant's
SLO records a ``serving_slo`` joblog event, the incident engine's trigger.
"""
from __future__ import annotations

import os
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from harmony_tpu_torch.data.devcache import ByteLRU
from harmony_tpu_torch.serving import protocol
from harmony_tpu_torch.utils.framing import close_listener

__all__ = ["ServingEndpoint"]


def batch_window_ms_from_env() -> float:
    """HARMONY_SERVE_BATCH_WINDOW_MS (default 2.0): how long a lookup
    waits for companions before the gather dispatches. 0 disables
    coalescing (every request is its own batch)."""
    return max(0.0, float(
        os.environ.get("HARMONY_SERVE_BATCH_WINDOW_MS", "2") or 2))


def batch_max_from_env() -> int:
    """HARMONY_SERVE_BATCH_MAX (default 256): keys per coalesced gather
    before the batch dispatches early."""
    return max(1, int(os.environ.get("HARMONY_SERVE_BATCH_MAX", "256") or 256))


def cache_mb_from_env() -> int:
    """HARMONY_SERVE_CACHE_MB (default 64): hot-row cache budget.
    0 disables the cache."""
    return max(0, int(os.environ.get("HARMONY_SERVE_CACHE_MB", "64") or 64))


def slo_ms_from_env() -> float:
    """HARMONY_SERVE_SLO_MS (default 50): default p99 latency SLO a
    serving tenant registers in the ledger."""
    return max(0.1, float(os.environ.get("HARMONY_SERVE_SLO_MS", "50") or 50))


#: Bound on one lookup's key count — a single request may not smuggle a
#: full-table export through the request path (pull_all exists for that).
_MAX_KEYS = 1 << 16

#: Latency samples kept per tenant for the p50/p99 window.
_LAT_WINDOW = 512

#: How long a resolved pinned view stays authoritative before the chain
#: is re-scanned for a newer committed epoch.
_PIN_TTL_S = 1.0

#: Follower bound on waiting for its batch leader's gather.
_BATCH_WAIT_S = 30.0

#: Ledger flush cadence (seconds) — serving stats are summarized, not
#: pushed per request.
_LEDGER_FLUSH_S = 0.5


class _PendingBatch:
    __slots__ = ("parts", "total", "closed", "filled", "done", "rows",
                 "error")

    def __init__(self) -> None:
        self.parts: List[np.ndarray] = []
        self.total = 0
        self.closed = False
        self.filled = threading.Event()
        self.done = threading.Event()
        self.rows: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class _Batcher:
    """Coalesces concurrent lookups against ONE view into one gather.

    The first request of a batch is the leader: it waits up to the
    window for companions (or until the batch fills), then dispatches
    the concatenated keys through ``gather_fn`` once and publishes the
    rows; followers wait on the batch's done event and slice their own
    span out. With window=0 every request is its own leader — the
    batching-off arm of the bench walks the same code path."""

    def __init__(self, gather_fn: Callable[[np.ndarray], np.ndarray],
                 window_s: float, max_keys: int) -> None:
        self._gather = gather_fn
        self._window = window_s
        self._max = max_keys
        self._lock = threading.Lock()
        self._pending: Optional[_PendingBatch] = None
        self.batches = 0
        self.requests = 0

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        n = int(keys.shape[0])
        with self._lock:
            pb = self._pending
            if pb is None or pb.closed:
                pb = self._pending = _PendingBatch()
            leader = not pb.parts
            off = pb.total
            pb.parts.append(keys)
            pb.total += n
            self.requests += 1
            if pb.total >= self._max:
                pb.closed = True
                if self._pending is pb:
                    self._pending = None
                pb.filled.set()
        if not leader:
            if not pb.done.wait(_BATCH_WAIT_S):
                raise TimeoutError("batch leader never dispatched")
            if pb.error is not None:
                raise pb.error
            return pb.rows[off:off + n]
        if not pb.filled.is_set() and self._window > 0:
            pb.filled.wait(self._window)
        with self._lock:
            pb.closed = True
            if self._pending is pb:
                self._pending = None
            parts = list(pb.parts)
        try:
            allk = parts[0] if len(parts) == 1 else np.concatenate(parts)
            pb.rows = self._gather(allk)
            self.batches += 1
        except BaseException as e:  # noqa: BLE001 - republished per reader
            pb.error = e
            raise
        finally:
            pb.done.set()
        return pb.rows[off:off + n]


def _bucketed_multi_get(table: Any, keys: np.ndarray) -> np.ndarray:
    """``table.multi_get`` with the key count padded up to a power of
    two (min 16). In the reference the pad bounds the jitted gather's
    retraces (every distinct key count is a fresh shape there). The port
    compiles nothing per shape: one K1 launch gathers any count, so the pad
    only makes the launch's size the reference's. It repeats the first key
    (a valid gather whose rows are the same either way), and the caller
    never sees it."""
    n = int(keys.shape[0])
    m = 16
    while m < n:
        m <<= 1
    if m == n:
        return np.asarray(table.multi_get(keys))
    padded = np.concatenate(
        [keys, np.full(m - n, keys[0], dtype=keys.dtype)])
    return np.asarray(table.multi_get(padded))[:n]


def _host_locate(cfg: Any, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy mirror of the jit partitioner math (table/partition.py):
    range tables split contiguously, hash tables interleave."""
    bs = -(-int(cfg.capacity) // int(cfg.num_blocks))
    keys = keys.astype(np.int64)
    if cfg.is_ordered:
        return keys // bs, keys % bs
    return keys % int(cfg.num_blocks), keys // int(cfg.num_blocks)


class _PinnedView:
    """One committed checkpoint-chain epoch, resolved once and served
    many times: manifest + per-block CRC-verified reads, block-cached."""

    __slots__ = ("job", "chkp_id", "epoch", "info", "dir")

    def __init__(self, job: str, chkp_id: str, epoch: int, info: Any,
                 d: str) -> None:
        self.job = job
        self.chkp_id = chkp_id
        self.epoch = epoch
        self.info = info
        self.dir = d


class ServingEndpoint:
    """One serving front end (see module docstring).

    ``table_fn(job_id)`` resolves a job's live DenseTable (None when the
    job is unknown/finished); ``chkp_root`` enables pinned mode;
    ``overload`` is the jobserver's OverloadMonitor (None = always
    admit)."""

    def __init__(
        self,
        table_fn: Optional[Callable[[str], Any]] = None,
        chkp_root: Optional[str] = None,
        overload: Any = None,
        host: str = "127.0.0.1",
        cache_mb: Optional[int] = None,
        window_ms: Optional[float] = None,
        batch_max: Optional[int] = None,
    ) -> None:
        self._host = host
        self._table_fn = table_fn or (lambda job: None)
        self._chkp_root = chkp_root
        self._overload = overload
        mb = cache_mb_from_env() if cache_mb is None else max(0, int(cache_mb))
        self.cache: Optional[ByteLRU] = ByteLRU(mb << 20) if mb else None
        self._window_s = (batch_window_ms_from_env()
                          if window_ms is None else max(0.0, float(window_ms))
                          ) / 1000.0
        self._batch_max = (batch_max_from_env()
                           if batch_max is None else max(1, int(batch_max)))
        self._lock = threading.Lock()
        self._batchers: Dict[Tuple, _Batcher] = {}
        # job -> (table, layout listener, generation): the generation
        # keys the job's live batchers and cached rows to ONE table object
        self._listeners: Dict[str, Tuple[Any, Callable, int]] = {}
        self._table_gen = 0
        self._pinned: Dict[str, Tuple[Optional[_PinnedView], float]] = {}
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._closed = False
        self.port: Optional[int] = None
        # telemetry (lock-guarded; surfaced via stats() -> STATUS)
        self._requests: Dict[str, int] = {}
        self._shed = 0
        self._errors = 0
        self._tenants: Dict[str, Dict[str, Any]] = {}
        self._req_counter = None
        self._shed_counter = None
        try:
            from harmony_tpu_torch.metrics.registry import get_registry

            reg = get_registry()
            self._req_counter = reg.counter(
                "harmony_serving_requests_total",
                "Serving lookups answered, by read mode",
                ("mode",),
            )
            self._shed_counter = reg.counter(
                "harmony_serving_shed_total",
                "Serving lookups shed by admission control",
            )
        except Exception:
            pass  # metrics are an observer, never a dependency

    # -- lifecycle --------------------------------------------------------

    def start(self, port: int = 0) -> int:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self._host, port))
        sock.listen(64)
        with self._lock:
            self._sock = sock
        self.port = sock.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="serving-accept", daemon=True
        )
        self._accept_thread.start()
        return self.port

    def stop(self) -> None:
        with self._lock:
            self._closed = True
            sock, self._sock = self._sock, None
            listeners = list(self._listeners.values())
            self._listeners.clear()
        for table, fn, _gen in listeners:
            try:
                table.remove_layout_listener(fn)
            except Exception:
                pass
        if sock is not None:
            close_listener(sock)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)

    @property
    def address(self) -> Optional[Tuple[str, int]]:
        return (self._host, self.port) if self.port is not None else None

    # -- tenant telemetry -------------------------------------------------

    def _tenant(self, job: str) -> Dict[str, Any]:
        with self._lock:
            st = self._tenants.get(job)
            if st is None:
                st = self._tenants[job] = {
                    "requests": 0, "rows": 0, "shed": 0,
                    "lat_ms": deque(maxlen=_LAT_WINDOW),
                    "slo_p99_ms": slo_ms_from_env(),
                    "pinned_epoch": None,
                    # window accumulators for the ledger flush
                    "w_t0": time.monotonic(), "w_requests": 0,
                    "w_hits": 0, "w_lookups": 0,
                }
            return st

    def set_slo(self, job: str, p99_ms: float) -> None:
        """Override the env-default p99 SLO for one serving tenant."""
        self._tenant(job)["slo_p99_ms"] = max(0.1, float(p99_ms))

    # -- live view --------------------------------------------------------

    def _flush_ledger(self, job: str, st: Dict[str, Any]) -> None:
        """Summarize the window into the tenant ledger (best-effort —
        the ledger is an observer, never a serving dependency)."""
        now = time.monotonic()
        with self._lock:
            dt = now - st["w_t0"]
            if dt < _LEDGER_FLUSH_S or not st["w_requests"]:
                return
            lat = sorted(st["lat_ms"])
            p50 = lat[len(lat) // 2] if lat else None
            p99 = (lat[min(len(lat) - 1, int(len(lat) * 0.99))]
                   if lat else None)
            hit = (st["w_hits"] / st["w_lookups"]
                   if st["w_lookups"] else None)
            qps = st["w_requests"] / dt
            b_req = sum(b.requests for k, b in self._batchers.items()
                        if k[0] == job)
            b_n = sum(b.batches for k, b in self._batchers.items()
                      if k[0] == job)
            occ = (b_req / b_n) if b_n else None
            st["w_t0"] = now
            st["w_requests"] = st["w_hits"] = st["w_lookups"] = 0
        try:
            from harmony_tpu_torch.metrics.accounting import ledger

            ledger().set_serving_state(
                job, enabled=True, qps=qps, p50_ms=p50, p99_ms=p99,
                slo_p99_ms=st["slo_p99_ms"], batch_occupancy=occ,
                cache_hit_rate=hit,
            )
        except Exception:
            pass
        slo = st["slo_p99_ms"]
        if p99 is not None and slo is not None and p99 > slo:
            # structured trigger evidence for the incident engine: the
            # windowed read path missed its objective
            try:
                from harmony_tpu_torch.jobserver.joblog import record_event

                record_event(job, "serving_slo", p99_ms=round(p99, 3),
                             slo_p99_ms=round(slo, 3),
                             qps=round(qps, 3))
            except Exception:
                pass

    def _watch_layout(self, job: str, table: Any) -> int:
        """Hook this job's table announcements: a reshard drops every
        cached live row of the job — the same invalidation staged
        batches get (LayoutAnnouncerMixin). Returns the table's
        generation. A job id submitted again gets a new table whose
        layout and data versions restart at 0, so a new table object
        retires the job's earlier listener, live batchers and cached
        rows, and its generation keys everything read from it."""
        with self._lock:
            cur = self._listeners.get(job)
            if cur is not None and cur[0] is table:
                return cur[2]
            self._table_gen += 1
            gen = self._table_gen
            if self._closed:
                return gen

            def on_layout(_mesh: Any, _job: str = job) -> None:
                if self.cache is not None:
                    self.cache.drop(
                        lambda k: k[0] == _job and k[1] == "L")

            self._listeners[job] = (table, on_layout, gen)
            for k in [k for k in self._batchers
                      if k[0] == job and k[1] == "live"]:
                self._batchers.pop(k)
        if cur is not None:
            try:
                cur[0].remove_layout_listener(cur[1])
            except Exception:
                pass
            if self.cache is not None:
                self.cache.drop(lambda k: k[0] == job and k[1] == "L")
        try:
            table.add_layout_listener(on_layout)
        except Exception:
            with self._lock:
                if self._listeners.get(job, (None,))[0] is table:
                    self._listeners.pop(job)
        return gen

    def _live_gather(self, job: str, gen: int, table: Any, st: Dict[str, Any],
                     keys: np.ndarray) -> np.ndarray:
        """One batched gather against the live table: cache-hit rows are
        filled from the ByteLRU, misses go through ONE multi_get (the
        lock-held, donation-safe read path — never a raw array access)
        and land back in the cache under the current layout AND data
        versions. The data version must be read BEFORE the gather: a
        write landing between gather and cache-put then parks old rows
        under the already-dead generation, never fresh-keyed stale
        rows."""
        lv = int(getattr(table, "layout_version", 0))
        dv = int(getattr(table, "data_version", 0))
        cache = self.cache
        if cache is None:
            vals = _bucketed_multi_get(table, keys.astype(np.int32))
            with self._lock:
                st["w_lookups"] += len(keys)
            return vals
        spec = table.spec
        out = np.empty((len(keys), *spec.value_shape),
                       dtype=np.dtype(spec.config.dtype))
        miss_i: List[int] = []
        hits = 0
        for i, k in enumerate(keys):
            row = cache.get((job, "L", gen, lv, dv, int(k)))
            if row is None:
                miss_i.append(i)
            else:
                out[i] = row
                hits += 1
        if miss_i:
            mk = keys[np.asarray(miss_i, dtype=np.int64)]
            vals = _bucketed_multi_get(table, mk.astype(np.int32))
            for j, i in enumerate(miss_i):
                out[i] = vals[j]
                cache.put((job, "L", gen, lv, dv, int(keys[i])),
                          np.array(vals[j], copy=True))
        with self._lock:
            st["w_hits"] += hits
            st["w_lookups"] += len(keys)
        return out

    # -- pinned view ------------------------------------------------------

    def _resolve_pinned(self, job: str) -> Optional[_PinnedView]:
        """Newest COMMITTED chain epoch of ``job`` (entity.py's chain
        contract: ids prefixed ``{job}:``, manifests stamped
        ``app_meta={"epoch": N}``), re-scanned on a short TTL so new
        commits become servable without a restart."""
        now = time.monotonic()
        with self._lock:
            hit = self._pinned.get(job)
            if hit is not None and now - hit[1] < _PIN_TTL_S:
                return hit[0]
        view = self._scan_chain(job)
        with self._lock:
            self._pinned[job] = (view, now)
        return view

    def _scan_chain(self, job: str) -> Optional[_PinnedView]:
        if not self._chkp_root:
            return None
        from harmony_tpu_torch.checkpoint.manager import CheckpointManager

        try:
            mgr = CheckpointManager.for_job(self._chkp_root, job)
            ids = mgr.list_checkpoints()
        except OSError:
            return None
        best: Optional[Tuple[Tuple[int, float], _PinnedView]] = None
        for cid in ids:
            if not cid.startswith(f"{job}:"):
                continue
            try:
                info = mgr.info(cid)
            except Exception:
                continue
            if not info.committed:
                continue
            try:
                epoch = int((info.app_meta or {}).get("epoch"))
            except (TypeError, ValueError):
                continue
            rank = (epoch, float(info.created_at or 0.0))
            if best is None or rank > best[0]:
                best = (rank, _PinnedView(job, cid, epoch, info,
                                          mgr._dir_of(cid)))
        return best[1] if best else None

    def _pinned_block(self, view: _PinnedView, bid: int) -> np.ndarray:
        key = (view.job, "P", view.chkp_id, int(bid))
        if self.cache is not None:
            block = self.cache.get(key)
            if block is not None:
                return block
        from harmony_tpu_torch.checkpoint.manager import _read_block

        crcs = view.info.block_checksums or {}
        block = _read_block(view.dir, int(bid),
                            expected_crc=crcs.get(str(bid)))
        if self.cache is not None:
            self.cache.put(key, block)
        return block

    def _pinned_gather(self, view: _PinnedView, st: Dict[str, Any],
                       keys: np.ndarray) -> np.ndarray:
        """Gather from the pinned epoch's CRC-verified blocks — the
        response bytes ARE the checkpoint bytes (no device round trip),
        which is what makes the bench's consistency gate bit-exact."""
        cfg = view.info.table_config
        blocks, offs = _host_locate(cfg, keys)
        vshape = tuple(cfg.value_shape)
        out = np.empty((len(keys), *vshape), dtype=np.dtype(cfg.dtype))
        for i in range(len(keys)):
            block = self._pinned_block(view, int(blocks[i]))
            out[i] = np.asarray(block).reshape(-1, *vshape)[int(offs[i])]
        with self._lock:
            st["w_lookups"] += len(keys)
        return out

    # -- dispatch ---------------------------------------------------------

    def _batcher(self, key: Tuple,
                 gather_fn: Callable[[np.ndarray], np.ndarray]) -> _Batcher:
        with self._lock:
            b = self._batchers.get(key)
            if b is None:
                # a new view (layout bump / newer pinned epoch) retires
                # the job's previous batcher of the same mode — keep its
                # cumulative counters for occupancy accounting bounded
                stale = [k for k in self._batchers
                         if k[0] == key[0] and k[1] == key[1]]
                for k in stale[:-8]:
                    self._batchers.pop(k, None)
                b = self._batchers[key] = _Batcher(
                    gather_fn, self._window_s, self._batch_max)
            return b

    def lookup(self, job: str, keys: np.ndarray,
               mode: str = "live") -> Tuple[np.ndarray, Dict[str, Any]]:
        """One lookup through the full production path (batcher + cache
        + view). Returns ``(rows, meta)`` where meta carries the
        consistency fields the wire response reports. Raises
        LookupError/ValueError on unknown jobs/modes — the conn loop
        maps those to error frames."""
        keys = np.asarray(keys)
        if keys.ndim != 1 or keys.shape[0] == 0:
            raise ValueError("keys must be a non-empty 1-d array")
        if keys.shape[0] > _MAX_KEYS:
            raise ValueError(f"lookup of {keys.shape[0]} keys exceeds "
                             f"the {_MAX_KEYS}-key request bound")
        st = self._tenant(job)
        t0 = time.perf_counter()
        if mode == "live":
            table = self._table_fn(job)
            if table is None:
                raise LookupError(f"no live table for job {job!r}")
            gen = self._watch_layout(job, table)
            lv = int(getattr(table, "layout_version", 0))
            b = self._batcher(
                (job, "live", gen, lv),
                lambda ks, _t=table, _s=st: self._live_gather(job, gen, _t, _s, ks))
            rows = b.lookup(keys)
            meta: Dict[str, Any] = {"mode": "live", "layout_version": lv}
        elif mode == "pinned":
            view = self._resolve_pinned(job)
            if view is None:
                raise LookupError(
                    f"no committed pinned epoch for job {job!r}")
            if view.info.table_config.sparse:
                # a hash block is ONE packed uint8 array (slot keys, then
                # values): rows are not at a key's offset in it
                raise ValueError(
                    f"pinned reads of job {job!r} refused: its chain holds a "
                    "hash table, whose blocks pack slot keys and values "
                    "(rows by key offset do not exist there)")
            b = self._batcher(
                (job, "pinned", view.chkp_id),
                lambda ks, _v=view, _s=st: self._pinned_gather(_v, _s, ks))
            rows = b.lookup(keys)
            meta = {"mode": "pinned", "epoch": view.epoch,
                    "chkp": view.chkp_id}
        else:
            raise ValueError(f"unknown read mode {mode!r}")
        lat_ms = (time.perf_counter() - t0) * 1000.0
        with self._lock:
            st["requests"] += 1
            st["rows"] += int(keys.shape[0])
            st["lat_ms"].append(lat_ms)
            st["w_requests"] += 1
            if mode == "pinned":
                st["pinned_epoch"] = meta["epoch"]
        if self._req_counter is not None:
            try:
                self._req_counter.labels(mode=mode).inc()
            except Exception:
                pass
        self._flush_ledger(job, st)
        return rows, meta

    # -- wire -------------------------------------------------------------

    def _admit(self) -> Optional[int]:
        """None admits; otherwise the busy frame's retry hint (ms). The
        jobserver's overload ladder answers — a read storm sheds at the
        serving edge instead of wedging the control plane."""
        ov = self._overload
        if ov is None:
            return None
        try:
            if ov.shedding():
                try:
                    ov.count_shed("serving_lookup")
                except Exception:
                    pass
                return int(ov.retry_after_ms())
        except Exception:
            return None
        return None

    def _accept_loop(self) -> None:
        sock = self._sock
        while True:
            try:
                conn, _ = sock.accept()
            except OSError:
                return  # closed
            # peers are closed-loop serving clients (long-lived connections,
            # one per reader); storms shed at admission, not at accept
            threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="serving-conn", daemon=True,
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        from harmony_tpu_torch.utils.framing import set_nodelay

        with conn:
            set_nodelay(conn)
            while True:
                try:
                    msg = protocol.recv_frame(conn)
                except OSError:
                    return  # desynced/dead peer: drop the connection
                if msg is None:
                    return
                op = str(msg.get("op"))
                with self._lock:
                    self._requests[op] = self._requests.get(op, 0) + 1
                try:
                    if op == "lookup":
                        self._serve_lookup(conn, msg)
                    elif op == "stats":
                        protocol.send_msg(
                            conn, {"op": "stats", "stats": self.stats()})
                    elif op == "ping":
                        protocol.send_msg(conn, {"op": "pong"})
                    else:
                        protocol.send_msg(
                            conn,
                            {"op": "error", "error": f"unknown op {op!r}"})
                except OSError:
                    return  # peer went away mid-reply
                except Exception as e:  # noqa: BLE001 - reported to peer
                    with self._lock:
                        self._errors += 1
                    try:
                        protocol.send_msg(conn, {
                            "op": "error", "r": msg.get("r"),
                            "error": f"{type(e).__name__}: {e}",
                        })
                    except OSError:
                        return

    def _serve_lookup(self, conn: socket.socket,
                      msg: Dict[str, Any]) -> None:
        rid = msg.get("r")
        retry = self._admit()
        if retry is not None:
            with self._lock:
                self._shed += 1
            job = str(msg.get("job", "?"))
            st = self._tenants.get(job)
            if st is not None:
                with self._lock:
                    st["shed"] += 1
            if self._shed_counter is not None:
                try:
                    self._shed_counter.inc()
                except Exception:
                    pass
            protocol.send_msg(conn, {"op": "busy", "r": rid,
                                     "retry_after_ms": retry})
            return
        data = msg.get("data") or ()
        if len(data) != 1:
            raise ValueError("lookup carries exactly one key array")
        rows, meta = self.lookup(str(msg.get("job", "")), data[0],
                                 mode=str(msg.get("mode", "live")))
        protocol.send_arrays(
            conn, {"op": "rows", "r": rid, **meta}, (rows,))

    # -- observability ----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            batches = sum(b.batches for b in self._batchers.values())
            breqs = sum(b.requests for b in self._batchers.values())
            tenants = {}
            for job, st in self._tenants.items():
                lat = sorted(st["lat_ms"])
                tenants[job] = {
                    "requests": st["requests"],
                    "rows": st["rows"],
                    "shed": st["shed"],
                    "p50_ms": (round(lat[len(lat) // 2], 3)
                               if lat else None),
                    "p99_ms": (round(
                        lat[min(len(lat) - 1, int(len(lat) * 0.99))], 3)
                        if lat else None),
                    "slo_p99_ms": st["slo_p99_ms"],
                    "pinned_epoch": st["pinned_epoch"],
                }
            out = {
                "port": self.port,
                "requests": dict(self._requests),
                "shed": self._shed,
                "errors": self._errors,
                "batches": batches,
                "batch_occupancy": (round(breqs / batches, 3)
                                    if batches else None),
                "window_ms": self._window_s * 1000.0,
                "batch_max": self._batch_max,
                "tenants": tenants,
            }
        out["cache"] = self.cache.stats() if self.cache is not None else None
        return out
