"""DenseTable — the partitioned model table, on one device.

Counterpart of ``harmony_tpu/table/table.py``. Storage is ONE dense tensor
``[num_blocks, block_size, *value_shape]``; keys map to (block, offset) through
the table's hash or range partitioner. :class:`TableSpec` holds the device ops
a trainer's step calls (pull, push, push_all, write_all); :class:`DenseTable`
is the host-side handle that serialises access to the storage.

The reference's device state is functional: a step takes the array and
returns a new one, and JAX donates the old buffer. Here the ops update the
storage IN PLACE instead (no second table-sized buffer per step) and return
it. What made the functional version safe is kept by the lock: a step runs
and commits under the table lock (:meth:`DenseTable.apply_step`), and host
readers (:meth:`DenseTable.multi_get`, :meth:`DenseTable.pull_array`) enqueue
their read under the same lock, so no reader sees a half-applied push.

On the card the lock orders the host's enqueues, and :class:`StreamOrder`
orders the device's work across streams (a serving thread reads on its own
stream while the job's workers write on theirs): a read waits for the last
write's stream, and the next write waits for the reads. ``multi_get``
dispatches under the lock and waits for its rows outside it, as the
reference does, so a read never holds the lock across a device sync.

The checkpoint path's per-block I/O (``snapshot_blocks``, ``export_blocks``,
``import_blocks``) works on whole blocks, the storage's first dimension; a
snapshot is a device COPY, since steps update the storage in place.

The keyed pull goes through ``gather_rows`` (K1); the keyed push's duplicate
fold through ``weighted_histogram``/``segment_sum`` (K3, ``via="mxu"``) or
``segment_sum_rows`` (K2, ``via="sparse"``). On the card these are the
hand-written kernels; on the CPU their plain versions.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.ops.histogram import segment_sum
from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows, value_width
from harmony_tpu_torch.table.partition import (
    BlockPartitioner,
    HashPartitioner,
    RangePartitioner,
)
from harmony_tpu_torch.table.update import UpdateFunction, get_update_fn
from harmony_tpu_torch.utils.platform import DeviceLike, env_choice, resolve_device

PUSH_ROUTES = ("scatter", "mxu", "mxu_auto", "sparse")


class BlockSnapshot:
    """``snapshot_blocks``' result: a copy of some of a table's blocks on its
    device, taken in one operation per storage tensor (``parts``: the dense
    storage, or a hash table's slot keys and values), each part's first
    dimension running over ``ids``. ``snap[b]`` is block ``b``'s view (a
    tensor, or a (slot_keys, values) pair); the views are made on request,
    so taking a snapshot of thousands of blocks costs no per-block work.

    The copy is enqueued on the stream of the thread that takes the snapshot
    (a job's worker runs on its dispatch thread's stream), and ``ready`` is
    an event recorded there after it. :meth:`to_host` (a background
    checkpoint writer's, on another thread) copies each part to pinned host
    memory on a stream of its own that first waits for ``ready``: one
    device-to-host copy a part, ordered after the snapshot's copy and not
    behind the training steps enqueued since."""

    def __init__(self, ids: Sequence[int], parts: Tuple[torch.Tensor, ...],
                 device: torch.device) -> None:
        self.ids = [int(b) for b in ids]
        self.parts = parts
        self._row: Optional[Dict[int, int]] = None  # block id -> row, on first use
        self.ready: Optional["torch.cuda.Event"] = None
        if device.type == "cuda":
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(device))

    def __len__(self) -> int:
        return len(self.ids)

    def __iter__(self):
        return iter(self.ids)

    def __getitem__(self, b: int):
        if self._row is None:
            self._row = {bid: i for i, bid in enumerate(self.ids)}
        i = self._row[int(b)]
        views = tuple(p[i] for p in self.parts)
        return views[0] if len(views) == 1 else views

    def to_host(self) -> List[np.ndarray]:
        """Each part as a host array (the codec's dtypes; bfloat16 is refused,
        as the reference refuses it)."""
        for p in self.parts:
            _check_codec_dtype(p)
        if self.ready is None:
            return [p.cpu().numpy() for p in self.parts]
        stream = torch.cuda.Stream(self.ready.device)
        with torch.cuda.stream(stream):
            stream.wait_event(self.ready)
            hosts = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True) for p in self.parts]
            for h, p in zip(hosts, self.parts):
                h.copy_(p, non_blocking=True)
        # the device parts stay referenced until the copies have finished
        stream.synchronize()
        return [h.numpy() for h in hosts]


class StreamOrder:
    """Orders a table's device work across CUDA streams; every method runs
    under the host's table lock, and each is a no-op off the card.

    A write (a step's in-place update and its commit, or a host op) calls
    :meth:`_before_write` before it enqueues anything and :meth:`_after_write`
    once it has: the stream it ran on is kept as the last write's. A read
    calls :meth:`_before_read`, which records an event on that stream and has
    the reader's stream wait on it (the read follows every committed write,
    whichever stream wrote it), and :meth:`_after_read`, which records an
    event on the reader's stream that the next write waits on (a later
    in-place write never overtakes a read still queued on another stream).
    Writers on one stream pay a comparison a write; the events are made only
    when a second stream reads. Hosts set ``self.device``, call
    :meth:`_init_order` and hold ``self._lock``. Every host read of a table
    is ordered so; the ``array`` and ``state`` properties hand out the live
    storage itself, which is ordered only on the last write's stream."""

    def _init_order(self) -> None:
        """Called once the initial storage is enqueued: that is the first
        write's stream."""
        self._data_version = 0
        self._write_stream: Optional["torch.cuda.Stream"] = self._stream()
        self._read_events: Dict["torch.cuda.Stream", "torch.cuda.Event"] = {}
        self._write_event: Optional["torch.cuda.Event"] = None

    def _stream(self) -> Optional["torch.cuda.Stream"]:
        if self.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.device)

    def _before_write(self) -> None:
        s = self._stream()
        if s is None:
            return
        last = self._write_stream
        if last is not None and last != s:   # a write on another stream first
            ev = torch.cuda.Event()
            ev.record(last)
            s.wait_event(ev)
        for reader, ev in self._read_events.items():
            if reader != s:
                s.wait_event(ev)
        self._read_events.clear()

    def _after_write(self) -> None:
        self._data_version += 1
        s = self._stream()
        if s is not None:
            self._write_stream = s

    def _before_read(self) -> None:
        s = self._stream()
        last = self._write_stream
        if s is None or last is None or last == s:
            return
        if self._write_event is None:
            self._write_event = torch.cuda.Event()
        self._write_event.record(last)
        s.wait_event(self._write_event)

    def _after_read(self) -> None:
        s = self._stream()
        if s is None or s == self._write_stream:
            return
        ev = self._read_events.get(s)
        if ev is None:
            ev = self._read_events[s] = torch.cuda.Event()
        ev.record(s)

    @property
    def data_version(self) -> int:
        """Monotonic count of storage writes (a serving cache keys its rows
        by it, so a write retires them)."""
        with self._lock:
            return self._data_version


class LayoutAnnouncerMixin:
    """Reshard announcements, shared by dense and hash tables (the
    reference's mixin, ``harmony_tpu/table/table.py:136-200``): listeners
    run with the target layout before a reshard, and ``layout_version``
    counts the announcements. The port has no reshard yet (ROADMAP A.10);
    the serving cache listens, and drops a job's live rows on each
    announcement. The reference's ``comm_split`` pair is left out: the
    port's worker keeps its probe's split itself
    (``WorkerTasklet._comm_probe_times``). Hosts init
    ``self._layout_listeners = []`` and hold ``self._lock``."""

    def add_layout_listener(self, fn) -> None:
        with self._lock:
            self._layout_listeners.append(fn)

    def remove_layout_listener(self, fn) -> None:
        with self._lock:
            if fn in self._layout_listeners:
                self._layout_listeners.remove(fn)

    @property
    def layout_version(self) -> int:
        """Monotonic count of reshard announcements."""
        with self._lock:
            return getattr(self, "_layout_version", 0)

    def announce_reshard(self, target) -> None:
        """Run the listeners with ``target`` (outside the table lock).
        Best-effort: a failing listener never blocks the migration."""
        with self._lock:
            listeners = list(self._layout_listeners)
            self._layout_version = getattr(self, "_layout_version", 0) + 1
        for fn in listeners:
            try:
                fn(target)
            except Exception:
                pass


def _check_codec_dtype(t: torch.Tensor) -> None:
    if t.dtype == torch.bfloat16:
        raise TypeError(f"unsupported block dtype {t.dtype}")


class TableSpec:
    """Static description of a table + its device ops (which update the
    storage in place and return it)."""

    def __init__(self, config: TableConfig,
                 update_fn: Optional[UpdateFunction] = None) -> None:
        self.config = config
        self.update_fn = update_fn or get_update_fn(config.update_fn)
        part_cls = RangePartitioner if config.is_ordered else HashPartitioner
        self.partitioner: BlockPartitioner = part_cls(config.capacity,
                                                      config.num_blocks)
        self.value_shape: Tuple[int, ...] = tuple(config.value_shape)
        self.dtype: torch.dtype = getattr(torch, config.dtype)

    @property
    def table_id(self) -> str:
        return self.config.table_id

    @property
    def num_blocks(self) -> int:
        return self.partitioner.num_blocks

    @property
    def block_size(self) -> int:
        return self.partitioner.block_size

    @property
    def num_rows(self) -> int:
        """Stored rows, padding of the last block included."""
        return self.num_blocks * self.block_size

    @property
    def storage_shape(self) -> Tuple[int, ...]:
        return (self.num_blocks, self.block_size, *self.value_shape)

    def _is_range(self) -> bool:
        return isinstance(self.partitioner, RangePartitioner)

    def _all_keys(self, device: torch.device) -> torch.Tensor:
        return torch.arange(self.config.capacity, dtype=torch.int32, device=device)

    # -- device ops -------------------------------------------------------

    def init_array(self, device: torch.device) -> torch.Tensor:
        """Initial storage from the update fn's ``init`` (getOrInit semantics:
        every key starts at its init value), broadcast to the value shape."""
        b = torch.arange(self.num_blocks, dtype=torch.int32, device=device)[:, None]
        o = torch.arange(self.block_size, dtype=torch.int32, device=device)[None, :]
        keys = self.partitioner.key_of(b, o).reshape(-1)
        vals = self.update_fn.init(keys)
        if vals.ndim == 1 and self.value_shape:
            vals = vals.reshape(-1, *([1] * len(self.value_shape))).expand(
                keys.shape[0], *self.value_shape)
        return vals.to(self.dtype).reshape(self.storage_shape).contiguous()

    def _flat_index(self, b: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        return (b * self.block_size + o).to(torch.int32)

    def _in_bounds(self, b: torch.Tensor, o: torch.Tensor):
        """Flat rows of the (block, offset) pairs inside the storage, and the
        mask of those pairs: out-of-range pairs write nothing. The reference's
        scatter drops pairs past the end but wraps a negative block or offset
        NumPy-style (key -1 of a range table lands on the last padding row);
        its own folds (``mxu``, ``sparse``) drop negative ids. The port drops
        every out-of-range pair, on every route."""
        ok = (b >= 0) & (b < self.num_blocks) & (o >= 0) & (o < self.block_size)
        return self._flat_index(b[ok], o[ok]).long(), ok

    def pull(self, arr: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        """multiGetOrInit: gather values for ``keys`` -> [*keys.shape, *value_shape]
        through ``gather_rows`` (K1)."""
        b, o = self.partitioner.locate(keys)
        flat_idx = self._flat_index(b, o)
        flat = arr.reshape(self.num_rows, value_width(self.value_shape))
        rows = gather_rows(flat, flat_idx.reshape(-1))
        return rows.reshape(*flat_idx.shape, *self.value_shape)

    def pull_all(self, arr: torch.Tensor) -> torch.Tensor:
        """Whole table as ``[capacity, *value_shape]`` in key order. For a range
        table this is a VIEW of the storage."""
        if self._is_range():
            flat = arr.reshape(self.num_rows, *self.value_shape)
            return flat[: self.config.capacity]
        return self.pull(arr, self._all_keys(arr.device))

    def _post_touched(self, arr: torch.Tensor, b: torch.Tensor, o: torch.Tensor) -> None:
        flat = arr.view(self.num_rows, *self.value_shape)
        idx, _ = self._in_bounds(b.reshape(-1), o.reshape(-1))
        flat[idx] = self.update_fn.post(flat[idx])

    def push(self, arr: torch.Tensor, keys: torch.Tensor, deltas: torch.Tensor,
             *, via: str = "auto") -> torch.Tensor:
        """multiUpdate: fold ``deltas`` into the table IN PLACE (duplicate keys
        fold per the update fn's scatter_mode) and return ``arr``.

        ``via`` picks the lowering of additive pushes, as in the reference:
          * "scatter" — one indexed scatter (``index_add_`` / ``index_reduce_``
            / indexed set).
          * "mxu" — fold duplicates with ``segment_sum`` (K3) into a flat-row
            delta and apply ONE dense add.
          * "mxu_auto" — "mxu" when the push touches >= capacity/256 keys
            (at least 32), else "scatter".
          * "sparse" — fold with ``segment_sum_rows`` (K2), then one dense add.
          * "auto" — "scatter" (callers that know the device pass
            ``DenseTable.push_via`` explicitly).
        """
        b, o = self.partitioner.locate(keys)
        mode = self.update_fn.scatter_mode
        if via == "auto":
            via = "scatter"
        elif via == "mxu_auto":
            dense_enough = keys.shape[0] >= max(32, self.config.capacity // 256)
            via = "mxu" if mode == "add" and dense_enough else "scatter"
        if via in ("mxu", "sparse"):
            if mode != "add":
                raise ValueError(f"via={via!r} requires an additive update fn")
            fold = segment_sum if via == "mxu" else segment_sum_rows
            n = keys.shape[0]
            folded = fold(deltas.reshape(n, -1).float(),
                          self._flat_index(b, o).reshape(-1), self.num_rows)
            arr.add_(folded.reshape(arr.shape).to(arr.dtype))  # in place
        elif via == "scatter":
            flat = arr.view(self.num_rows, *self.value_shape)
            idx, ok = self._in_bounds(b.reshape(-1), o.reshape(-1))
            d = deltas.reshape(-1, *self.value_shape).to(arr.dtype)[ok]
            if mode == "add":
                flat.index_add_(0, idx, d)
            elif mode == "min":
                flat.index_reduce_(0, idx, d, "amin")
            elif mode == "max":
                flat.index_reduce_(0, idx, d, "amax")
            elif mode == "set":
                flat[idx] = d
            else:
                raise ValueError(f"unknown scatter_mode {mode!r}")
        else:
            raise ValueError(f"unknown push route {via!r}")
        if self.update_fn.post is not None:
            # apply-time invariant on the touched entries only
            self._post_touched(arr, b, o)
        return arr

    def _pad_to_storage(self, values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """[capacity, *vshape] in key order -> storage layout (range tables)."""
        pad = self.num_rows - self.config.capacity
        v = values.to(dtype)
        if pad:
            v = torch.cat([v, torch.zeros((pad, *self.value_shape), dtype=dtype,
                                          device=v.device)])
        return v.reshape(self.storage_shape)

    def push_all(self, arr: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
        """Dense full-model push of a ``[capacity, *value_shape]`` delta into
        every key, IN PLACE; returns ``arr``."""
        mode = self.update_fn.scatter_mode
        if not self._is_range():
            return self.push(arr, self._all_keys(arr.device), deltas)
        if mode == "set":
            return self.write_all(arr, deltas)
        d = self._pad_to_storage(deltas, arr.dtype)
        if mode == "add":
            arr.add_(d)
        elif mode == "min":
            torch.minimum(arr, d, out=arr)
        elif mode == "max":
            torch.maximum(arr, d, out=arr)
        else:
            raise ValueError(f"unknown scatter_mode {mode!r}")
        if self.update_fn.post is not None:
            arr.copy_(self.update_fn.post(arr))  # every entry is touched here
        return arr

    def write_all(self, arr: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        """Overwrite the whole table from ``[capacity, *value_shape]`` in key
        order, IN PLACE; returns ``arr``."""
        if self._is_range():
            arr.copy_(self._pad_to_storage(values, self.dtype))
            return arr
        b, o = self.partitioner.locate(self._all_keys(arr.device))
        arr[b.long(), o.long()] = values.to(self.dtype)
        return arr


class DenseTable(StreamOrder, LayoutAnnouncerMixin):
    """Host-side handle on one device: serialised steps and host accessors.

    Every write (a step's commit, multi_update, multi_put, write_all) and every
    host read is enqueued under ``_lock``; storage writes bump
    ``data_version``, and :class:`StreamOrder` orders them on the card."""

    def __init__(self, spec: TableSpec, device: DeviceLike = None,
                 arr: Optional[torch.Tensor] = None) -> None:
        self.spec = spec
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        if arr is None:
            arr = spec.init_array(self.device)
        elif tuple(arr.shape) != spec.storage_shape:
            raise ValueError(
                f"storage shape {tuple(arr.shape)} != {spec.storage_shape}")
        self._arr = arr.to(self.device, spec.dtype).contiguous()
        self._layout_listeners: list = []
        self._init_order()

    @property
    def array(self) -> torch.Tensor:
        """The live storage. Steps update it in place: a host reader that needs
        a stable value copies it under the table lock (multi_get, pull_array)."""
        with self._lock:
            return self._arr

    @property
    def _step_state(self) -> torch.Tensor:
        """What a step function receives (``DeviceHashTable``'s counterpart is
        its (slot_keys, values) pair)."""
        return self._arr

    def commit(self, new_arr: torch.Tensor) -> None:
        """Install the post-step storage (a step that updated in place hands
        back the same tensor) and count the write."""
        with self._lock:
            if (tuple(new_arr.shape) != self.spec.storage_shape
                    or new_arr.dtype != self.spec.dtype
                    or new_arr.device != self._arr.device):
                raise ValueError("commit: storage shape, dtype or device changed")
            self._arr = new_arr
            self._after_write()

    def apply_step(self, step_fn: Callable, *extra):
        """Run ``step_fn(arr, *extra) -> (new_arr, aux)`` and commit its result,
        both under the table lock, so no host accessor sees a half-applied
        step. Returns ``aux``."""
        with self._lock:
            self._before_write()
            new_arr, aux = step_fn(self._arr, *extra)
            self.commit(new_arr)
        return aux

    def apply_step_with(self, local: "DenseTable", step_fn: Callable, *extra):
        """Run ``step_fn(arr, local_arr, *extra) -> ((new_arr, new_local), aux)``
        and commit both results, under both locks. Returns ``aux``.

        Lock order: this (the job's model) table's lock, then ``local``'s. Every
        path that holds both takes them in that order and every host accessor
        takes one, so no two threads (two jobs, or a job and a reader) can each
        hold one of the pair and wait for the other."""
        return DenseTable.apply_step_multi([self, local], step_fn, *extra)

    @staticmethod
    def apply_step_multi(tables: Sequence["DenseTable"], step_fn: Callable, *extra):
        """Run ``step_fn(arr0, arr1, ..., *extra) -> ((new0, new1, ...), aux)``
        over several tables and commit each table's result, all under their
        locks. Returns ``aux``.

        The locks are taken in the order given. A caller whose tables another
        thread also steps together passes them in one fixed order, as
        :meth:`apply_step_with` does; the Pregel master's tables are its own."""
        with contextlib.ExitStack() as stack:
            for t in tables:
                stack.enter_context(t._lock)
                t._before_write()
            new_arrs, aux = step_fn(*(t._step_state for t in tables), *extra)
            for t, new in zip(tables, new_arrs):
                t.commit(new)
        return aux

    def drop(self) -> None:
        """Release the storage (the reference's ``AllocatedTable.drop``); the
        table holds none afterwards (``array`` is None)."""
        with self._lock:
            self._arr = None

    # -- per-block I/O (the checkpoint path) ------------------------------

    def snapshot_blocks(self, block_ids: Optional[Sequence[int]] = None
                        ) -> BlockSnapshot:
        """Device-side snapshot of blocks, taken under the table lock.

        The reference returns views of an immutable array; here steps update
        the storage in place, so a view would change under a later step. The
        blocks are COPIED, in one operation enqueued on the calling thread's
        stream (ordered after every step enqueued there and before every
        later one), and nothing moves to the host here (see
        :class:`BlockSnapshot`)."""
        ids = (list(range(self.spec.num_blocks)) if block_ids is None
               else [int(b) for b in block_ids])
        with self._lock:
            self._before_read()
            if block_ids is None:  # the whole storage
                copy = self._arr.clone()
            else:
                copy = torch.stack([self._arr[b] for b in ids])
            self._after_read()
            return BlockSnapshot(ids, (copy,), self.device)

    def export_blocks(self, block_ids: Optional[Sequence[int]] = None
                      ) -> Dict[int, np.ndarray]:
        """Blocks as host arrays, copied under the lock."""
        snap = self.snapshot_blocks(block_ids)
        (host,) = snap.to_host()
        return {b: host[i] for i, b in enumerate(snap.ids)}

    def import_blocks(self, blocks: Dict[int, np.ndarray]) -> None:
        """Set whole blocks from host payloads (the restore path), cast to the
        table's dtype, as the reference's ``.at[ids].set(payload)``."""
        if not blocks:
            return
        ids = sorted(blocks)
        payload = torch.as_tensor(np.stack([np.asarray(blocks[b]) for b in ids]))
        payload = payload.to(self.device, self.spec.dtype)
        idx = torch.as_tensor(ids, device=self.device)
        with self._lock:
            self._before_write()
            self._arr[idx] = payload
            self._after_write()

    def _to_device(self, x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def multi_get(self, keys: Sequence[int]) -> np.ndarray:
        """Values of ``keys`` as a host array. The gather (K1) is dispatched
        under the lock, after the last committed write; the wait for its rows
        and their copy to the host happen outside it (the reference's
        ``multi_get`` dispatches under its lock and materialises outside)."""
        k = self._to_device(keys, torch.int32)
        with self._lock:
            self._before_read()
            rows = self.spec.pull(self._arr, k)
            self._after_read()
        return rows.cpu().numpy()

    def get(self, key: int) -> np.ndarray:
        return self.multi_get([key])[0]

    # getOrInit is get: every key's storage starts at its init value
    # (TableSpec.init_array), so an absent key already reads as init.
    get_or_init = get
    multi_get_or_init = multi_get

    @property
    def push_via(self) -> str:
        """Keyed-push route for this table's device: the size-gated fold
        ("mxu_auto") for additive tables on the card, the scatter on the CPU.
        ``HARMONY_PUSH_VIA`` (scatter|mxu|mxu_auto|sparse) overrides."""
        forced = env_choice("HARMONY_PUSH_VIA", PUSH_ROUTES)
        if forced:
            return forced
        return ("mxu_auto"
                if self.device.type == "cuda"
                and self.spec.update_fn.scatter_mode == "add"
                else "scatter")

    def multi_update(self, keys: Sequence[int], deltas) -> None:
        k = self._to_device(keys, torch.int32)
        d = self._to_device(deltas)
        with self._lock:
            self._before_write()
            self.spec.push(self._arr, k, d, via=self.push_via)
            self._after_write()

    def multi_put(self, keys: Sequence[int], values) -> None:
        """Bulk set (the bulk-load insertion path); out-of-range keys write
        nothing."""
        k = self._to_device(keys, torch.int32)
        v = self._to_device(values)
        b, o = self.spec.partitioner.locate(k)
        with self._lock:
            self._before_write()
            ok = ((b >= 0) & (b < self.spec.num_blocks)
                  & (o >= 0) & (o < self.spec.block_size))
            self._arr[b[ok].long(), o[ok].long()] = v[ok].to(self.spec.dtype)
            self._after_write()

    def write_all(self, values) -> None:
        """Whole-table key-order overwrite."""
        v = self._to_device(values)
        with self._lock:
            self._before_write()
            self.spec.write_all(self._arr, v)
            self._after_write()

    def pull_array(self) -> torch.Tensor:
        """Full table in key order, as a device tensor copied under the lock."""
        with self._lock:
            self._before_read()
            out = self.spec.pull_all(self._arr).clone()
            self._after_read()
            return out
