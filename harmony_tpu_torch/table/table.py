"""DenseTable — the partitioned model table, on one slot or over a mesh.

Counterpart of ``harmony_tpu/table/table.py``. Storage is block-major,
``[num_blocks, block_size, *value_shape]``; keys map to (block, offset) through
the table's hash or range partitioner. :class:`TableSpec` holds the device ops
a trainer's step calls (pull, push, push_all, write_all); :class:`DenseTable`
is the host-side handle that serialises access to the storage.

On one slot the storage is one tensor. Over a mesh of several slots
(``parallel/mesh.py``) it is a :class:`ShardedArray`, one tensor for each
slot, placed as the reference's ``NamedSharding`` places its one array:
:func:`block_sharding` splits the blocks contiguously over the model axis
when they divide, else every slot holds every block, and the other axes
hold replicas. The ops route each key to the shard of its block: a pull
gathers with K1 once on each shard of its data row, a keyed push folds once
on each slot, every replica with the same bits, and each shard's fold sees
its keys in their original order, so the bytes equal the one-slot table's.

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
snapshot is a device COPY, since steps update the storage in place. A pod's
checkpoint stages each process's owned blocks (``addressable_blocks``,
:func:`owned_blocks`).

On a mesh that spans the processes of a pod (``parallel/multihost.py``, data
axis 1) a :class:`ShardedArray` holds only this process's shards, and every
process runs a step's compute on its own first slot from the same rows and
the same batch (the reference's GSPMD layout: the batch replicated over the
model axis). A pull runs K1 once for each local shard, then takes the rows
of the other shards from an all-gather of the processes' partial results,
picked by ``where`` in shard order (never summed: ``-0.0 + 0.0`` is
``+0.0``); a push folds only the local shards' keys, from the replicated
deltas. The pull's all-gather is a step's one cross-process transfer.

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
from harmony_tpu_torch.parallel.dispatch import dispatch_scope
from harmony_tpu_torch.parallel.collectives import process_all_gather
from harmony_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    Slot,
    as_slots,
    build_mesh,
    is_local,
    this_process,
)
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
    """Orders a table's device work across CUDA streams, on each card its
    slots lie on; every method runs under the host's table lock, and each is
    a no-op off the card.

    A write (a step's in-place update and its commit, or a host op) calls
    :meth:`_before_write` before it enqueues anything and :meth:`_after_write`
    once it has: the stream it ran on is kept as the last write's. A read
    calls :meth:`_before_read`, which records an event on that stream and has
    the reader's stream wait on it (the read follows every committed write,
    whichever stream wrote it), and :meth:`_after_read`, which records an
    event on the reader's stream that the next write waits on (a later
    in-place write never overtakes a read still queued on another stream).
    Writers on one stream pay a comparison a write; the events are made only
    when a second stream reads. A table over several cards keeps this state
    for each card (its shards there, read and written on that card's current
    stream). Hosts set ``self.mesh``, call :meth:`_init_order` and hold
    ``self._lock``. Every host read of a table is ordered so; the ``array``
    and ``state`` properties hand out the live storage itself, which is
    ordered only on the last write's streams."""

    def _init_order(self) -> None:
        """Called once the initial storage is enqueued: that is the first
        write's stream on each card."""
        self._data_version = 0
        self._cards = list(dict.fromkeys(
            s.device for s in self.mesh.slots if s.device.type == "cuda" and is_local(s)))
        self._write_stream: Dict[torch.device, "torch.cuda.Stream"] = {
            d: torch.cuda.current_stream(d) for d in self._cards}
        self._read_events: Dict[torch.device, Dict] = {d: {} for d in self._cards}
        self._write_event: Dict[torch.device, "torch.cuda.Event"] = {}

    def _before_write(self) -> None:
        for d in self._cards:
            s = torch.cuda.current_stream(d)
            last = self._write_stream[d]
            if last != s:   # a write on another stream first
                ev = torch.cuda.Event()
                ev.record(last)
                s.wait_event(ev)
            reads = self._read_events[d]
            for reader, ev in reads.items():
                if reader != s:
                    s.wait_event(ev)
            reads.clear()

    def _after_write(self) -> None:
        self._data_version += 1
        for d in self._cards:
            self._write_stream[d] = torch.cuda.current_stream(d)

    def _before_read(self) -> None:
        for d in self._cards:
            s = torch.cuda.current_stream(d)
            last = self._write_stream[d]
            if last == s:
                continue
            ev = self._write_event.get(d)
            if ev is None:
                ev = self._write_event[d] = torch.cuda.Event()
            ev.record(last)
            s.wait_event(ev)

    def _after_read(self) -> None:
        for d in self._cards:
            s = torch.cuda.current_stream(d)
            if s == self._write_stream[d]:
                continue
            reads = self._read_events[d]
            ev = reads.get(s)
            if ev is None:
                ev = reads[s] = torch.cuda.Event()
            ev.record(s)

    def _order_new_layout(self) -> None:
        """After a reshard, under the lock: the mesh's cards are those of the
        new layout, and the reshard's copies, enqueued on each card's current
        stream, are every card's last write."""
        self._cards = list(dict.fromkeys(
            s.device for s in self.mesh.slots if s.device.type == "cuda" and is_local(s)))
        self._write_stream = {d: torch.cuda.current_stream(d) for d in self._cards}
        self._read_events = {d: {} for d in self._cards}
        self._write_event = {}
        self._data_version += 1

    @property
    def data_version(self) -> int:
        """Monotonic count of storage writes, a reshard included (a serving
        cache keys its rows by it, so a write retires them)."""
        with self._lock:
            return self._data_version


class LayoutAnnouncerMixin:
    """Reshard announcements, shared by dense and hash tables (the
    reference's mixin, ``harmony_tpu/table/table.py:136-200``): the caller of
    a reshard (``TableHandle._announce_target``) runs the listeners with the
    target mesh before the ownership flip, and ``layout_version`` counts the
    announcements. The listeners drop what they staged for the old layout:
    the serving cache a job's live rows, a worker its device batches when
    the target computes on another device. The reference's ``comm_split``
    pair is left out: the port's worker keeps its probe's split itself
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

    def _reshard_storage(self, new_mesh, attr: str) -> None:
        """Move the storage held in ``attr`` onto ``new_mesh`` (the body of
        ``DenseTable.reshard`` and ``DeviceHashTable.reshard``): under the
        table lock, after every enqueued write and read, the storage is
        rebuilt on the new sharding (``reshard_array``) and only then do the
        mesh, sharding, device and storage flip; onto the current layout,
        nothing happens. Counts as a write. Between processes every process
        of the two meshes calls it alike; one that holds no slot of the new
        mesh keeps no shard (an empty ``ShardedArray``). Hosts define
        ``_parts_like``: their parts as ((block shape, dtype), ...)."""
        mesh = mesh_of(new_mesh)
        sharding = block_sharding(mesh, self.spec.num_blocks)
        with self._lock, dispatch_scope(max(self.mesh, mesh, key=lambda m: m.size)):
            if sharding == self.sharding:
                return
            self._before_write()
            setattr(self, attr, reshard_array(getattr(self, attr), self.sharding, sharding,
                                              like=self._parts_like()))
            self.mesh, self.sharding = mesh, sharding
            self.device = sharding.compute_slot().device
            self._order_new_layout()

    def announce_reshard(self, target: Mesh) -> None:
        """Run the listeners with the ``target`` mesh (outside the table lock).
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


def on_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself when it lies there, else a copy. A copy
    between two cards is ordered after the work enqueued on the source's
    current stream and before the work later enqueued on the destination's
    (PyTorch's peer copy waits on both), and the source's memory goes back to
    its own stream's pool, so nothing reuses it before the copy has read it."""
    return t if t.device == device else t.to(device, non_blocking=True)


class BlockSharding:
    """The placement of a block-major table on a mesh: the reference's
    ``block_sharding`` (``harmony_tpu/table/table.py:126-133``) as a
    ``NamedSharding``. ``spec`` is ``(MODEL_AXIS,)`` when the blocks divide
    over the model axis (contiguous runs of ``blocks_per_shard`` blocks, one
    run a model coordinate, repeated along the other axes), else ``()``:
    every slot holds every block, a faithful copy of the reference's rule.

    Data row ``r`` (the mesh's first axis) reads the shards of
    :meth:`row_slots`, and computes on :meth:`compute_slot`; a write goes to
    every slot, every replica with the same bits.

    On a mesh over several processes (data axis 1) a process reads each
    shard it holds on its own slot (:meth:`read_slots`), computes on its own
    first slot, and takes the other shards from their :meth:`provider`."""

    def __init__(self, mesh: Mesh, num_blocks: int) -> None:
        model = mesh.shape.get(MODEL_AXIS, 1)
        self.mesh = mesh
        self.num_blocks = num_blocks
        sharded = MODEL_AXIS in mesh.axis_names and num_blocks % max(model, 1) == 0
        self.spec: Tuple[str, ...] = (MODEL_AXIS,) if sharded else ()
        self.num_shards = model if sharded else 1
        self.blocks_per_shard = num_blocks // self.num_shards
        coords = np.indices(mesh.devices.shape)[-1] if sharded else np.zeros(
            mesh.devices.shape, dtype=np.int64)
        self._shard = {slot: int(m) for slot, m in zip(mesh.devices.flat, coords.flat)}
        self.processes = mesh.processes
        self.spans_processes = len(self.processes) > 1
        if self.spans_processes and mesh.devices.shape[0] > 1:
            raise ValueError(
                f"a data axis of {mesh.devices.shape[0]} over the processes "
                f"{list(self.processes)} waits for the pod's data-row split "
                "(ROADMAP A item 3b)")
        self._reads: Dict[Tuple[int, int], Dict[int, Slot]] = {}
        self._compute: Dict[Tuple[int, int], Slot] = {}

    @property
    def data_rows(self) -> int:
        return int(self.mesh.devices.shape[0])

    def shard_of(self, slot: Slot) -> int:
        """The model coordinate of ``slot``'s shard."""
        return self._shard[slot]

    def shard_blocks(self, m: int) -> range:
        lo = m * self.blocks_per_shard
        return range(lo, lo + self.blocks_per_shard)

    def slot_blocks(self, slot: Slot) -> range:
        """The blocks ``slot`` holds (the reference's addressable shard)."""
        return self.shard_blocks(self.shard_of(slot))

    def devices_indices_map(self, shape: Tuple[int, ...]) -> Dict[Slot, Tuple[slice]]:
        """slot -> the index of its shard along the block axis (the
        reference's ``NamedSharding.devices_indices_map``; the planner of
        ``table/blockmove.py`` reads it)."""
        out = {}
        for slot in self.mesh.slots:
            b = self.slot_blocks(slot)
            out[slot] = (slice(b.start, b.stop),)
        return out

    def row_slots(self, r: int = 0) -> List[Slot]:
        """The slots data row ``r`` reads, one for each shard, in shard order."""
        row = self.mesh.devices[r].reshape(-1, self.mesh.devices.shape[-1])[0]
        return list(row) if self.num_shards > 1 else [row[0]]

    def compute_slot(self, r: int = 0) -> Slot:
        """Where data row ``r`` computes: its first slot of this process."""
        key = (r, this_process())
        hit = self._compute.get(key)
        if hit is None:
            row = list(self.mesh.devices[r].flat)
            hit = self._compute[key] = next((s for s in row if is_local(s)), row[0])
        return hit

    def read_slots(self, r: int = 0) -> Dict[int, Slot]:
        """Shard -> the slot of this process on which data row ``r`` reads it,
        for each shard this process holds (every shard, on one process)."""
        key = (r, this_process())
        hit = self._reads.get(key)
        if hit is None:
            row = list(self.mesh.devices[r].flat)
            hit = {}
            for k, s in enumerate(self.row_slots(r)):
                held = s if is_local(s) else next(
                    (x for x in row if is_local(x) and self._shard[x] == k), None)
                if held is not None:
                    hit[k] = held
            self._reads[key] = hit
        return hit

    def provider(self, k: int, r: int = 0) -> int:
        """The process whose rows of shard ``k`` every other process takes."""
        return self.row_slots(r)[k].process_index

    def __eq__(self, other) -> bool:
        return (isinstance(other, BlockSharding) and self.mesh == other.mesh
                and self.num_blocks == other.num_blocks and self.spec == other.spec)

    def __repr__(self) -> str:
        return f"BlockSharding({self.mesh.shape}, P{self.spec}, {self.num_blocks} blocks)"


def block_sharding(mesh: Mesh, num_blocks: int) -> BlockSharding:
    """Shard the block axis over the mesh's model axis when the blocks
    divide over it, else replicate (the reference's rule, dense and hash
    tables alike)."""
    return BlockSharding(mesh, num_blocks)


class ShardedArray:
    """A table's storage over a mesh of several slots: one tensor for each
    slot (``shards``), holding the blocks of its model coordinate (every
    block under a replicated sharding), each on its slot's device.

    What a step function receives in place of the storage tensor. The
    table ops (:class:`TableSpec`, ``HashTableSpec``) route each key to the
    shard of its block: a read gathers on the shards of data row ``row``,
    a write updates every slot. ``device`` is where the row computes, and
    where a read's rows arrive. A hash table's shards are (slot_keys,
    values) pairs."""

    def __init__(self, sharding: BlockSharding, shards: Dict[Slot, object],
                 row: int = 0) -> None:
        self.sharding = sharding
        self.shards = shards
        self.row = row

    @property
    def device(self) -> torch.device:
        return self.sharding.compute_slot(self.row).device

    def at_row(self, r: int) -> "ShardedArray":
        """The same storage, read by data row ``r``."""
        return ShardedArray(self.sharding, self.shards, r)

    def local_reads(self) -> List[Tuple[int, object]]:
        """(shard, storage) for each shard the row reads in this process, in
        shard order (every shard, on one process)."""
        return [(k, self.shards[s]) for k, s in sorted(self.sharding.read_slots(self.row).items())]

    def clone(self) -> "ShardedArray":
        return ShardedArray(self.sharding, {
            s: (tuple(x.clone() for x in t) if isinstance(t, tuple) else t.clone())
            for s, t in self.shards.items()}, self.row)

    @classmethod
    def split(cls, sharding: BlockSharding, *parts: torch.Tensor) -> "ShardedArray":
        """Shards copied out of whole block-major storage (one part, or a
        hash table's (slot_keys, values)): each slot gets its own copy."""
        shards = {}
        for slot in filter(is_local, sharding.mesh.slots):
            b = sharding.slot_blocks(slot)
            pieces = tuple(p[b.start:b.stop].to(slot.device, copy=True).contiguous()
                           for p in parts)
            shards[slot] = pieces if len(parts) > 1 else pieces[0]
        return cls(sharding, shards)

    def whole(self, part: Optional[int] = None) -> torch.Tensor:
        """The row's shards joined into whole block-major storage on
        ``device`` (a copy); ``part`` picks one tensor of a pair. Over
        several processes the other processes' shards come by all-gather."""
        dev = self.device
        pieces = gather_shards(self.sharding, self.row, {
            k: on_device(t if part is None else t[part], dev) for k, t in self.local_reads()})
        return pieces[0].clone() if len(pieces) == 1 else torch.cat(pieces)


def combine_owned(sharding: BlockSharding, row: int, m: torch.Tensor,
                  partial: torch.Tensor) -> torch.Tensor:
    """Rows of ``partial`` (one for each entry of ``m``, the shard each
    belongs to) read in this process; those of shards this process does not
    hold come from their provider's partial result, by an all-gather over
    the mesh's processes, picked by ``where`` in shard order. Nothing is
    summed, so the rows keep their bits (a -0.0 stays -0.0)."""
    mine = sharding.read_slots(row)
    if len(mine) == sharding.num_shards:
        return partial
    procs = list(sharding.processes)
    parts = process_all_gather(partial, procs)
    out = partial
    for k in range(sharding.num_shards):
        if k not in mine:
            sel = (m == k).reshape(m.shape + (1,) * (partial.dim() - m.dim()))
            out = torch.where(sel, parts[procs.index(sharding.provider(k, row))], out)
    return out


def gather_shards(sharding: BlockSharding, row: int,
                  local: Dict[int, torch.Tensor]) -> List[torch.Tensor]:
    """Every shard's tensor in shard order: ``local`` (this process's, all of
    one shape) and, over several processes, the others' from an all-gather
    in which each process sends the shards it provides."""
    if len(local) == sharding.num_shards:
        return [local[k] for k in range(sharding.num_shards)]
    procs = list(sharding.processes)
    provided = {p: [k for k in range(sharding.num_shards) if sharding.provider(k, row) == p]
                for p in procs}
    width = max(len(v) for v in provided.values())
    like = next(iter(local.values()))
    mine = [local[k] for k in provided[this_process()]]
    payload = torch.stack(mine + [torch.zeros_like(like)] * (width - len(mine)))
    parts = process_all_gather(payload, procs)
    out = []
    for k in range(sharding.num_shards):
        p = sharding.provider(k, row)
        out.append(local[k] if k in local else parts[procs.index(p)][provided[p].index(k)])
    return out


def reshard_array(storage, old_sharding: BlockSharding, new_sharding: BlockSharding,
                  like=None):
    """A table's storage on a new sharding (the reference's
    ``reshard_array``): the storage itself onto the same sharding, else
    ``blockmove.migrate_blocks``, which takes the route from the two meshes
    up front (never by catching an exception): the in-process block move, or
    between processes the pod's transports (the reference's
    ``cross_set_reshard``: each process sends only the blocks leaving it and
    rebuilds only its own new shards; every process of the two meshes calls
    it in lockstep, and ``like`` gives the storage's parts where this process
    holds none)."""
    from harmony_tpu_torch.table.blockmove import migrate_blocks

    if old_sharding == new_sharding:
        return storage
    return migrate_blocks(storage, old_sharding, new_sharding, like)


def _sharding_of(storage, current: BlockSharding) -> BlockSharding:
    """The sharding a step result carries: a ShardedArray's own, else the
    one-slot sharding of the device it lies on (``current`` when that is the
    table's own one-slot layout)."""
    if isinstance(storage, ShardedArray):
        return storage.sharding
    t = storage[0] if isinstance(storage, tuple) else storage
    if current.mesh.size == 1 and current.compute_slot().device == t.device:
        return current
    return BlockSharding(build_mesh([Slot(-1, t.device)]), current.num_blocks)


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
        # (shards, device) -> every key's shard and row there (_key_routes)
        self._routes: Dict[Tuple[int, torch.device], list] = {}

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
        if isinstance(arr, ShardedArray):
            rows = self._gather_sharded(arr, flat_idx.reshape(-1))
        else:
            flat = arr.reshape(self.num_rows, value_width(self.value_shape))
            rows = gather_rows(flat, flat_idx.reshape(-1))
        return rows.reshape(*flat_idx.shape, *self.value_shape)

    def pull_all(self, arr: torch.Tensor) -> torch.Tensor:
        """Whole table as ``[capacity, *value_shape]`` in key order. For a range
        table this is a VIEW of the storage."""
        if isinstance(arr, ShardedArray):
            return self._pull_all_sharded(arr)
        if self._is_range():
            flat = arr.reshape(self.num_rows, *self.value_shape)
            return flat[: self.config.capacity]
        return self.pull(arr, self._all_keys(arr.device))

    def _post_touched(self, arr: torch.Tensor, b: torch.Tensor, o: torch.Tensor) -> None:
        if isinstance(arr, ShardedArray):
            return self._post_touched_sharded(arr, b.reshape(-1), o.reshape(-1))
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
        if isinstance(arr, ShardedArray) and via in ("mxu", "sparse", "scatter"):
            if via != "scatter" and mode != "add":
                raise ValueError(f"via={via!r} requires an additive update fn")
            with dispatch_scope(arr.sharding.mesh):
                self._push_sharded(arr, b.reshape(-1), o.reshape(-1), deltas, via)
        elif via in ("mxu", "sparse"):
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
        if isinstance(arr, ShardedArray):
            return self._push_all_sharded(arr, deltas)
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
        if isinstance(arr, ShardedArray):
            return self._write_all_sharded(arr, values)
        if self._is_range():
            arr.copy_(self._pad_to_storage(values, self.dtype))
            return arr
        b, o = self.partitioner.locate(self._all_keys(arr.device))
        arr[b.long(), o.long()] = values.to(self.dtype)
        return arr


    # -- the ops on a ShardedArray -----------------------------------------
    #
    # A key's shard is found on the device, from its flat row: routing a batch
    # by shard with no sync means every shard of the row sees every key, and
    # those of other shards are masked (a gather reads row 0 for them and
    # drops what it read; a fold gets id -1, which adds nothing). Each shard's
    # fold so sees its own keys in their original index order, and every row
    # of every shard gets the bits the one-slot fold gives it.

    def _rows_per_shard(self, sh: BlockSharding) -> int:
        return sh.blocks_per_shard * self.block_size

    def _shard_rows(self, flat: torch.Tensor, sh: BlockSharding):
        """(shard coordinate, row within that shard) of flat rows; a row
        outside the storage has coordinate -1."""
        per = self._rows_per_shard(sh)
        inside = (flat >= 0) & (flat < self.num_rows)
        m = torch.where(inside, torch.div(flat, per, rounding_mode="floor"), -1)
        return m, (flat - m * per).to(torch.int32)

    def _gather_sharded(self, arr: ShardedArray, flat: torch.Tensor) -> torch.Tensor:
        """K1 once on each shard of the row; rows [n, W] on ``arr.device``.
        Ids clamp into the storage first, as the one-slot gather clamps."""
        sh, dev = arr.sharding, arr.device
        per, W = self._rows_per_shard(sh), value_width(self.value_shape)
        flat = flat.clamp(0, max(self.num_rows - 1, 0)).to(torch.int32)
        m, local = self._shard_rows(flat, sh)
        out = None
        with dispatch_scope(sh.mesh):
            for k, t in arr.local_reads():
                idx = flat if sh.num_shards == 1 else torch.where(m == k, local, 0)
                rows = on_device(gather_rows(t.view(per, W), on_device(idx, t.device)), dev)
                out = rows if out is None else torch.where((m == k)[:, None], rows, out)
            return combine_owned(sh, arr.row, m, out)

    def _push_sharded(self, arr: ShardedArray, b: torch.Tensor, o: torch.Tensor,
                      deltas: torch.Tensor, via: str) -> None:
        """The keyed push on every slot: each folds the keys of its shard
        (K3 for "mxu", K2 for "sparse", an indexed scatter for "scatter") and
        adds the fold in place."""
        sh = arr.sharding
        per, n = self._rows_per_shard(sh), b.shape[0]
        flat = self._flat_index(b, o)
        m, local = self._shard_rows(flat, sh)
        mode = self.update_fn.scatter_mode
        ids: Dict[int, torch.Tensor] = {}
        if via == "scatter":
            ok = (b >= 0) & (b < self.num_blocks) & (o >= 0) & (o < self.block_size)
            d = deltas.reshape(n, *self.value_shape)
        else:
            fold = segment_sum if via == "mxu" else segment_sum_rows
            d = deltas.reshape(n, -1).float()
        moved: Dict[torch.device, torch.Tensor] = {}
        for slot, t in arr.shards.items():
            k = sh.shard_of(slot)
            if k not in ids:
                ids[k] = (flat if sh.num_shards == 1
                          else torch.where(m == k, local, -1)).to(torch.int32)
            dd = moved.get(t.device)
            if dd is None:
                dd = moved[t.device] = on_device(d, t.device)
            if via != "scatter":
                folded = fold(dd, on_device(ids[k], t.device), per)
                t.add_(folded.reshape(t.shape).to(t.dtype))
                continue
            sel = ok & (ids[k] >= 0)
            idx = on_device(ids[k][sel].long(), t.device)
            dsel = dd[on_device(sel, t.device)].to(t.dtype)
            tflat = t.view(per, *self.value_shape)
            if mode == "add":
                tflat.index_add_(0, idx, dsel)
            elif mode in ("min", "max"):
                tflat.index_reduce_(0, idx, dsel, "a" + mode)
            elif mode == "set":
                tflat[idx] = dsel
            else:
                raise ValueError(f"unknown scatter_mode {mode!r}")

    def _post_touched_sharded(self, arr: ShardedArray, b: torch.Tensor,
                              o: torch.Tensor) -> None:
        sh = arr.sharding
        per = self._rows_per_shard(sh)
        ok = (b >= 0) & (b < self.num_blocks) & (o >= 0) & (o < self.block_size)
        m, local = self._shard_rows(self._flat_index(b, o), sh)
        for slot, t in arr.shards.items():
            sel = ok & (m == sh.shard_of(slot))
            idx = on_device(local[sel].long(), t.device)
            tflat = t.view(per, *self.value_shape)
            tflat[idx] = self.update_fn.post(tflat[idx])

    def _key_routes(self, sh: BlockSharding, device: torch.device):
        """For every key in key order, split by shard: per shard, the keys'
        positions and their rows in the shard (int64, int32) on ``device``.
        Fixed by the partitioner, so made once on the host and kept."""
        cache = self._routes
        hit = cache.get((sh.num_shards, device))
        if hit is None:
            b, o = self.partitioner.locate(self._all_keys(torch.device("cpu")))
            m, local = self._shard_rows(self._flat_index(b, o), sh)
            hit = []
            for k in range(sh.num_shards):
                pos = torch.nonzero(m == k).reshape(-1)
                hit.append((pos.to(device), local[pos].to(device)))
            cache[(sh.num_shards, device)] = hit
        return hit

    def _pull_all_sharded(self, arr: ShardedArray) -> torch.Tensor:
        """The whole table in key order on ``arr.device``: a range table's
        shards joined, a hash-partitioned one's rows gathered (K1 once a
        shard) and placed by key."""
        if self._is_range():
            flat = arr.whole().reshape(self.num_rows, *self.value_shape)
            return flat[: self.config.capacity]
        sh, dev = arr.sharding, arr.device
        per, W = self._rows_per_shard(sh), value_width(self.value_shape)
        out = torch.empty((self.config.capacity, W), dtype=self.dtype, device=dev)
        with dispatch_scope(sh.mesh):
            for k, t in arr.local_reads():
                pos, _ = self._key_routes(sh, dev)[k]
                _, local = self._key_routes(sh, t.device)[k]
                out[pos] = on_device(gather_rows(t.view(per, W), local), dev)
            if len(sh.read_slots(arr.row)) < sh.num_shards:
                m = torch.empty(self.config.capacity, dtype=torch.int64, device=dev)
                for k, (pos, _) in enumerate(self._key_routes(sh, dev)):
                    m[pos] = k
                out = combine_owned(sh, arr.row, m, out)
        return out.reshape(self.config.capacity, *self.value_shape)

    def _push_all_sharded(self, arr: ShardedArray, deltas: torch.Tensor) -> ShardedArray:
        """Range tables: each slot combines its blocks' part of the padded
        delta (``push_all``'s add, min or max) and applies ``post``."""
        mode = self.update_fn.scatter_mode
        d = self._pad_to_storage(deltas, self.dtype)
        with dispatch_scope(arr.sharding.mesh):
            for slot, t in arr.shards.items():
                blk = arr.sharding.slot_blocks(slot)
                piece = on_device(d[blk.start:blk.stop], t.device)
                if mode == "add":
                    t.add_(piece)
                elif mode == "min":
                    torch.minimum(t, piece, out=t)
                elif mode == "max":
                    torch.maximum(t, piece, out=t)
                else:
                    raise ValueError(f"unknown scatter_mode {mode!r}")
                if self.update_fn.post is not None:
                    t.copy_(self.update_fn.post(t))
        return arr

    def _write_all_sharded(self, arr: ShardedArray, values: torch.Tensor) -> ShardedArray:
        sh = arr.sharding
        per = self._rows_per_shard(sh)
        with dispatch_scope(sh.mesh):
            if self._is_range():
                v = self._pad_to_storage(values, self.dtype)
                for slot, t in arr.shards.items():
                    blk = sh.slot_blocks(slot)
                    t.copy_(on_device(v[blk.start:blk.stop], t.device))
                return arr
            v = values.to(self.dtype).reshape(self.config.capacity, *self.value_shape)
            for slot, t in arr.shards.items():
                k = sh.shard_of(slot)
                pos, _ = self._key_routes(sh, v.device)[k]
                _, local = self._key_routes(sh, t.device)[k]
                t.view(per, *self.value_shape)[local.long()] = on_device(v[pos], t.device)
        return arr


def _snapshot_part(storage, ids: Sequence[int], whole: bool,
                   part: Optional[int] = None) -> torch.Tensor:
    """A copy of blocks ``ids`` of a storage tensor, or of a ShardedArray
    (``part`` picks one tensor of a hash table's pairs), on the table's
    device, block-major."""
    if not isinstance(storage, ShardedArray):
        return storage.clone() if whole else torch.stack([storage[b] for b in ids])
    if whole:
        return storage.whole(part)
    shards = gather_shards(storage.sharding, storage.row, {
        k: t if part is None else t[part] for k, t in storage.local_reads()})
    bps = storage.sharding.blocks_per_shard
    return torch.stack([on_device(shards[b // bps][b % bps], storage.device) for b in ids])


def owned_blocks(storage, sharding: BlockSharding) -> Dict[int, Tuple[np.ndarray, ...]]:
    """This process's OWNED blocks of a table's storage (a tensor, a pair, or
    a ShardedArray of either) as host arrays, one tuple of parts a block: the
    reference's ``owned_addressable_blocks``. Ownership is
    ``blockmove.block_owners``, the lowest-owner rule that migration sources
    by too, so over a pod every block comes from exactly one process, and a
    block replicated on several local slots from the first of them.

    Each local shard that holds an owned block makes one copy to the host:
    onto pinned memory, enqueued on its card's current stream (the caller
    holds the table lock and has ordered that stream after the last write),
    then the stream is waited on before a byte is read."""
    from harmony_tpu_torch.table.blockmove import block_owners

    me = this_process()
    owners = block_owners(sharding, (sharding.num_blocks,))
    if isinstance(storage, ShardedArray):
        held = sorted(storage.shards.items(), key=lambda kv: kv[0].index)
        held = [(sharding.slot_blocks(s), t) for s, t in held]
    else:
        held = [(range(sharding.num_blocks), storage)]
    taken: set = set()
    copies = []
    cards = set()
    for blocks, parts in held:
        mine = [b for b in blocks if owners.get(b) == me and b not in taken]
        if not mine:
            continue
        taken.update(mine)
        hosts = []
        for p in (parts if isinstance(parts, tuple) else (parts,)):
            _check_codec_dtype(p)
            if p.device.type == "cuda":
                h = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                h.copy_(p, non_blocking=True)
                cards.add(p.device)
            else:
                h = p.clone()
            hosts.append(h)
        copies.append((blocks.start, mine, hosts))
    for d in cards:
        torch.cuda.current_stream(d).synchronize()
    out: Dict[int, Tuple[np.ndarray, ...]] = {}
    for start, mine, hosts in copies:
        arrs = [h.numpy() for h in hosts]
        for b in mine:
            out[b] = tuple(a[b - start] for a in arrs)
    return out


def _import_part(storage, ids: Sequence[int], payload: torch.Tensor,
                 dtype: torch.dtype, part: Optional[int] = None) -> None:
    """Set blocks ``ids`` of a storage tensor, or of every slot of a
    ShardedArray that holds them, from ``payload`` (host, block-major in
    ``ids`` order)."""
    if not isinstance(storage, ShardedArray):
        dev = storage.device
        storage[torch.as_tensor(ids, device=dev)] = payload.to(dev, dtype)
        return
    sh = storage.sharding
    for slot, t in storage.shards.items():
        t = t if part is None else t[part]
        blk = sh.slot_blocks(slot)
        sel = [i for i, b in enumerate(ids) if b in blk]
        if sel:
            local = torch.as_tensor([ids[i] - blk.start for i in sel], device=t.device)
            t[local] = payload[sel].to(t.device, dtype)


def mesh_of(where) -> Mesh:
    """A table's mesh: ``where`` itself, or the one-slot mesh of a device."""
    if isinstance(where, Mesh):
        return where
    return build_mesh([where if isinstance(where, Slot) else resolve_device(where)])


class DenseTable(StreamOrder, LayoutAnnouncerMixin):
    """Host-side handle: serialised steps and host accessors.

    ``DenseTable(spec, mesh)`` keeps one shard tensor for each slot of the
    mesh, placed by :func:`block_sharding` (:class:`ShardedArray`); a mesh of
    one slot, or ``DenseTable(spec, device)``, keeps one storage tensor.
    ``device`` is where the table's first data row computes (the mesh's first
    slot): a host op's keys and rows go there.

    Every write (a step's commit, multi_update, multi_put, write_all) and every
    host read is enqueued under ``_lock``; storage writes bump
    ``data_version``, and :class:`StreamOrder` orders them on each card. A
    step over several slots also enqueues in the process-wide order of
    ``parallel/dispatch.py``."""

    def __init__(self, spec: TableSpec, mesh: "Mesh | DeviceLike" = None,
                 arr: Optional[torch.Tensor] = None) -> None:
        self.spec = spec
        self.mesh = mesh_of(mesh)
        self.sharding = block_sharding(self.mesh, spec.num_blocks)
        self.device = self.sharding.compute_slot().device
        self._lock = threading.RLock()
        if arr is None:
            arr = spec.init_array(self.device)
        elif tuple(arr.shape) != spec.storage_shape:
            raise ValueError(
                f"storage shape {tuple(arr.shape)} != {spec.storage_shape}")
        arr = arr.to(self.device, spec.dtype).contiguous()
        self._arr = ShardedArray.split(self.sharding, arr) if self.mesh.size > 1 else arr
        self._layout_listeners: list = []
        self._init_order()

    @property
    def array(self):
        """The live storage (a tensor, or a :class:`ShardedArray` over several
        slots). Steps update it in place: a host reader that needs a stable
        value copies it under the table lock (multi_get, pull_array)."""
        with self._lock:
            return self._arr

    @property
    def _step_state(self):
        """What a step function receives (``DeviceHashTable``'s counterpart is
        its (slot_keys, values) pair)."""
        return self._arr

    def _parts_like(self):
        """The storage's one part, as ((block shape, dtype),)."""
        return ((tuple(self.spec.storage_shape[1:]), self.spec.dtype),)

    def commit(self, new_arr) -> None:
        """Install the post-step storage (a step that updated in place hands
        back the same tensor, or the same shards) and count the write. A
        result computed on the layout before a reshard is re-homed onto the
        current one (the reference's commit)."""
        with self._lock:
            src = _sharding_of(new_arr, self.sharding)
            if src != self.sharding:
                new_arr = reshard_array(new_arr, src, self.sharding)
            if isinstance(self._arr, ShardedArray) or isinstance(new_arr, ShardedArray):
                new_arr = ShardedArray(new_arr.sharding, new_arr.shards)
            elif (tuple(new_arr.shape) != self.spec.storage_shape
                    or new_arr.dtype != self.spec.dtype
                    or new_arr.device != self._arr.device):
                raise ValueError("commit: storage shape, dtype or device changed")
            self._arr = new_arr
            self._after_write()

    def apply_step(self, step_fn: Callable, *extra):
        """Run ``step_fn(arr, *extra) -> (new_arr, aux)`` and commit its result,
        both under the table lock, so no host accessor sees a half-applied
        step. Returns ``aux``."""
        with self._lock, dispatch_scope(self.mesh):
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
            stack.enter_context(dispatch_scope(max((t.mesh for t in tables),
                                                   key=lambda m: m.size)))
            new_arrs, aux = step_fn(*(t._step_state for t in tables), *extra)
            for t, new in zip(tables, new_arrs):
                t.commit(new)
        return aux

    def drop(self) -> None:
        """Release the storage (the reference's ``AllocatedTable.drop``); the
        table holds none afterwards (``array`` is None)."""
        with self._lock:
            self._arr = None

    # -- re-sharding (the migration path) --------------------------------

    def reshard(self, new_mesh: "Mesh | DeviceLike") -> None:
        """Move the table onto a new mesh (an executor added or drained, a
        rebalance), live: under the table lock, after every write and read
        enqueued so far (``_before_write``), the storage is rebuilt on the new
        sharding (``reshard_array``: only the blocks that leave a slot are
        copied), and only then do the mesh, sharding, device and storage
        flip (transfer first, mutate after, as the reference's). A step or
        host op waiting on the lock runs on the new layout. Counts as a
        write (``data_version``); onto the current layout it is a no-op."""
        self._reshard_storage(new_mesh, "_arr")

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
            copy = _snapshot_part(self._arr, ids, block_ids is None)
            self._after_read()
            return BlockSnapshot(ids, (copy,), self.device)

    def export_blocks(self, block_ids: Optional[Sequence[int]] = None
                      ) -> Dict[int, np.ndarray]:
        """Blocks as host arrays, copied under the lock."""
        snap = self.snapshot_blocks(block_ids)
        (host,) = snap.to_host()
        return {b: host[i] for i, b in enumerate(snap.ids)}

    def addressable_blocks(self) -> Dict[int, np.ndarray]:
        """THIS process's owned blocks as host arrays (the pod checkpoint's
        stage-1 source; see :func:`owned_blocks`), copied under the lock."""
        with self._lock:
            self._before_read()
            out = owned_blocks(self._arr, self.sharding)
            self._after_read()
        return {b: parts[0] for b, parts in out.items()}

    def import_blocks(self, blocks: Dict[int, np.ndarray]) -> None:
        """Set whole blocks from host payloads (the restore path), cast to the
        table's dtype, as the reference's ``.at[ids].set(payload)``."""
        if not blocks:
            return
        ids = sorted(blocks)
        payload = torch.as_tensor(np.stack([np.asarray(blocks[b]) for b in ids]))
        with self._lock, dispatch_scope(self.mesh):
            self._before_write()
            _import_part(self._arr, ids, payload, self.spec.dtype)
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
        spec = self.spec
        b, o = spec.partitioner.locate(k)
        with self._lock, dispatch_scope(self.mesh):
            self._before_write()
            ok = ((b >= 0) & (b < spec.num_blocks) & (o >= 0) & (o < spec.block_size))
            if not isinstance(self._arr, ShardedArray):
                self._arr[b[ok].long(), o[ok].long()] = v[ok].to(spec.dtype)
            else:
                sh = self._arr.sharding
                m, local = spec._shard_rows(spec._flat_index(b, o), sh)
                for slot, t in self._arr.shards.items():
                    sel = ok & (m == sh.shard_of(slot))
                    rows = t.view(spec._rows_per_shard(sh), *spec.value_shape)
                    rows[on_device(local[sel].long(), t.device)] = on_device(
                        v[sel].to(spec.dtype), t.device)
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
