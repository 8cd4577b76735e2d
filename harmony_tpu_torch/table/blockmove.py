"""Block-granular migration of a table between the slots of one process.

Counterpart of ``harmony_tpu/table/blockmove.py``, in-process part. The
reference moves N blocks point-to-point between executors at a cost
proportional to the bytes moved (its MigrationExecutor and
``AllocatedTable.moveBlocks``): the move PLAN, which block travels from whom
to whom, is a pure function of (old sharding, new sharding), and only the
blocks that leave their holder travel.

Here the holders are the slots of one process (``parallel/mesh.py``) and a
sharding is a ``table/table.py::BlockSharding``. :func:`migrate_blocks`
rebuilds the storage on the new sharding:

  * a slot whose block range is unchanged keeps its shard tensor as it is:
    nothing is copied;
  * a slot whose range changed gets a new shard: the blocks it already held
    are copied on its own device, and each block it lacks is copied from the
    block's owner in the old layout (the lowest slot index holding it,
    :func:`block_owners`), device to device, one copy for each contiguous run
    of blocks with one source (:func:`_contiguous_runs`).

Every copy is enqueued on the current streams, under the destination's device
guard; the caller (``DenseTable.reshard``, ``DeviceHashTable.reshard``) holds
the table lock and has ordered those streams after the table's last writes
and reads. Each old shard is marked as used by its device's current stream,
so the caching allocator does not hand its memory out while a copy reads it.

The planner functions (:func:`axis0_bounds`, :func:`process_blocks`,
:func:`block_owners`, :func:`plan_moves`) take anything with the reference's
``devices_indices_map(shape)`` (``BlockSharding`` has one) and group by
``unit(device)``: a device's ``process_index`` by default, as in the
reference (the pod's unit); :func:`migrate_blocks` plans by slot index. The frame codec
(:func:`_frame_parts`, :func:`_unpack_frame`) writes the reference's frames
byte for byte, torch's bfloat16 under the name ``"bfloat16"`` as the
reference writes its extension dtypes, so a frame crosses the packages in
both directions. The TCP and file transports, their retry policy and fault
sites, and a move between processes wait for ROADMAP A item 3b:
:func:`migrate_blocks` on a mesh that spans processes raises.
"""
from __future__ import annotations

import contextlib
import json
import struct
import time
from typing import Any, Callable, Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

from harmony_tpu_torch.parallel.mesh import mesh_spans_processes
from harmony_tpu_torch.tracing.span import trace_span

# Telemetry of the most recent migrate_blocks call in this process.
last_move_stats: Dict[str, Any] = {}


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


def _unpack_frame(buf: bytes) -> Tuple[int, torch.Tensor]:
    """Decode one whole frame (the concatenation of both :func:`_frame_parts`
    halves) into (block, tensor): a ``"bfloat16"`` frame as a bfloat16
    tensor, any other in native byte order."""
    if len(buf) < 4:
        raise OSError("truncated block frame (no header length)")
    hlen = struct.unpack("<I", buf[:4])[0]
    if len(buf) < 4 + hlen:
        raise OSError("truncated block frame (short header)")
    hdr = json.loads(buf[4:4 + hlen])
    data = buf[4 + hlen:]
    if len(data) != hdr["n"]:
        raise OSError(
            f"truncated block frame for block {hdr['b']}: "
            f"{len(data)} of {hdr['n']} payload bytes")
    if hdr["dtype"] == "bfloat16":
        t = torch.frombuffer(bytearray(data), dtype=torch.int16).view(torch.bfloat16)
    else:
        dt = np.dtype(hdr["dtype"])
        t = torch.from_numpy(np.frombuffer(data, dtype=dt).astype(dt.newbyteorder("=")))
    return int(hdr["b"]), t.reshape(hdr["shape"])


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
    a hash table's slot keys and values), and whether it is a tuple."""
    from harmony_tpu_torch.table.table import ShardedArray

    if isinstance(storage, ShardedArray):
        shards = storage.shards
        paired = isinstance(next(iter(shards.values())), tuple)
        return {s: (t if paired else (t,)) for s, t in shards.items()}, paired
    paired = isinstance(storage, tuple)
    (slot,) = sharding.mesh.slots
    return {slot: tuple(storage) if paired else (storage,)}, paired


def _copy_run(dst: torch.Tensor, at: int, src: torch.Tensor, lo: int, n: int) -> None:
    """dst[at:at+n] = src[lo:lo+n], enqueued under dst's device guard."""
    guard = (torch.cuda.device(dst.device) if dst.device.type == "cuda"
             else contextlib.nullcontext())
    with guard:
        dst[at:at + n].copy_(src[lo:lo + n], non_blocking=True)


def migrate_blocks(storage, old_sharding, new_sharding):
    """``storage`` (a tensor, a hash table's (slot_keys, values) pair, or a
    ``ShardedArray`` of either) rebuilt on ``new_sharding``: the same kind,
    a ``ShardedArray`` over a mesh of several slots. See the module doc."""
    if mesh_spans_processes(old_sharding.mesh) or mesh_spans_processes(new_sharding.mesh):
        raise NotImplementedError(
            "a block move between processes needs the multi-process pod's "
            "transports (ROADMAP A item 3b)")
    with trace_span("blockmove.migrate") as sp:
        out = _migrate_in_process(storage, old_sharding, new_sharding)
        if sp is not None:
            for k in ("blocks_moved", "bytes_moved", "blocks_copied_locally", "shards_reused"):
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
    for slot, parts in old.items():
        # the copies above may read every old shard on its card's current
        # stream: the allocator waits for them before reusing its memory
        if new.get(slot) is not parts:
            for t in parts:
                if t.device.type == "cuda":
                    t.record_stream(torch.cuda.current_stream(t.device))
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
