"""ETMaster — executors and the tables placed on them.

Counterpart of ``harmony_tpu/runtime/master.py``: executors, each leasing one
slot of the :class:`DevicePool` (``add_executors``; a slot is a place on one
device, ``parallel/mesh.py``), and the table lifecycle (create a job's table
over its executors, list, drop): a ``DenseTable``, or a ``DeviceHashTable``
when the config is ``sparse``. A table over several executors is split
block-major over the mesh of their slots (:func:`_mesh_over`, ``data_axis``
rows of replicas, the blocks sharded along the model axis), and each table
has the reference's ``BlockManager``, its logical block ownership.
``create_table`` returns the table itself; :meth:`ETMaster.table_handle` (the
reference's ``get_table``) wraps it in a :class:`TableHandle`.

:class:`TableHandle` is the reference's AllocatedTable surface: associate,
unassociate, ``move_blocks``, ``rebalance``, ``load`` and drop. Ownership is
logical in the ``BlockManager`` and physical in the table's mesh, which is
the mesh over the OWNING executors' slots: a change of the owning set
announces the target mesh to the table's listeners, flips the ownership map,
and reshards the table live (``DenseTable.reshard``,
``DeviceHashTable.reshard``: only the blocks that leave a slot are copied).
As in the reference, uneven logical ownership is realised at the mesh's
granularity: ``block_sharding`` shards the block axis when the owners divide
the blocks and replicates it otherwise. At most one optimization loop drives
a table's moves (``acquire_optimizer_lease``).

On a pod every process of a table makes the same calls in the same order (a
plan at the chief's epoch hook, ``jobserver/entity.py``): the block managers
flip alike, the owners' mesh is the same in every process, and the reshard
after the flip is the cross-process exchange (``table/blockmove.py``), in
which every process of the old and new owners takes part.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.parallel.mesh import DevicePool, Mesh, Slot, build_mesh
from harmony_tpu_torch.table.hashtable import MIN_KEY, DeviceHashTable, HashTableSpec
from harmony_tpu_torch.table.ownership import BlockManager
from harmony_tpu_torch.table.table import DenseTable, TableSpec
from harmony_tpu_torch.tracing.span import trace_span

Table = Union[DenseTable, DeviceHashTable]


def _table_min_key(table) -> int:
    """Smallest key a table admits: ``MIN_KEY`` (1) for hash tables, whose
    key 0 is reserved, 0 for dense tables."""
    return MIN_KEY if isinstance(table, DeviceHashTable) else 0


def _mesh_over(slots: Sequence[Slot], data_axis: int) -> Mesh:
    """(data, model) mesh over ONE slot set: collocation means the same slots
    appear on both axes as a factorization (each slot holds a model shard
    AND computes a data shard, the reference's servers == workers == all
    executors), never as duplicates. Pure model-parallel when the count does
    not factor.

    The slots may lie in several processes of a pod: every process builds
    the same mesh over the global slots, a data axis > 1 included, whose
    rows may then lie in different processes (each process computes the
    rows holding its slots; ``dolphin/worker.py::_DataParallelStep``). A
    move rebuilds it over the new owners at the table's own data axis, as
    the reference's ``TableHandle._mesh_for`` does: the rows, their count
    and their processes follow the new mesh."""
    n = len(slots)
    if data_axis > 1 and n % data_axis == 0:
        return build_mesh(slots, data=data_axis)
    return build_mesh(slots, data=1)


class Executor:
    """One slot (the reference's AllocatedExecutor). On a pod the executors
    are made over the global slots, with ids in the same order in every
    process (the reference's determinism contract), so an id names the same
    slot everywhere; ``slot.process_index`` is the process that drives it."""

    def __init__(self, executor_id: str, slot: Slot) -> None:
        self.id = executor_id
        self.slot = slot
        self.device: torch.device = slot.device
        self.closed = False

    def __repr__(self) -> str:
        return f"Executor({self.id}, {self.slot})"


class TableHandle:
    """A table married to its ``BlockManager`` (the reference's
    ``TableHandle``): the master's, for a table the master holds, else one
    over ``executors``."""

    def __init__(self, master: "ETMaster", table: Table,
                 executors: Sequence[str]) -> None:
        self._master = master
        self.table = table
        held = master.block_manager_of(table) if master is not None else None
        self.block_manager = held or BlockManager(
            table.spec.table_id, table.spec.num_blocks, list(executors))
        self._next_generated_key = 0  # generated keys of load()

    @property
    def table_id(self) -> str:
        return self.table.spec.table_id

    @property
    def executors(self) -> List[str]:
        """The associated executors, in the block manager's order."""
        return self.block_manager.executors

    # -- ownership ops (the AllocatedTable surface) ----------------------

    def associate(self, executor_id: str) -> None:
        """Add an executor as a potential owner; no data moves yet (the
        reference's AllocatedTable.associate)."""
        self.block_manager.associate(executor_id)

    def unassociate(self, executor_id: str) -> None:
        """Remove an executor (it must own no blocks) and reshard off its
        slot."""
        self._announce_target([e for e in self.owning_executors() if e != executor_id])
        self.block_manager.unassociate(executor_id)
        self._reshard_to_owners()

    def move_blocks(self, src: str, dst: str, num_blocks: int) -> List[int]:
        """Move ``num_blocks`` blocks' ownership from ``src`` to ``dst`` and
        reshard the table when the owning set changes (the reference's
        AllocatedTable.moveBlocks). Ownership first: the target layout is
        announced before the map flips, the map flips, then the bytes move
        under the table lock (the reference's access latch)."""
        counts = self.block_manager.block_counts()
        n = min(num_blocks, counts.get(src, 0))
        counts[src] = counts.get(src, 0) - n
        counts[dst] = counts.get(dst, 0) + n
        with trace_span("table.blockmove", table=self.table_id, src=src,
                        dst=dst, blocks=n):
            self._announce_target(
                [e for e in self.block_manager.executors if counts.get(e, 0) > 0])
            moved = self.block_manager.move(src, dst, num_blocks)
            self._reshard_to_owners()
        return moved

    def rebalance(self, executor_ids: Sequence[str]) -> None:
        """Even repartition across ``executor_ids`` and the reshard onto them."""
        self._announce_target(list(executor_ids))
        self.block_manager.rebalance(list(executor_ids))
        self._reshard_to_owners()

    def owning_executors(self) -> List[str]:
        counts = self.block_manager.block_counts()
        return [e for e in self.block_manager.executors if counts.get(e, 0) > 0]

    def _mesh_for(self, owners: Sequence[str]) -> Mesh:
        slots = [self._master.executor(e).slot for e in owners]
        return _mesh_over(slots, self._master.data_axis_of(self.table_id))

    def _announce_target(self, target_owners: Sequence[str]) -> None:
        """Announce the layout after the change BEFORE the logical flip, while
        the ownership map still matches the bytes: the table's listeners
        drop what they staged for the old layout."""
        if target_owners:
            self.table.announce_reshard(self._mesh_for(target_owners))

    def _reshard_to_owners(self) -> None:
        self.table.reshard(self._mesh_for(self.owning_executors()))

    def ownership_vector(self) -> List[int]:
        """Block -> index into the block manager's executors (this handle's,
        in their order) of its owner: the reference's even round-robin."""
        return self.block_manager.ownership_vector()

    def load(self, paths: Sequence[str], parser, num_splits: int = 0,
             generate_keys: bool = False) -> int:
        """Bulk-load records from files into the table (the reference's
        ``TableHandle.load``: AllocatedTable.load -> BulkDataLoader ->
        multiPut). Exactly one split per executor unless ``num_splits`` is
        given; each split's records are parsed and inserted with one
        ``multi_put``.

        * ``generate_keys=False``: the parser yields ``(keys, values)``; keys
          come from the data.
        * ``generate_keys=True``: the parser yields values only; keys are
          generated sequentially across splits and across calls, from the
          table's first key (``MIN_KEY`` on a hash table, 0 on a dense one),
          and a load past the capacity is refused.

        Returns the number of records stored (a hash table's refused keys are
        not counted)."""
        from harmony_tpu_torch.data.splits import compute_splits, fetch_split

        n = num_splits or max(len(self.owning_executors()), 1)
        total = 0
        for split in compute_splits(list(paths), n):
            records = fetch_split(split)
            if not records:
                continue
            parsed = parser.parse(records)
            if generate_keys:
                if isinstance(parsed, tuple):
                    raise ValueError(
                        "generate_keys=True needs a values-only parser; "
                        f"{type(parser).__name__}.parse returned a tuple "
                        "(its keys would be discarded silently)")
                values = parsed
                start = max(self._next_generated_key, _table_min_key(self.table))
                end = start + len(values)
                if end > self.table.spec.config.capacity:
                    raise ValueError(
                        f"generated keys {start}..{end - 1} exceed table capacity "
                        f"{self.table.spec.config.capacity}; the out-of-range rows "
                        "would be dropped silently")
                keys = np.arange(start, end)
                self._next_generated_key = end
            else:
                keys, values = parsed
            if len(keys):
                dropped = self.table.multi_put(keys, values) or 0
                total += len(keys) - dropped
        return total

    def drop(self) -> None:
        """Release this handle's reference to the table."""
        self._master.drop_table(self.table_id)


class ETMaster:
    """Owns the executors and the tables of the jobs that run on them."""

    def __init__(self, pool: Optional[DevicePool] = None) -> None:
        self._pool = pool or DevicePool()
        self._lock = threading.RLock()
        self._executors: Dict[str, Executor] = {}
        self._tables: Dict[str, Table] = {}
        self._block_managers: Dict[str, BlockManager] = {}
        self._data_axis: Dict[str, int] = {}
        # Shared-table lifetime: get_or_create_table hands one table to
        # several jobs, so its storage is freed only when the LAST holder
        # drops it (a creator finishing first must not free a tenant's table).
        self._table_refs: Dict[str, int] = {}
        # At most ONE optimization loop may drive a table's migrations: two
        # orchestrators planning from stale snapshots would race competing
        # plans against one block map.
        self._optimizer_leases: set = set()
        self._executor_ids = itertools.count()   # never reused

    # -- executors -------------------------------------------------------

    def add_executors(self, num: int, conf: Any = None) -> List[Executor]:
        """Allocate ``num`` executors, each leasing one slot of the pool
        exclusively; all or nothing. ``conf`` is the reference's
        heterogeneous request (an ``ExecutorConfig`` naming a device kind or
        a host process): the port's pool has one kind of slot, so only None
        is taken."""
        if conf is not None:
            raise ValueError(f"heterogeneous executor requests are not ported: {conf!r}")
        out: List[Executor] = []
        with self._lock:
            try:
                for _ in range(num):
                    eid = f"executor-{next(self._executor_ids)}"
                    (slot,) = self._pool.lease(eid, 1)
                    ex = self._executors[eid] = Executor(eid, slot)
                    out.append(ex)
            except RuntimeError as e:
                for ex in out:
                    self._executors.pop(ex.id, None)
                    self._pool.release(ex.id)
                raise RuntimeError(f"cannot allocate {num} executors: {e}") from None
        return out

    def remove_executor(self, executor_id: str) -> None:
        """Close an executor and return its slot to the pool (the reference's
        AllocatedExecutor.close). No table may still be associated with it."""
        with self._lock:
            for tid, bm in self._block_managers.items():
                if executor_id in bm.executors:
                    raise RuntimeError(f"{executor_id} still associated with {tid}")
            ex = self._executors.pop(executor_id)
            ex.closed = True
            self._pool.release(executor_id)

    def executor(self, executor_id: str) -> Executor:
        with self._lock:
            return self._executors[executor_id]

    def executor_ids(self) -> List[str]:
        with self._lock:
            return list(self._executors)

    # -- tables ----------------------------------------------------------

    def create_table(self, config: TableConfig, executor_ids: Sequence[str],
                     data_axis: int = 1) -> Table:
        """Create a table over ``executor_ids`` (the reference's
        ``ETMaster.createTable``): on the mesh of their slots, ``data_axis``
        rows deep (:func:`_mesh_over`), owned evenly by them; a
        ``DeviceHashTable`` when ``config.sparse``, else a ``DenseTable``."""
        with self._lock:
            if config.table_id in self._tables:
                raise ValueError(f"table {config.table_id} exists")
            if not executor_ids:
                raise ValueError("need at least one associator")
            mesh = _mesh_over([self._executors[e].slot for e in executor_ids], data_axis)
            if config.sparse:
                table = DeviceHashTable(HashTableSpec(config), mesh)
            else:
                table = DenseTable(TableSpec(config), mesh)
            self._tables[config.table_id] = table
            self._block_managers[config.table_id] = BlockManager(
                config.table_id, table.spec.num_blocks, executor_ids)
            self._data_axis[config.table_id] = data_axis
            self._table_refs[config.table_id] = 1
            return table

    def get_or_create_table(self, config: TableConfig, executor_ids: Sequence[str],
                            data_axis: int = 1) -> Tuple[Table, bool]:
        """Atomic check-then-create (two jobs racing to share one table id
        must not both create it): the existing table with one more
        reference, or a new one. Returns (table, created)."""
        with self._lock:
            if config.table_id in self._tables:
                self._table_refs[config.table_id] += 1
                return self._tables[config.table_id], False
            return self.create_table(config, executor_ids, data_axis), True

    def get_table(self, table_id: str) -> Table:
        with self._lock:
            return self._tables[table_id]

    def table_handle(self, table_id: str) -> TableHandle:
        """The table with its block manager (the reference's ``get_table``)."""
        with self._lock:
            table = self._tables[table_id]
            return TableHandle(self, table, self._block_managers[table_id].executors)

    def table_ids(self) -> List[str]:
        with self._lock:
            return list(self._tables)

    def data_axis_of(self, table_id: str) -> int:
        with self._lock:
            return self._data_axis.get(table_id, 1)

    def acquire_optimizer_lease(self, table_id: str) -> bool:
        """True if the caller may run the optimization loop for this table
        (exclusive; see ``_optimizer_leases``)."""
        with self._lock:
            if table_id in self._optimizer_leases:
                return False
            self._optimizer_leases.add(table_id)
            return True

    def release_optimizer_lease(self, table_id: str) -> None:
        with self._lock:
            self._optimizer_leases.discard(table_id)

    def block_manager_of(self, table: Table) -> Optional[BlockManager]:
        """The block manager of a table this master holds; None for a table
        made outside it, or dropped."""
        with self._lock:
            tid = table.spec.table_id
            return self._block_managers[tid] if self._tables.get(tid) is table else None

    def drop_table(self, table_id: str) -> None:
        """Release one reference; the storage is freed when the last holder
        drops (idempotent once the table is gone)."""
        with self._lock:
            refs = self._table_refs.get(table_id)
            if refs is None:
                return
            if refs > 1:
                self._table_refs[table_id] = refs - 1
                return
            del self._table_refs[table_id]
            table = self._tables.pop(table_id)
            self._block_managers.pop(table_id, None)
            self._data_axis.pop(table_id, None)
        table.drop()
