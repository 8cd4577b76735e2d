"""ETMaster — executors and the tables placed on them.

Counterpart of ``harmony_tpu/runtime/master.py``, cut to what a job entity
needs in this port: executors, each leasing one slot of the
:class:`DevicePool` (``add_executors``; a slot is a place on one device,
``parallel/mesh.py``), and the table lifecycle (create a job's table over its
executors, list, drop): a ``DenseTable``, or a ``DeviceHashTable`` when the
config is ``sparse``. A table over several executors is split block-major
over the mesh of their slots (:func:`_mesh_over`, ``data_axis`` rows of
replicas, the blocks sharded along the model axis), and each table has the
reference's ``BlockManager``, the logical ownership its checkpoint
manifests record. :class:`TableHandle` is the reference's handle cut to what
the checkpoint path and the bulk loader read (the table, its executors, its
block ownership, ``load``, drop): ``create_table`` returns the table itself,
and the checkpoint manager wraps what it restores in a handle. Block
migration, rebalancing and resharding a live table are not ported yet
(ROADMAP A.10).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.parallel.mesh import DevicePool, Mesh, Slot, build_mesh
from harmony_tpu_torch.table.hashtable import MIN_KEY, DeviceHashTable, HashTableSpec
from harmony_tpu_torch.table.ownership import BlockManager
from harmony_tpu_torch.table.table import DenseTable, TableSpec

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
    not factor."""
    n = len(slots)
    if data_axis > 1 and n % data_axis == 0:
        return build_mesh(slots, data=data_axis)
    return build_mesh(slots, data=1)


class Executor:
    """One slot (the reference's AllocatedExecutor)."""

    def __init__(self, executor_id: str, slot: Slot) -> None:
        self.id = executor_id
        self.slot = slot
        self.device: torch.device = slot.device
        self.closed = False

    def __repr__(self) -> str:
        return f"Executor({self.id}, {self.slot})"


class TableHandle:
    """A table with the executors it was created on (the reference's
    ``TableHandle``, cut to what the checkpoint manager and the bulk loader
    read), married to the table's ``BlockManager``."""

    def __init__(self, master: "ETMaster", table: Table,
                 executors: Sequence[str]) -> None:
        self._master = master
        self.table = table
        self.executors: List[str] = list(executors)
        held = master.block_manager_of(table) if master is not None else None
        self.block_manager = held or BlockManager(
            table.spec.table_id, table.spec.num_blocks, self.executors)
        self._next_generated_key = 0  # generated keys of load()

    @property
    def table_id(self) -> str:
        return self.table.spec.table_id

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

        n = num_splits or max(len(self.executors), 1)
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

    # -- executors -------------------------------------------------------

    def add_executors(self, num: int) -> List[Executor]:
        """Allocate ``num`` executors, each leasing one slot of the pool
        exclusively; all or nothing."""
        out: List[Executor] = []
        with self._lock:
            try:
                for _ in range(num):
                    eid = f"executor-{len(self._executors)}"
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

    def table_ids(self) -> List[str]:
        with self._lock:
            return list(self._tables)

    def data_axis_of(self, table_id: str) -> int:
        with self._lock:
            return self._data_axis.get(table_id, 1)

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
