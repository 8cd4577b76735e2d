"""ETMaster — executors and the tables placed on them.

Counterpart of ``harmony_tpu/runtime/master.py``, cut to what a job entity
needs in this port: executors, each leasing one device from the
:class:`DevicePool` (``add_executors``), and the table lifecycle (create a
job's table on its executors' device, list, drop): a ``DenseTable``, or a
``DeviceHashTable`` when the config is ``sparse``. A table lives on one
device. :class:`TableHandle` is the reference's handle cut to what the
checkpoint path and the bulk loader read (the table, its executors, its block
ownership, ``load``, drop): ``create_table`` returns the table itself, and
the checkpoint manager wraps what it restores in a handle. Block migration and tables spread over several
devices are not ported yet (ROADMAP A.9, A.10).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.table.hashtable import MIN_KEY, DeviceHashTable, HashTableSpec
from harmony_tpu_torch.table.table import DenseTable, TableSpec

Table = Union[DenseTable, DeviceHashTable]


def _table_min_key(table) -> int:
    """Smallest key a table admits: ``MIN_KEY`` (1) for hash tables, whose
    key 0 is reserved, 0 for dense tables."""
    return MIN_KEY if isinstance(table, DeviceHashTable) else 0


class Executor:
    """One device slot (the reference's AllocatedExecutor)."""

    def __init__(self, executor_id: str, device: torch.device) -> None:
        self.id = executor_id
        self.device = device

    def __repr__(self) -> str:
        return f"Executor({self.id}, {self.device})"


class TableHandle:
    """A table with the executors it was created on (the reference's
    ``TableHandle``, cut to what the checkpoint manager and the bulk loader
    read). A table lives on one device: every block is owned by the first
    executor."""

    def __init__(self, master: "ETMaster", table: Table,
                 executors: Sequence[str]) -> None:
        self._master = master
        self.table = table
        self.executors: List[str] = list(executors)
        self._next_generated_key = 0  # generated keys of load()

    @property
    def table_id(self) -> str:
        return self.table.spec.table_id

    def ownership_vector(self) -> List[int]:
        """Block -> index into ``executors`` of its owner."""
        return [0] * self.table.spec.num_blocks

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
        # Shared-table lifetime: get_or_create_table hands one table to
        # several jobs, so its storage is freed only when the LAST holder
        # drops it (a creator finishing first must not free a tenant's table).
        self._table_refs: Dict[str, int] = {}

    # -- executors -------------------------------------------------------

    def add_executors(self, num: int) -> List[Executor]:
        """Allocate ``num`` executors, each leasing one device of the pool
        exclusively; all or nothing."""
        out: List[Executor] = []
        with self._lock:
            try:
                for _ in range(num):
                    eid = f"executor-{len(self._executors)}"
                    (device,) = self._pool.lease(eid, 1)
                    ex = self._executors[eid] = Executor(eid, device)
                    out.append(ex)
            except RuntimeError as e:
                for ex in out:
                    self._executors.pop(ex.id, None)
                    self._pool.release(ex.id)
                raise RuntimeError(f"cannot allocate {num} executors: {e}") from None
        return out

    def executor(self, executor_id: str) -> Executor:
        with self._lock:
            return self._executors[executor_id]

    def executor_ids(self) -> List[str]:
        with self._lock:
            return list(self._executors)

    # -- tables ----------------------------------------------------------

    def create_table(self, config: TableConfig, executor_ids: Sequence[str]) -> Table:
        """Create a table on the device of ``executor_ids`` (all on one device:
        a table spread over several is not ported yet): a ``DeviceHashTable``
        when ``config.sparse``, else a ``DenseTable``."""
        with self._lock:
            devices = {self._executors[e].device for e in executor_ids}
            if len(devices) != 1:
                raise NotImplementedError(
                    f"table {config.table_id}: executors {list(executor_ids)} span "
                    f"devices {sorted(map(str, devices))}; one device a table is ported")
            if config.table_id in self._tables:
                raise ValueError(f"table {config.table_id} exists")
            if config.sparse:
                table = DeviceHashTable(HashTableSpec(config), devices.pop())
            else:
                table = DenseTable(TableSpec(config), devices.pop())
            self._tables[config.table_id] = table
            self._table_refs[config.table_id] = 1
            return table

    def get_or_create_table(self, config: TableConfig,
                            executor_ids: Sequence[str]) -> Tuple[Table, bool]:
        """Atomic check-then-create (two jobs racing to share one table id
        must not both create it): the existing table with one more
        reference, or a new one. Returns (table, created)."""
        with self._lock:
            if config.table_id in self._tables:
                self._table_refs[config.table_id] += 1
                return self._tables[config.table_id], False
            return self.create_table(config, executor_ids), True

    def get_table(self, table_id: str) -> Table:
        with self._lock:
            return self._tables[table_id]

    def table_ids(self) -> List[str]:
        with self._lock:
            return list(self._tables)

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
        table.drop()
