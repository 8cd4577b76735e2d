"""ETMaster — executors and the tables placed on them.

Counterpart of ``harmony_tpu/runtime/master.py``, cut to what a job entity
needs in this port: executors, each leasing one device from the
:class:`DevicePool` (``add_executors``), and the table lifecycle (create a
job's table on its executors' device, list, drop). A table lives on one
device. Block ownership, migration, checkpoint restore and tables spread
over several devices are not ported yet (ROADMAP A.9, A.10).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.table.table import DenseTable, TableSpec


class Executor:
    """One device slot (the reference's AllocatedExecutor)."""

    def __init__(self, executor_id: str, device: torch.device) -> None:
        self.id = executor_id
        self.device = device

    def __repr__(self) -> str:
        return f"Executor({self.id}, {self.device})"


class ETMaster:
    """Owns the executors and the tables of the jobs that run on them."""

    def __init__(self, pool: Optional[DevicePool] = None) -> None:
        self._pool = pool or DevicePool()
        self._lock = threading.Lock()
        self._executors: Dict[str, Executor] = {}
        self._tables: Dict[str, DenseTable] = {}

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

    def executor_ids(self) -> List[str]:
        with self._lock:
            return list(self._executors)

    # -- tables ----------------------------------------------------------

    def create_table(self, config: TableConfig, executor_ids: Sequence[str]) -> DenseTable:
        """Create a table on the device of ``executor_ids`` (all on one device:
        a table spread over several is not ported yet)."""
        with self._lock:
            devices = {self._executors[e].device for e in executor_ids}
            if len(devices) != 1:
                raise NotImplementedError(
                    f"table {config.table_id}: executors {list(executor_ids)} span "
                    f"devices {sorted(map(str, devices))}; one device a table is ported")
            if config.table_id in self._tables:
                raise ValueError(f"table {config.table_id} exists")
            table = DenseTable(TableSpec(config), devices.pop())
            self._tables[config.table_id] = table
            return table

    def table_ids(self) -> List[str]:
        with self._lock:
            return list(self._tables)

    def drop_table(self, table_id: str) -> None:
        """Release a table's storage (idempotent)."""
        with self._lock:
            self._tables.pop(table_id, None)
