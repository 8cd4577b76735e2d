"""ETMaster — the master's table lifecycle, on one device.

Counterpart of ``harmony_tpu/runtime/master.py``, cut to what a job entity
needs in this port: create a job's table on the master's device, look it up,
and drop it. Executors, block ownership, migration and multi-device meshes are
not ported yet.
"""
from __future__ import annotations

import threading
from typing import Dict, List

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.table.table import DenseTable, TableSpec
from harmony_tpu_torch.utils.platform import DeviceLike, resolve_device


class ETMaster:
    """Owns the tables of the jobs running on one device."""

    def __init__(self, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._tables: Dict[str, DenseTable] = {}

    def create_table(self, config: TableConfig) -> DenseTable:
        with self._lock:
            if config.table_id in self._tables:
                raise ValueError(f"table {config.table_id} exists")
            table = DenseTable(TableSpec(config), self.device)
            self._tables[config.table_id] = table
            return table

    def table_ids(self) -> List[str]:
        with self._lock:
            return list(self._tables)

    def drop_table(self, table_id: str) -> None:
        """Release a table's storage (idempotent)."""
        with self._lock:
            self._tables.pop(table_id, None)
