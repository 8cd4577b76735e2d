"""Driver-side metric store feeding the optimizer.

Parity with the reference's Dolphin MetricManager (dolphin/metric/
MetricManager.java:30-90): validates and stores worker/server metrics keyed
by epoch/batch windows, supports pause/resume around reconfigurations (so
migration-skewed samples don't feed the optimizer), and exposes aggregates.

``harmony_tpu/metrics/manager.py`` cut to the store and the queries the
optimizer loop reads (``worker_batch_metrics``, ``server_metrics``). Its
throughput sum, fault counters, straggler report, tenant ledger and phase
budgets come with the rest of ``metrics/`` (ROADMAP A item 6).
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Dict, List, Optional

from harmony_tpu_torch.metrics.collector import BatchMetrics, EpochMetrics, ServerMetrics


class MetricManager:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._collecting = False
        self._batch: Dict[str, List[BatchMetrics]] = defaultdict(list)
        self._epoch: Dict[str, List[EpochMetrics]] = defaultdict(list)
        self._server: Dict[str, List[ServerMetrics]] = defaultdict(list)

    # -- lifecycle (ref: pause/resume around reconfig) -------------------

    def start_collection(self) -> None:
        with self._lock:
            self._collecting = True

    def stop_collection(self) -> None:
        with self._lock:
            self._collecting = False

    def clear(self, job_id: Optional[str] = None) -> None:
        """Drop stored metrics — all of them, or only one job's (a
        multi-tenant reconfiguration must not erase other tenants' data)."""
        with self._lock:
            if job_id is None:
                self._batch.clear()
                self._epoch.clear()
                self._server.clear()
                return
            for store in (self._batch, self._epoch, self._server):
                for key in list(store):
                    store[key] = [m for m in store[key] if m.job_id != job_id]
                    if not store[key]:
                        del store[key]

    # -- ingest ----------------------------------------------------------

    def on_metric(self, record: Any) -> None:
        with self._lock:
            if not self._collecting:
                return
            if isinstance(record, BatchMetrics):
                self._batch[record.worker_id].append(record)
            elif isinstance(record, EpochMetrics):
                self._epoch[record.worker_id].append(record)
            elif isinstance(record, ServerMetrics):
                self._server[record.executor_id].append(record)
            # dict custom metrics are accepted but unindexed

    # -- queries (optimizer inputs) --------------------------------------

    def worker_batch_metrics(
        self, worker_id: Optional[str] = None, job_id: Optional[str] = None
    ) -> List[BatchMetrics]:
        with self._lock:
            if worker_id is not None:
                ms = list(self._batch.get(worker_id, []))
            else:
                ms = [m for mlist in self._batch.values() for m in mlist]
        if job_id is not None:
            ms = [m for m in ms if m.job_id == job_id]
        return ms

    def server_metrics(self, job_id: Optional[str] = None) -> List[ServerMetrics]:
        with self._lock:
            ms = [m for mlist in self._server.values() for m in mlist]
        if job_id is not None:
            ms = [m for m in ms if m.job_id == job_id]
        return ms
