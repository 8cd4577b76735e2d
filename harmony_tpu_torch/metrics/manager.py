"""Driver-side metric store feeding the optimizer.

Parity with the reference's Dolphin MetricManager (dolphin/metric/
MetricManager.java:30-90): validates and stores worker/server metrics keyed
by epoch/batch windows, supports pause/resume around reconfigurations (so
migration-skewed samples don't feed the optimizer), and exposes aggregates.

A copy of ``harmony_tpu/metrics/manager.py``: the store, the queries the
optimizer loop reads (``worker_batch_metrics``, ``server_metrics``), the input
pipeline's reports, and what STATUS and ``obs top`` / ``obs critpath`` read:
``fault_counters``, ``straggler_report``, ``tenant_ledger`` (the process's
ledger, metrics/accounting.py, joined with the phase budget) and
``phase_budget`` (metrics/phases.py and metrics/critpath.py). The reference's
``fault_counters`` also counts the isolated checkpoint worker's respawns
(``chkp.iso.respawns``), a JAX-only backend that has no counterpart here.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Dict, List, Optional

from harmony_tpu_torch.metrics.collector import (
    BatchMetrics,
    EpochMetrics,
    InputPipelineMetrics,
    ServerMetrics,
)


class MetricManager:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._collecting = False
        self._batch: Dict[str, List[BatchMetrics]] = defaultdict(list)
        self._epoch: Dict[str, List[EpochMetrics]] = defaultdict(list)
        self._server: Dict[str, List[ServerMetrics]] = defaultdict(list)
        self._pipeline: Dict[str, List[InputPipelineMetrics]] = defaultdict(list)

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
                self._pipeline.clear()
                return
            for store in (self._batch, self._epoch, self._server, self._pipeline):
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
            elif isinstance(record, InputPipelineMetrics):
                self._pipeline[record.worker_id].append(record)
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

    def input_pipeline_metrics(
        self, worker_id: Optional[str] = None, job_id: Optional[str] = None
    ) -> List[InputPipelineMetrics]:
        """Per-epoch prefetch reports (dolphin/prefetch.py) — the input to
        "is input the bottleneck?" queries: a worker whose
        consumer_stall_sec dominates its epoch time is input-bound."""
        with self._lock:
            if worker_id is not None:
                ms = list(self._pipeline.get(worker_id, []))
            else:
                ms = [m for mlist in self._pipeline.values() for m in mlist]
        if job_id is not None:
            ms = [m for m in ms if m.job_id == job_id]
        return ms

    def fault_counters(self) -> Dict[str, int]:
        """Fault-injection fires (``site:action``) + retry counters
        (``op.retries`` / ``op.giveups``) for THIS process, from
        harmony_tpu_torch.faults. Zero entries on a healthy fabric with no plan
        armed; ``*.retries`` shows transient infra trouble before it
        becomes a giveup, and ``*.giveups`` feeds the pod's
        infra-dead/auto-resume path."""
        from harmony_tpu_torch import faults

        return faults.all_counters()

    def straggler_report(
        self, job_id: Optional[str] = None
    ) -> Dict[str, Dict[str, Any]]:
        """Per-job straggler attribution from the stored per-batch step
        times: mean batch seconds per worker, the slowest worker, and the
        slowest/median ratio — the "which tenant's step times regressed,
        on which executor" answer TPU-pod practice lives by (step-time
        variance IS the scaling signal at pod scale, arXiv:2011.03641).
        Ratio ~1.0 = healthy; >> 1 names the straggler. Jobs with one
        worker report ratio 1.0 (no peers to lag)."""
        import statistics

        with self._lock:
            per_job: Dict[str, Dict[str, List[float]]] = {}
            for wid, ms in self._batch.items():
                for m in ms:
                    if job_id is not None and m.job_id != job_id:
                        continue
                    per_job.setdefault(m.job_id, {}).setdefault(
                        wid, []).append(m.batch_time_sec)
        out: Dict[str, Dict[str, Any]] = {}
        for jid, workers in per_job.items():
            means = {w: sum(ts) / len(ts) for w, ts in workers.items() if ts}
            if not means:
                continue
            med = statistics.median(means.values())
            slowest = max(means, key=means.get)
            out[jid] = {
                "workers": {w: round(v, 6) for w, v in means.items()},
                "slowest": slowest,
                "slowest_sec": round(means[slowest], 6),
                "median_sec": round(med, 6),
                "ratio": round(means[slowest] / med, 3) if med > 0 else 1.0,
            }
        return out

    def tenant_ledger(
        self, window_sec: Optional[float] = None,
        stragglers: Optional[Dict[str, Dict[str, Any]]] = None,
    ) -> Dict[str, Dict[str, Any]]:
        """Per-tenant device cost vectors (metrics/accounting.py) joined
        with this manager's straggler attribution — the one-call answer
        to "what does each tenant cost, and is it healthy". Rides the
        STATUS payload (``tenants``) and ``obs top``; the policy engine
        (ROADMAP A item 5.2) reads the same join. Keys are job ids; the
        fields are the reference's (metrics/accounting.py's docstring)."""
        from harmony_tpu_torch.metrics.accounting import ledger
        from harmony_tpu_torch.metrics.phases import peek_budget

        rows = ledger().snapshot(window_sec)
        # ``stragglers`` lets one STATUS reply share a single report
        # walk across its stragglers/tenants/phase_budget fields
        if stragglers is None:
            stragglers = self.straggler_report()
        # step-phase budget join (metrics/phases.py): each tenant row
        # carries its windowed phase FRACTIONS (the history scraper folds
        # them as tenant.phase.* series); peek —
        # a ledger query must not instantiate budget state
        store = peek_budget()
        budgets = (store.snapshot_memoized(window_sec)
                   if store is not None else {})
        for jid, row in rows.items():
            rep = stragglers.get(jid)
            row["straggler_ratio"] = rep["ratio"] if rep else None
            b = budgets.get(jid)
            if b:
                from harmony_tpu_torch.metrics import critpath

                row["phases"] = dict(b["fractions"])
                row["phase_class"] = critpath.classify(b["fractions"])
            else:
                row["phases"] = None
                row["phase_class"] = None
        return rows

    def phase_budget(
        self, window_sec: Optional[float] = None,
        stragglers: Optional[Dict[str, Dict[str, Any]]] = None,
    ) -> Dict[str, Dict[str, Any]]:
        """Per-tenant step-phase budgets enriched with the critical-path
        attribution (metrics/critpath.py): classification, dominant
        phase, and per-epoch gating worker+phase — what STATUS
        ``phase_budget`` and ``obs critpath`` render. Empty
        before any worker fed the budget store."""
        from harmony_tpu_torch.metrics import critpath
        from harmony_tpu_torch.metrics.phases import peek_budget

        store = peek_budget()
        if store is None:
            return {}
        # the memoized snapshot: one STATUS builds both its `tenants`
        # join and this payload from ONE store walk (and may pass one
        # shared straggler report the same way)
        return critpath.analyze(
            store.snapshot_memoized(window_sec),
            stragglers=(stragglers if stragglers is not None
                        else self.straggler_report()))

    def aggregate_throughput(self, job_id: Optional[str] = None) -> float:
        """Aggregate samples/sec across workers (the BASELINE north-star
        metric: reference BatchMetrics.dataProcessingRate summed)."""
        with self._lock:
            per_worker: Dict[str, List[BatchMetrics]] = defaultdict(list)
            for w, ms in self._batch.items():
                for m in ms:
                    if job_id is None or m.job_id == job_id:
                        per_worker[w].append(m)
        total = 0.0
        for ms in per_worker.values():
            t = sum(m.batch_time_sec for m in ms)
            n = sum(m.num_examples for m in ms)
            if t > 0:
                total += n / t
        return total
