"""Typed metric records + executor-side collector.

Parity with the reference's two metric layers (SURVEY.md §5.5):
  * typed Dolphin metrics — BatchMetrics / EpochMetrics / ServerMetrics
    (jobserver/src/main/avro/metrics.avsc:25-245),
  * the ET executor-side MetricCollector with custom metrics and periodic
    flush to the driver (services/et/.../metric/MetricCollector.java).

Records are dataclasses (JSON-able via config.base encoding rules) pushed to
an in-process sink; the driver-side MetricManager consumes them.

A copy of ``harmony_tpu/metrics/collector.py`` less ``InputPipelineMetrics``,
whose source (the prefetcher's per-epoch report) comes with the rest of
``metrics/`` (ROADMAP A item 6). The sources here: the worker's drain emits
one ``BatchMetrics`` a batch, the job entity one ``ServerMetrics`` an owning
executor an epoch.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from harmony_tpu_torch.config.base import ConfigBase, config


@config
class BatchMetrics(ConfigBase):
    """Per-mini-batch worker report (ref: metrics.avsc BatchMetrics:164-201;
    data_processing_rate is the reference's headline per-batch number)."""

    job_id: str = ""
    worker_id: str = ""
    epoch_idx: int = 0
    batch_idx: int = 0
    num_examples: int = 0
    batch_time_sec: float = 0.0
    pull_time_sec: float = 0.0
    comp_time_sec: float = 0.0
    push_time_sec: float = 0.0
    loss: float = 0.0

    @property
    def data_processing_rate(self) -> float:
        return self.num_examples / self.batch_time_sec if self.batch_time_sec else 0.0


@config
class EpochMetrics(ConfigBase):
    """Per-epoch worker report (ref: metrics.avsc EpochMetrics)."""

    job_id: str = ""
    worker_id: str = ""
    epoch_idx: int = 0
    num_examples: int = 0
    epoch_time_sec: float = 0.0
    loss: float = 0.0


@config
class ServerMetrics(ConfigBase):
    """Table-owner-side report (ref: metrics.avsc ServerMetrics + ET
    MetricReportMsg built-ins: block counts, pull counts/bytes)."""

    job_id: str = ""
    executor_id: str = ""
    window_idx: int = 0
    num_blocks: int = 0
    pull_count: int = 0
    push_count: int = 0
    pull_bytes: int = 0


class MetricCollector:
    """Executor-side collector: add custom metrics, flush to a sink callback
    (ref: MetricCollector.addCustomMetric()/flush())."""

    def __init__(
        self,
        sink: Optional[Callable[[Any], None]] = None,
        job_id: str = "",
        worker_id: str = "",
    ) -> None:
        self._sink = sink
        # Job context stamped onto custom-metric dicts at flush: without
        # it they post with job_id="" and are invisible to per-job
        # dashboard queries (typed records carry their own ids).
        self.job_id = job_id
        self.worker_id = worker_id
        self._lock = threading.Lock()
        self._pending: List[Any] = []
        self._custom: Dict[str, float] = {}

    def add(self, record: Any) -> None:
        with self._lock:
            self._pending.append(record)

    def add_custom_metric(self, key: str, value: float) -> None:
        with self._lock:
            self._custom[key] = self._custom.get(key, 0.0) + value

    def flush(self) -> List[Any]:
        with self._lock:
            out, self._pending = self._pending, []
            if self._custom:
                rec = dict(self._custom)
                # never clobber user keys of the same name
                rec.setdefault("job_id", self.job_id)
                rec.setdefault("worker_id", self.worker_id)
                out.append(rec)
                self._custom = {}
        if self._sink is not None:
            for r in out:
                self._sink(r)
        return out
