"""Phase timing, metric records and the metrics that the reference's
``harmony_tpu/metrics/__init__.py`` exports: the instruments, the tenant
ledger, the step-phase budget and critical path, and the scrape cycle's
history store, scraper and doctor."""
from harmony_tpu_torch.metrics.tracer import Tracer
from harmony_tpu_torch.metrics.accounting import LedgerStore, ledger
from harmony_tpu_torch.metrics.critpath import analyze, classify
from harmony_tpu_torch.metrics.doctor import Diagnosis, Doctor, all_rules
from harmony_tpu_torch.metrics.phases import (
    PHASES,
    PhaseBudgetStore,
    budget,
    split_device_phases,
)
from harmony_tpu_torch.metrics.history import (
    HistoryScraper,
    HistoryStore,
    ScrapeClient,
)
from harmony_tpu_torch.metrics.collector import (
    BatchMetrics,
    EpochMetrics,
    InputPipelineMetrics,
    MetricCollector,
    ServerMetrics,
)
from harmony_tpu_torch.metrics.manager import MetricManager
from harmony_tpu_torch.metrics.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    get_registry,
    set_registry,
)

__all__ = [
    "Tracer",
    "LedgerStore",
    "ledger",
    "PHASES",
    "PhaseBudgetStore",
    "budget",
    "split_device_phases",
    "analyze",
    "classify",
    "Diagnosis",
    "Doctor",
    "all_rules",
    "HistoryScraper",
    "HistoryStore",
    "ScrapeClient",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "get_registry",
    "set_registry",
    "BatchMetrics",
    "EpochMetrics",
    "InputPipelineMetrics",
    "ServerMetrics",
    "MetricCollector",
    "MetricManager",
]
