"""Phase timing, metric records and the metrics that the reference's
``harmony_tpu/metrics/__init__.py`` exports, less those of the scrape cycle
(``HistoryScraper``, ``HistoryStore``, ``ScrapeClient``, ``Doctor``; ROADMAP A
item 6.2)."""
from harmony_tpu_torch.metrics.tracer import Tracer
from harmony_tpu_torch.metrics.accounting import LedgerStore, ledger
from harmony_tpu_torch.metrics.critpath import analyze, classify
from harmony_tpu_torch.metrics.phases import (
    PHASES,
    PhaseBudgetStore,
    budget,
    split_device_phases,
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
