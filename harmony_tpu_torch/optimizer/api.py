"""Optimizer SPI and the Dolphin-level plan vocabulary.

Parity with the reference's optimizer layer (SURVEY.md §2.6):
``Optimizer.optimize(evalParams, availableEvaluators) -> Plan``
(ref: optimizer/api/Optimizer.java:27-37) where a Plan lists evaluators to
add/delete plus per-table TransferSteps (ref: plan/api/Plan.java:26-50,
TransferStep). The PlanCompiler lowers this to the ET op DAG.

A copy of ``harmony_tpu/optimizer/api.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Any, Dict, List, Optional

from harmony_tpu_torch.metrics.collector import BatchMetrics, ServerMetrics


@dataclasses.dataclass
class TransferStep:
    table_id: str
    src: str
    dst: str                 # real id or virtual id bound by an add
    num_blocks: int


@dataclasses.dataclass
class DolphinPlan:
    """What the optimizer asks for (app-level, executor-count granularity)."""

    evaluators_to_add: List[str] = field(default_factory=list)    # virtual ids
    evaluators_to_delete: List[str] = field(default_factory=list)  # real ids
    transfer_steps: List[TransferStep] = field(default_factory=list)
    # Optional per-request resource spec for an added evaluator (virtual id
    # -> ExecutorConfig with device_kind / process_index) — heterogeneous
    # requests flow through AllocateOp to DevicePool.lease's matching (ref:
    # HeterogeneousEvalManager.java:40-70). Absent = homogeneous.
    add_specs: Dict[str, Any] = field(default_factory=dict)

    @property
    def empty(self) -> bool:
        return not (self.evaluators_to_add or self.evaluators_to_delete or self.transfer_steps)


@dataclasses.dataclass
class EvaluatorParams:
    """Metric summary handed to optimizers (the reference's
    EvaluatorParameters built by the metric manager)."""

    worker_metrics: List[BatchMetrics] = field(default_factory=list)
    server_metrics: List[ServerMetrics] = field(default_factory=list)
    table_id: Optional[str] = None
    block_counts: Dict[str, int] = field(default_factory=dict)
    # worker_id -> executor_id. Jobserver workers report metrics under
    # "<job>/wN" while block_counts is keyed by executor ids; optimizers
    # must translate through this map (identity for absent keys).
    worker_to_executor: Dict[str, str] = field(default_factory=dict)


class Optimizer:
    """SPI: look at metrics, propose a plan.

    ``num_available_evaluators`` is the TOTAL number of executors the job may
    end up using — current owners plus free pool capacity (the reference
    passes the same total, availableEvals). An optimizer must never plan for
    more owners than this.
    """

    def optimize(self, params: EvaluatorParams, num_available_evaluators: int) -> DolphinPlan:
        raise NotImplementedError
