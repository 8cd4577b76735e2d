"""Canned optimizers for tests (ref: optimizer/impl/SampleOptimizers.java,
383 LoC — AddOneServer/DeleteOneServer/AddOneWorker/DeleteOneWorker plans
used by the integration tests to force live migrations).

A copy of ``harmony_tpu/optimizer/sample.py``.
"""
from __future__ import annotations

import itertools

from harmony_tpu_torch.optimizer.api import DolphinPlan, EvaluatorParams, Optimizer, TransferStep

_vids = itertools.count()


class EmptyPlanOptimizer(Optimizer):
    def optimize(self, params: EvaluatorParams, num_available_evaluators: int) -> DolphinPlan:
        return DolphinPlan()


class AddOneServerOptimizer(Optimizer):
    """Grow the table by one executor, pulling an even share of blocks from
    the current largest owner. Fires at most ``max_times``."""

    def __init__(self, max_times: int = 1) -> None:
        self._remaining = max_times

    def optimize(self, params: EvaluatorParams, num_available_evaluators: int) -> DolphinPlan:
        # num_available_evaluators is a TOTAL (current + free): growing by
        # one needs strictly more total capacity than current owners.
        if (
            self._remaining <= 0
            or not params.block_counts
            or num_available_evaluators <= len(params.block_counts)
        ):
            return DolphinPlan()
        self._remaining -= 1
        donor, donor_blocks = max(params.block_counts.items(), key=lambda kv: kv[1])
        share = max(1, donor_blocks // 2)
        vid = f"sample-add-{next(_vids)}"
        return DolphinPlan(
            evaluators_to_add=[vid],
            transfer_steps=[TransferStep(params.table_id or "", donor, vid, share)],
        )


class DeleteOneServerOptimizer(Optimizer):
    """Drain the smallest owner and remove it. Fires at most ``max_times``."""

    def __init__(self, max_times: int = 1) -> None:
        self._remaining = max_times

    def optimize(self, params: EvaluatorParams, num_available_evaluators: int) -> DolphinPlan:
        if self._remaining <= 0 or len(params.block_counts) < 2:
            return DolphinPlan()
        self._remaining -= 1
        victim, victim_blocks = min(params.block_counts.items(), key=lambda kv: kv[1])
        receiver = max(params.block_counts.items(), key=lambda kv: kv[1])[0]
        steps = (
            [TransferStep(params.table_id or "", victim, receiver, victim_blocks)]
            if victim_blocks
            else []
        )
        return DolphinPlan(evaluators_to_delete=[victim], transfer_steps=steps)
