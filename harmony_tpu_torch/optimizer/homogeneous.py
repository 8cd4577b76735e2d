"""Cost-model optimizer for homogeneous executors.

Parity with the reference's HomogeneousOptimizer (optimizer/impl/
HomogeneousOptimizer.java, 610 LoC): estimate how batch time decomposes into
computation (scales down with more executors sharing the work) and
communication (grows with shard count), pick the executor count minimizing
estimated batch time, and emit the add/delete + transfer plan to get there.

Cost model (per batch, d = number of owning executors):

    T(d) = comp_unit / d  +  comm_unit * (d - 1) / d

* comp_unit: measured per-batch compute normalized to ONE executor
  (avg comp_time * current owners) — compute and table-update work split
  evenly across owners (the homogeneous assumption).
* comm_unit: the asymptotic all-gather/reduce cost of the model over ICI —
  a ring collective over d shards moves (d-1)/d of the model through each
  link, hence the (d-1)/d factor (this replaces the reference's per-key RPC
  cost terms with the TPU collective cost shape).

Measured pull/push times feed comm_unit. Fused-step mode folds pull/push
device time into one program, so the worker measures the split with a
per-epoch PROBE — the step's PULL and PULL+PUSH sub-programs dispatched
standalone (WorkerTasklet._probe_comm; the fused-mode analogue of the
reference's per-op ModelAccessor pull/push timers, ModelAccessor.java:
33-49). If the probe is disabled the split degenerates to comm=0 and the
model stays conservative about growing d.

A copy of ``harmony_tpu/optimizer/homogeneous.py``.
"""
from __future__ import annotations

from typing import Dict, List

from harmony_tpu_torch.optimizer.api import DolphinPlan, EvaluatorParams, Optimizer, TransferStep

import itertools

_vids = itertools.count()


class HomogeneousOptimizer(Optimizer):
    def __init__(self, min_gain: float = 0.05) -> None:
        # Don't reconfigure for less than ``min_gain`` predicted improvement
        # (migration has a cost the reference also amortizes).
        self.min_gain = min_gain

    # -- cost model ------------------------------------------------------

    @staticmethod
    def _estimate_units(params: EvaluatorParams) -> tuple:
        d_cur = max(1, len(params.block_counts))
        wm = params.worker_metrics
        if not wm:
            return 0.0, 0.0, d_cur
        avg_comp = sum(m.comp_time_sec for m in wm) / len(wm)
        avg_comm = sum(m.pull_time_sec + m.push_time_sec for m in wm) / len(wm)
        comp_unit = avg_comp * d_cur
        comm_unit = avg_comm * d_cur / (d_cur - 1) if d_cur > 1 else avg_comm
        return comp_unit, comm_unit, d_cur

    @classmethod
    def predicted_batch_time(cls, comp_unit: float, comm_unit: float, d: int) -> float:
        return comp_unit / d + comm_unit * (d - 1) / d

    # -- planning --------------------------------------------------------

    def optimize(self, params: EvaluatorParams, num_available_evaluators: int) -> DolphinPlan:
        comp_unit, comm_unit, d_cur = self._estimate_units(params)
        if comp_unit <= 0 or not params.block_counts:
            return DolphinPlan()
        best_d, best_t = d_cur, self.predicted_batch_time(comp_unit, comm_unit, d_cur)
        for d in range(1, max(num_available_evaluators, d_cur) + 1):
            t = self.predicted_batch_time(comp_unit, comm_unit, d)
            if t < best_t:
                best_d, best_t = d, t
        cur_t = self.predicted_batch_time(comp_unit, comm_unit, d_cur)
        if best_d == d_cur or cur_t - best_t < self.min_gain * cur_t:
            return DolphinPlan()
        if best_d > d_cur:
            return self._grow_plan(params, best_d - d_cur)
        return self._shrink_plan(params, d_cur - best_d)

    @staticmethod
    def _grow_plan(params: EvaluatorParams, n_add: int) -> DolphinPlan:
        counts: Dict[str, int] = dict(params.block_counts)
        total = sum(counts.values())
        target = total // (len(counts) + n_add)
        adds: List[str] = [f"homogeneous-add-{next(_vids)}" for _ in range(n_add)]
        steps: List[TransferStep] = []
        donors = sorted(counts.items(), key=lambda kv: -kv[1])
        di = 0
        for vid in adds:
            need = target
            while need > 0 and di < len(donors):
                donor, have = donors[di]
                surplus = have - target
                if surplus <= 0:
                    di += 1
                    continue
                take = min(surplus, need)
                steps.append(TransferStep(params.table_id or "", donor, vid, take))
                donors[di] = (donor, have - take)
                need -= take
                if donors[di][1] <= target:
                    di += 1
        return DolphinPlan(evaluators_to_add=adds, transfer_steps=steps)

    @staticmethod
    def _shrink_plan(params: EvaluatorParams, n_del: int) -> DolphinPlan:
        counts = dict(params.block_counts)
        victims = [k for k, _ in sorted(counts.items(), key=lambda kv: kv[1])[:n_del]]
        survivors = [k for k in counts if k not in victims]
        if not survivors:
            return DolphinPlan()
        steps: List[TransferStep] = []
        si = 0
        for v in victims:
            if counts[v] > 0:
                steps.append(
                    TransferStep(params.table_id or "", v, survivors[si % len(survivors)], counts[v])
                )
                si += 1
        return DolphinPlan(evaluators_to_delete=victims, transfer_steps=steps)
