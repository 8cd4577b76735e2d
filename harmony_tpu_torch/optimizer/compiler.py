"""PlanCompiler — Dolphin plan -> ET op DAG.

Parity with the reference's PlanCompiler (dolphin/plan/impl/PlanCompiler.java,
524 LoC): adds become Allocate(+Associate) chains, deletes become
drain-Move -> Unassociate -> Deallocate chains, and every TransferStep is a
MoveOp ordered after the allocation/association of its destination. The
reference also stops/starts tasklets around executor changes; here the
running workers rebuild their compiled step on layout change instead
(WorkerTasklet._maybe_rebuild), so Start/Stop ops are only emitted when a
tasklet_runner is wired.

A copy of ``harmony_tpu/optimizer/compiler.py``.
"""
from __future__ import annotations

from typing import Dict, List

from harmony_tpu_torch.optimizer.api import DolphinPlan
from harmony_tpu_torch.plan.ops import (
    AllocateOp,
    AssociateOp,
    DeallocateOp,
    MoveOp,
    Op,
    UnassociateOp,
)
from harmony_tpu_torch.plan.plan import ETPlan


class PlanCompiler:
    def compile(self, dplan: DolphinPlan, table_id: str) -> ETPlan:
        stray = set(dplan.add_specs) - set(dplan.evaluators_to_add)
        if stray:
            # a typo'd virtual id would otherwise silently lease ANY device
            # where the optimizer asked for a specific kind
            raise ValueError(
                f"add_specs for unknown virtual ids {sorted(stray)}; "
                f"evaluators_to_add={dplan.evaluators_to_add}"
            )
        plan = ETPlan()
        alloc_ops: Dict[str, Op] = {}
        assoc_ops: Dict[str, Op] = {}
        for vid in dplan.evaluators_to_add:
            a = plan.add_op(AllocateOp(vid, conf=dplan.add_specs.get(vid)))
            alloc_ops[vid] = a
            assoc_ops[vid] = plan.add_op(AssociateOp(table_id, vid), depends_on=[a])
        move_ops: List[Op] = []
        moves_from: Dict[str, List[Op]] = {}
        for ts in dplan.transfer_steps:
            deps = []
            if ts.dst in assoc_ops:
                deps.append(assoc_ops[ts.dst])
            m = plan.add_op(
                MoveOp(ts.table_id or table_id, ts.src, ts.dst, ts.num_blocks),
                depends_on=deps or None,
            )
            move_ops.append(m)
            moves_from.setdefault(ts.src, []).append(m)
        for victim in dplan.evaluators_to_delete:
            # the victim's drain moves must land before it leaves
            deps = moves_from.get(victim, [])
            un = plan.add_op(UnassociateOp(table_id, victim), depends_on=deps or None)
            plan.add_op(DeallocateOp(victim), depends_on=[un])
        return plan
