"""ETPlan — a DAG of reconfiguration ops.

Parity with the reference's ETPlan (services/et/.../plan/impl/ETPlan.java:
37-80): ops plus dependency edges; the executor pops ready ops, runs them,
and marks completion to release dependents.

A copy of ``harmony_tpu/plan/plan.py`` over the port's copy of
``utils/dag.py``.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

from harmony_tpu_torch.plan.ops import Op
from harmony_tpu_torch.utils.dag import DAG


class ETPlan:
    def __init__(self) -> None:
        self._dag: DAG[Op] = DAG()
        self._num_ops = 0

    def add_op(self, op: Op, depends_on: Optional[Iterable[Op]] = None) -> Op:
        self._dag.add_vertex(op)
        self._num_ops += 1
        for dep in depends_on or ():
            self._dag.add_edge(dep, op)
        return op

    def add_chain(self, ops: List[Op]) -> List[Op]:
        """Convenience: sequential dependency chain."""
        prev = None
        for op in ops:
            self.add_op(op, depends_on=[prev] if prev else None)
            prev = op
        return ops

    @property
    def num_ops(self) -> int:
        return self._num_ops

    def ready_ops(self) -> List[Op]:
        return self._dag.roots()

    def on_complete(self, op: Op) -> List[Op]:
        """Mark ``op`` done; returns newly-ready dependents."""
        return self._dag.remove(op)

    def remaining(self) -> int:
        return len(self._dag)
