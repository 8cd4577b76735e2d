"""PlanExecutor — dependency-driven parallel plan execution.

Parity with the reference's PlanExecutorImpl (services/et/.../plan/impl/
PlanExecutorImpl.java:41-130): pop ready ops, execute up to
``max_concurrent`` (reference: 16) simultaneously on a thread pool, mark
complete, release dependents; virtual executor ids are resolved when their
AllocateOp completes (PlanExecutorImpl.java:110-112 — here via the shared
PlanContext.virtual_ids map).

A copy of ``harmony_tpu/plan/executor.py``.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional

from harmony_tpu_torch.plan.ops import Op, PlanContext
from harmony_tpu_torch.plan.plan import ETPlan


class PlanResult:
    def __init__(self) -> None:
        self.executed: List[Op] = []
        self.failed: Optional[Op] = None
        self.error: Optional[BaseException] = None

    @property
    def success(self) -> bool:
        return self.failed is None


class PlanExecutor:
    MAX_CONCURRENT = 16  # reference executes up to 16 ops at once

    def __init__(self, master: Any, tasklet_runner: Optional[Any] = None) -> None:
        self._master = master
        self._tasklet_runner = tasklet_runner
        self._listeners: List[Any] = []

    def add_listener(self, cb) -> None:
        """cb(op) fires after each op completes (plan progress)."""
        self._listeners.append(cb)

    def execute(self, plan: ETPlan) -> PlanResult:
        ctx = PlanContext(self._master, self._tasklet_runner)
        result = PlanResult()
        cond = threading.Condition()
        in_flight = [0]

        with ThreadPoolExecutor(max_workers=self.MAX_CONCURRENT) as pool:

            def launch(op: Op) -> None:
                in_flight[0] += 1
                pool.submit(run, op)

            def run(op: Op) -> None:
                err = None
                try:
                    op.execute(ctx)
                except BaseException as e:  # noqa: BLE001 - reported to caller
                    err = e
                with cond:
                    in_flight[0] -= 1
                    if err is not None:
                        if result.failed is None:
                            result.failed, result.error = op, err
                    else:
                        result.executed.append(op)
                        for cb in self._listeners:
                            cb(op)
                        if result.failed is None:
                            for nxt in plan.on_complete(op):
                                launch(nxt)
                    cond.notify_all()

            with cond:
                for op in plan.ready_ops():
                    launch(op)
                cond.wait_for(lambda: in_flight[0] == 0)
        return result
