"""Reconfiguration op vocabulary.

One class per op, same vocabulary as the reference's plan engine
(services/et/.../plan/impl/op/: AllocateOp, DeallocateOp, CreateOp, DropOp,
AssociateOp, UnassociateOp, SubscribeOp, UnsubscribeOp, MoveOp, StartOp,
StopOp — SURVEY.md §2.3).

Each op executes against the ETMaster (+ an optional tasklet runner for
Start/Stop). Plans may reference *virtual* executor ids (executors that an
AllocateOp will create); the PlanExecutor substitutes real ids when the
allocation completes (ref: PlanExecutorImpl.java:110-112).

A copy of ``harmony_tpu/plan/ops.py``. The port's ``ETMaster.get_table``
returns the table itself, so the ops that act on a table's ownership go
through ``ETMaster.table_handle`` (the reference's ``get_table`` returns
that handle).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Optional

from harmony_tpu_torch.config.params import TableConfig

_op_ids = itertools.count()


class Op:
    """Base reconfiguration op; identity-hashable DAG vertex."""

    kind = "op"

    def __init__(self) -> None:
        self.op_id = next(_op_ids)

    def execute(self, ctx: "PlanContext") -> None:
        raise NotImplementedError

    def __repr__(self) -> str:
        d = {k: v for k, v in self.__dict__.items() if k != "op_id"}
        return f"{type(self).__name__}({d})"


class PlanContext:
    """Execution-time state: master, tasklet runner, virtual->real ids."""

    def __init__(self, master: Any, tasklet_runner: Optional[Any] = None) -> None:
        self.master = master
        self.tasklet_runner = tasklet_runner
        self.virtual_ids: Dict[str, str] = {}

    def resolve(self, executor_id: str) -> str:
        return self.virtual_ids.get(executor_id, executor_id)


class AllocateOp(Op):
    """Allocate one executor; binds ``virtual_id`` to the real id.

    ``conf`` (an ExecutorConfig) carries an optional heterogeneous resource
    spec — device kind / host process — matched by the pool at lease time
    (ref: HeterogeneousEvalManager.java:40-70); an unmatchable spec fails
    the op (and with it the plan) loudly."""

    kind = "allocate"

    def __init__(self, virtual_id: str, conf: Any = None) -> None:
        super().__init__()
        self.virtual_id = virtual_id
        self.conf = conf

    def execute(self, ctx: PlanContext) -> None:
        (ex,) = ctx.master.add_executors(1, self.conf)
        ctx.virtual_ids[self.virtual_id] = ex.id


class DeallocateOp(Op):
    kind = "deallocate"

    def __init__(self, executor_id: str) -> None:
        super().__init__()
        self.executor_id = executor_id

    def execute(self, ctx: PlanContext) -> None:
        ctx.master.remove_executor(ctx.resolve(self.executor_id))


class CreateOp(Op):
    kind = "create"

    def __init__(self, config: TableConfig, associators: list, data_axis: int = 1) -> None:
        super().__init__()
        self.config = config
        self.associators = associators
        self.data_axis = data_axis

    def execute(self, ctx: PlanContext) -> None:
        ctx.master.create_table(
            self.config, [ctx.resolve(e) for e in self.associators], self.data_axis
        )


class DropOp(Op):
    kind = "drop"

    def __init__(self, table_id: str) -> None:
        super().__init__()
        self.table_id = table_id

    def execute(self, ctx: PlanContext) -> None:
        ctx.master.table_handle(self.table_id).drop()


class AssociateOp(Op):
    kind = "associate"

    def __init__(self, table_id: str, executor_id: str) -> None:
        super().__init__()
        self.table_id = table_id
        self.executor_id = executor_id

    def execute(self, ctx: PlanContext) -> None:
        ctx.master.table_handle(self.table_id).associate(ctx.resolve(self.executor_id))


class UnassociateOp(Op):
    kind = "unassociate"

    def __init__(self, table_id: str, executor_id: str) -> None:
        super().__init__()
        self.table_id = table_id
        self.executor_id = executor_id

    def execute(self, ctx: PlanContext) -> None:
        ctx.master.table_handle(self.table_id).unassociate(ctx.resolve(self.executor_id))


class SubscribeOp(Op):
    """Register an ownership-update listener for an executor (ref:
    SubscriptionManager; listeners here are callables kept by BlockManager)."""

    kind = "subscribe"

    def __init__(self, table_id: str, listener) -> None:
        super().__init__()
        self.table_id = table_id
        self.listener = listener

    def execute(self, ctx: PlanContext) -> None:
        ctx.master.table_handle(self.table_id).block_manager.subscribe(self.listener)


class UnsubscribeOp(Op):
    kind = "unsubscribe"

    def __init__(self, table_id: str, listener) -> None:
        super().__init__()
        self.table_id = table_id
        self.listener = listener

    def execute(self, ctx: PlanContext) -> None:
        ctx.master.table_handle(self.table_id).block_manager.unsubscribe(self.listener)


class MoveOp(Op):
    """Migrate blocks src -> dst (ref: MoveOp -> AllocatedTable.moveBlocks)."""

    kind = "move"

    def __init__(self, table_id: str, src: str, dst: str, num_blocks: int) -> None:
        super().__init__()
        self.table_id = table_id
        self.src = src
        self.dst = dst
        self.num_blocks = num_blocks

    def execute(self, ctx: PlanContext) -> None:
        ctx.master.table_handle(self.table_id).move_blocks(
            ctx.resolve(self.src), ctx.resolve(self.dst), self.num_blocks
        )


class StartOp(Op):
    """Start a tasklet on an executor (ref: StartOp / tasklet submit)."""

    kind = "start"

    def __init__(self, executor_id: str, tasklet_conf: Any) -> None:
        super().__init__()
        self.executor_id = executor_id
        self.tasklet_conf = tasklet_conf

    def execute(self, ctx: PlanContext) -> None:
        if ctx.tasklet_runner is None:
            raise RuntimeError("StartOp needs a tasklet runner")
        ctx.tasklet_runner.start(ctx.resolve(self.executor_id), self.tasklet_conf)


class StopOp(Op):
    kind = "stop"

    def __init__(self, executor_id: str, tasklet_id: str) -> None:
        super().__init__()
        self.executor_id = executor_id
        self.tasklet_id = tasklet_id

    def execute(self, ctx: PlanContext) -> None:
        if ctx.tasklet_runner is None:
            raise RuntimeError("StopOp needs a tasklet runner")
        ctx.tasklet_runner.stop(ctx.resolve(self.executor_id), self.tasklet_id)
