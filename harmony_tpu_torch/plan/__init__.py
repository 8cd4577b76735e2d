from harmony_tpu_torch.plan.ops import (
    AllocateOp,
    AssociateOp,
    CreateOp,
    DeallocateOp,
    DropOp,
    MoveOp,
    Op,
    StartOp,
    StopOp,
    SubscribeOp,
    UnassociateOp,
    UnsubscribeOp,
)
from harmony_tpu_torch.plan.plan import ETPlan
from harmony_tpu_torch.plan.executor import PlanExecutor

__all__ = [
    "Op",
    "AllocateOp",
    "DeallocateOp",
    "CreateOp",
    "DropOp",
    "AssociateOp",
    "UnassociateOp",
    "SubscribeOp",
    "UnsubscribeOp",
    "MoveOp",
    "StartOp",
    "StopOp",
    "ETPlan",
    "PlanExecutor",
]
