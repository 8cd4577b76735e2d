from harmony_tpu_torch.optimizer.api import DolphinPlan, Optimizer, TransferStep
from harmony_tpu_torch.optimizer.compiler import PlanCompiler
from harmony_tpu_torch.optimizer.homogeneous import HomogeneousOptimizer
from harmony_tpu_torch.optimizer.hetero import (
    ExecutorProfile,
    HeterogeneousOptimizer,
    ILPSolver,
    load_profiles,
)
from harmony_tpu_torch.optimizer.sample import (
    AddOneServerOptimizer,
    DeleteOneServerOptimizer,
    EmptyPlanOptimizer,
)
from harmony_tpu_torch.optimizer.orchestrator import OptimizationOrchestrator

__all__ = [
    "Optimizer",
    "DolphinPlan",
    "TransferStep",
    "PlanCompiler",
    "HomogeneousOptimizer",
    "HeterogeneousOptimizer",
    "ILPSolver",
    "ExecutorProfile",
    "load_profiles",
    "AddOneServerOptimizer",
    "DeleteOneServerOptimizer",
    "EmptyPlanOptimizer",
    "OptimizationOrchestrator",
]
