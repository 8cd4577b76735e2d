from harmony_tpu_torch.pregel.computation import Computation
from harmony_tpu_torch.pregel.graph import Graph
from harmony_tpu_torch.pregel.master import PregelMaster

__all__ = ["Graph", "Computation", "PregelMaster"]
