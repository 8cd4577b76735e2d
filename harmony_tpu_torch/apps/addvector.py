"""AddVector / AddInteger: exact-sum correctness apps.

Counterpart of ``harmony_tpu/apps/addvector.py`` (the reference's validator
apps): every example adds a fixed delta to every model key, so at the job's
end each key holds exactly ``total_examples_processed * delta``, which shows
that no push was lost or applied twice. The per-example contribution is a
sum over the batch, so it goes through the same reduction a gradient push
takes.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.dolphin.trainer import Trainer


class AddVectorTrainer(Trainer):
    pull_mode = "all"
    # the delta and "pushed" are batch sums (a data axis > 1 adds the parts)
    batch_reduction = "sum"

    def __init__(self, num_keys: int, vector_dim: int, delta: float = 1.0) -> None:
        self.num_keys = num_keys
        self.vector_dim = vector_dim
        self.delta = delta

    def model_table_config(self, table_id: str = "addvector-model") -> TableConfig:
        return TableConfig(
            table_id=table_id,
            capacity=self.num_keys,
            value_shape=(self.vector_dim,),
            num_blocks=min(self.num_keys, 16),
            update_fn="add",
        )

    def compute(self, model: torch.Tensor, batch: Tuple[torch.Tensor, ...],
                hyper: Dict[str, torch.Tensor]):
        (marks,) = batch  # [B] of 1.0 per example
        count = torch.sum(marks)
        delta = torch.ones_like(model) * (count * self.delta)
        return delta, {"pushed": count}

    def expected_value(self, total_examples: int) -> float:
        return total_examples * self.delta


class AddIntegerTrainer(AddVectorTrainer):
    """Scalar-valued variant (the reference's AddIntegerTrainer)."""

    def __init__(self, num_keys: int, delta: float = 1.0) -> None:
        super().__init__(num_keys, vector_dim=0, delta=delta)

    def model_table_config(self, table_id: str = "addint-model") -> TableConfig:
        return TableConfig(
            table_id=table_id,
            capacity=self.num_keys,
            value_shape=(),
            num_blocks=min(self.num_keys, 16),
            update_fn="add",
        )


def make_marks(n: int) -> Tuple[np.ndarray]:
    """The input set: one 1.0 mark per example."""
    return (np.ones(n, np.float32),)
