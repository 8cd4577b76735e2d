"""Multinomial logistic regression — the benchmark flagship.

Counterpart of ``harmony_tpu/apps/mlr.py``. The model table holds the
[C, D] weight matrix as ``num_classes * num_partitions`` rows of one feature
partition each (key = class_idx * num_partitions + partition_idx), a range
table, so the whole-model pull is a view of the storage reshaped to [C, D].
The step is one softmax cross-entropy with both products through
:func:`mxu_dot` (bf16 operands, f32 sums); the push adds ``-lr * grad`` to
the table. No global init: the weights start at zero. The step size decays by
``decay_rate`` every ``decay_period`` epochs.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.dolphin.trainer import Trainer, TrainerContext
from harmony_tpu_torch.ops.mxu import mxu_dot


class MLRTrainer(Trainer):
    pull_mode = "all"
    # loss, accuracy and gradient are batch means (for a data axis > 1)
    batch_reduction = "mean"
    # the decay depends only on epoch_idx
    epoch_hook_windowable = True

    def __init__(
        self,
        num_classes: int,
        num_features: int,
        features_per_partition: int,
        step_size: float = 0.1,
        decay_rate: float = 0.9,
        decay_period: int = 5,
    ) -> None:
        if num_features % features_per_partition:
            raise ValueError("num_features must divide into partitions")
        self.num_classes = num_classes
        self.num_features = num_features
        self.fpp = features_per_partition
        self.num_partitions = num_features // features_per_partition
        self.step_size = step_size
        self.decay_rate = decay_rate
        self.decay_period = decay_period
        self._lr = step_size

    def model_table_config(self, table_id: str = "mlr-model",
                           num_blocks: int = 0) -> TableConfig:
        cap = self.num_classes * self.num_partitions
        return TableConfig(
            table_id=table_id,
            capacity=cap,
            value_shape=(self.fpp,),
            num_blocks=num_blocks or min(cap, 64),
            is_ordered=True,
            update_fn="add",
        )

    # -- lifecycle -------------------------------------------------------

    def on_training_start(self, ctx: TrainerContext, starting_epoch: int) -> None:
        """The decay schedule is epoch-indexed: a run resumed at epoch e starts
        from the step size an uninterrupted run had there."""
        decays = starting_epoch // self.decay_period if self.decay_period else 0
        self._lr = self.step_size * (self.decay_rate ** decays)

    def on_epoch_finished(self, ctx: TrainerContext, epoch_idx: int) -> None:
        if self.decay_period and (epoch_idx + 1) % self.decay_period == 0:
            self._lr *= self.decay_rate

    def hyperparams(self) -> Dict[str, float]:
        return {"lr": self._lr}

    # -- compute ---------------------------------------------------------

    def _weights(self, model: torch.Tensor) -> torch.Tensor:
        """[capacity, fpp] table rows -> [C, D] weight matrix."""
        return model.reshape(self.num_classes, self.num_features)

    def _logits(self, model: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return mxu_dot(x.float(), self._weights(model).T)           # [B, C]

    def _loss_and_accuracy(self, logits: torch.Tensor, y: torch.Tensor):
        logp = torch.log_softmax(logits, dim=-1)
        onehot = torch.nn.functional.one_hot(y.long(), self.num_classes).to(logits.dtype)
        loss = -torch.mean(torch.sum(onehot * logp, dim=-1))
        acc = torch.mean((torch.argmax(logits, dim=-1) == y).float())
        return logp, onehot, loss, acc

    def compute(self, model, batch, hyper):
        x, y = batch  # x [B, D] float, y [B] int
        x = x.float()
        logits = self._logits(model, x)
        logp, onehot, loss, acc = self._loss_and_accuracy(logits, y)
        probs = torch.exp(logp)
        grad_w = mxu_dot((probs - onehot).T, x) / x.shape[0]         # [C, D]
        delta = (-hyper["lr"] * grad_w).reshape(model.shape)
        return delta, {"loss": loss, "accuracy": acc}

    def evaluate(self, model, batch) -> Dict[str, torch.Tensor]:
        x, y = batch
        _, _, loss, acc = self._loss_and_accuracy(self._logits(model, x), y)
        return {"loss": loss, "accuracy": acc}


def make_synthetic(n: int, num_features: int, num_classes: int,
                   seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's generator, the same numpy draws: x standard normal,
    labels the argmax of a random linear map plus noise."""
    rng = np.random.default_rng(seed)
    true_w = rng.standard_normal((num_classes, num_features), dtype=np.float32)
    x = rng.standard_normal((n, num_features), dtype=np.float32)
    logits = x @ true_w.T
    logits += 0.1 * rng.standard_normal((n, num_classes), dtype=np.float32)
    y = np.argmax(logits, axis=1).astype(np.int32)
    return x, y
