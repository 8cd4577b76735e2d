"""Non-negative matrix factorization by projected SGD — X ~= L @ R.T.

Counterpart of ``harmony_tpu/apps/nmf.py``. R (column -> rank vector) lives in
the model table, whose ``add_nonneg`` update fn clamps at zero after each
fold; L (row -> rank vector) lives in the worker-local table (``assign``). A
step pulls both whole, computes the gradients with :func:`mxu_dot` (bf16
operands, f32 sums), writes the batch's projected L rows into a new local
table and pushes R's projected delta. The global init adds a seeded uniform R
through ``multi_update`` (on the card, 4,096 keys take the ``mxu`` push
route: one K3 fold) and writes L whole.

Data: (row_idx [B], x_row [B, num_cols]).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.dolphin.trainer import Trainer, TrainerContext
from harmony_tpu_torch.ops.mxu import mxu_dot


class NMFTrainer(Trainer):
    pull_mode = "all"
    uses_local_table = True

    def __init__(
        self,
        num_rows: int,
        num_cols: int,
        rank: int,
        step_size: float = 0.01,
        init_scale: float = 0.1,
        seed: int = 0,
    ) -> None:
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.rank = rank
        self.step_size = step_size
        self.init_scale = init_scale
        self.seed = seed
        self._lr = step_size

    def model_table_config(self, table_id: str = "nmf-model") -> TableConfig:
        """R: column -> rank vector."""
        return TableConfig(
            table_id=table_id,
            capacity=self.num_cols,
            value_shape=(self.rank,),
            num_blocks=min(self.num_cols, 64),
            update_fn="add_nonneg",
        )

    def local_table_config(self, table_id: str = "nmf-local") -> TableConfig:
        """L: row -> rank vector (the worker-local table)."""
        return TableConfig(
            table_id=table_id,
            capacity=self.num_rows,
            value_shape=(self.rank,),
            num_blocks=min(self.num_rows, 64),
            update_fn="assign",
        )

    def init_global_settings(self, ctx: TrainerContext) -> None:
        """Seeded uniform [0, init_scale) factors, the reference's numpy draws."""
        rng = np.random.default_rng(self.seed)
        if ctx.model_table is not None:
            r0 = rng.uniform(0, self.init_scale, (self.num_cols, self.rank)).astype(np.float32)
            ctx.model_table.multi_update(np.arange(self.num_cols), r0)
        if ctx.local_table is not None:
            l0 = rng.uniform(0, self.init_scale, (self.num_rows, self.rank)).astype(np.float32)
            ctx.local_table.write_all(l0)

    def hyperparams(self) -> Dict[str, float]:
        return {"lr": self._lr}

    def compute_with_local(self, model, local, batch, hyper):
        row_idx, x = batch                          # [B], [B, num_cols]
        lr = hyper["lr"]
        rows = row_idx.long()
        l_rows = local[rows]                        # [B, rank]
        pred = mxu_dot(l_rows, model.T)             # [B, num_cols]
        err = pred - x.float()
        loss = torch.mean(torch.sum(err * err, dim=-1))
        b = x.shape[0]
        grad_l = 2.0 * mxu_dot(err, model)          # [B, rank]
        grad_r = 2.0 * mxu_dot(err.T, l_rows) / b   # [num_cols, rank], batch mean
        new_l_rows = torch.clamp_min(l_rows - lr * grad_l, 0.0)
        new_local = local.index_put((rows,), new_l_rows)
        # project the pushed delta so that R stays >= 0 after the fold
        delta_r = torch.clamp_min(model - lr * grad_r, 0.0) - model
        return delta_r, new_local, {"loss": loss}

    def evaluate(self, model, batch) -> Dict[str, torch.Tensor]:
        raise NotImplementedError("NMF evaluation uses training loss")


def make_synthetic(num_rows: int, num_cols: int, rank: int,
                   seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """A true low-rank non-negative matrix as (row_idx, X rows), the
    reference's numpy draws."""
    rng = np.random.default_rng(seed)
    l_true = rng.uniform(0, 1, (num_rows, rank)).astype(np.float32)
    r_true = rng.uniform(0, 1, (num_cols, rank)).astype(np.float32)
    x = l_true @ r_true.T
    return np.arange(num_rows, dtype=np.int32), x
