"""Lasso regression by stochastic coordinate descent.

Counterpart of ``harmony_tpu/apps/lasso.py`` (the reference's Lasso app): per
mini-batch, pull the whole model, run the "shooting" coordinate-descent sweep
against the batch rows (the soft-thresholded exact minimisation of each
coordinate in turn, with the residual kept up to date), push the weight
deltas. The sweep is sequential by nature and the reference runs it outside
any kernel (a ``lax.scan`` over coordinates); here it is a loop over the
coordinates in the same order, in plain PyTorch, about 15 device operations a
coordinate.

On a data axis > 1 the sweep splits (``row_part``, ``row_finish``): for each
coordinate every row yields ``xj @ resid`` and ``xj @ xj`` over its rows, the
finish takes their sums, computes the new weight once and replies with its
change, and every row updates its own residual.

Data: batch = (x [B, D], y [B]).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.dolphin.trainer import RowResult, Trainer


class LassoTrainer(Trainer):
    pull_mode = "all"

    def __init__(self, num_features: int, lam: float = 0.1) -> None:
        self.num_features = num_features
        self.lam = lam

    def model_table_config(self, table_id: str = "lasso-model") -> TableConfig:
        return TableConfig(
            table_id=table_id,
            capacity=self.num_features,
            value_shape=(),
            num_blocks=min(self.num_features, 64),
            update_fn="add",
        )

    def compute(self, model: torch.Tensor, batch: Tuple[torch.Tensor, torch.Tensor],
                hyper: Dict[str, torch.Tensor]):
        x, y = batch[0].to(torch.float32), batch[1]
        n = x.shape[0]
        resid = y - x @ model
        w = model.clone()       # model is a view of the live storage
        cols = x.t().contiguous()
        for j in range(self.num_features):
            xj, wj = cols[j], w[j]
            zj = xj @ xj + 1e-12
            rho = xj @ resid + zj * wj
            wj_new = torch.sign(rho) * torch.clamp_min(rho.abs() - self.lam * n, 0.0) / zj
            resid = resid - xj * (wj_new - wj)
            w[j] = wj_new
        delta = w - model
        loss = torch.mean(resid ** 2) / 2 + self.lam * torch.sum(torch.abs(w))
        return delta, {"loss": loss, "nnz": torch.sum(torch.abs(w) > 1e-6)}

    def row_part(self, model, batch, hyper, local=None):
        x, y = batch[0].to(torch.float32), batch[1]
        resid = y - x @ model
        cols = x.t().contiguous()
        for j in range(self.num_features):
            xj = cols[j]
            reply = yield {"xr": xj @ resid, "xx": xj @ xj}
            resid = resid - xj * reply["dw"]
        yield {"sse": torch.sum(resid ** 2)}
        return RowResult()

    def row_finish(self, model, hyper, n, local=None):
        w = model.clone()
        stats = yield
        for j in range(self.num_features):
            wj = w[j]
            zj = stats["xx"] + 1e-12
            rho = stats["xr"] + zj * wj
            wj_new = torch.sign(rho) * torch.clamp_min(rho.abs() - self.lam * n, 0.0) / zj
            dw = wj_new - wj
            w[j] = wj_new
            stats = yield {"dw": dw}
        loss = stats["sse"] / n / 2 + self.lam * torch.sum(torch.abs(w))
        return w - model, {"loss": loss, "nnz": torch.sum(torch.abs(w) > 1e-6)}

    def evaluate(self, model, batch) -> Dict[str, torch.Tensor]:
        x, y = batch[0], batch[1]
        resid = y - x.to(torch.float32) @ model
        return {
            "loss": torch.mean(resid ** 2) / 2 + self.lam * torch.sum(torch.abs(model)),
            "mse": torch.mean(resid ** 2),
        }


def make_synthetic(
    n: int,
    num_features: int,
    nnz: int = 8,
    noise: float = 0.01,
    seed: int = 0,
):
    """Sparse ground-truth regression problem (the reference's draws)."""
    rng = np.random.default_rng(seed)
    w_true = np.zeros(num_features, np.float32)
    idx = rng.choice(num_features, nnz, replace=False)
    w_true[idx] = rng.normal(size=nnz).astype(np.float32)
    x = rng.normal(size=(n, num_features)).astype(np.float32)
    y = x @ w_true + noise * rng.normal(size=n).astype(np.float32)
    return x, y.astype(np.float32), w_true


def make_training_data(n: int, num_features: int, nnz: int = 8, noise: float = 0.01,
                       seed: int = 0):
    """``make_synthetic``'s (x, y), without the ground truth: the arrays a job
    trains on (the CLI preset's data function). The reference's preset names
    ``make_synthetic`` itself, whose ``w_true`` has ``num_features`` rows, not
    ``n``, so its data provider refuses the three arrays."""
    x, y, _ = make_synthetic(n, num_features, nnz=nnz, noise=noise, seed=seed)
    return x, y
