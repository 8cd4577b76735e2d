"""Stateful training optimizers over table storage.

Counterpart of ``harmony_tpu/dolphin/optim.py``. Optimizer state lives in the
same table as the parameters, as extra row sections

    rows = [ params | m (slot 1) | v (slot 2) | counter row ]

so it is stored, and later checkpointed and moved, with them. The update is
plain tensor arithmetic over flat vectors; trainers split their pulled rows
into sections, call :func:`apply`, and push back per-section deltas (the
additive fold: delta = new - old).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

SLOTS = {"sgd": 0, "momentum": 1, "adagrad": 1, "rmsprop": 1, "adam": 2}


def num_slots(name: str) -> int:
    try:
        return SLOTS[name]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(SLOTS)}") from None


def apply(
    name: str,
    params: torch.Tensor,      # [n] flat
    grads: torch.Tensor,       # [n] flat
    m: torch.Tensor,           # [n] slot-1 state (ignored for sgd)
    v: torch.Tensor,           # [n] slot-2 state (adam only)
    t: torch.Tensor,           # scalar step count AFTER this update (>= 1)
    hyper: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (new_params, new_m, new_v). ``hyper``: lr (required),
    beta1/beta2/eps (adam, defaulted), mu (momentum), rho (rmsprop). Slot 1 is
    the velocity (momentum), the sum of squared grads (adagrad) or their EMA
    (rmsprop)."""
    lr = hyper["lr"]
    if name == "sgd":
        return params - lr * grads, m, v
    if name == "momentum":
        mu = hyper.get("mu", 0.9)
        new_m = mu * m + grads
        return params - lr * new_m, new_m, v
    if name == "adagrad":
        eps = hyper.get("eps", 1e-8)
        new_m = m + grads * grads
        return params - lr * grads / (torch.sqrt(new_m) + eps), new_m, v
    if name == "rmsprop":
        rho = hyper.get("rho", 0.9)
        eps = hyper.get("eps", 1e-8)
        new_m = rho * m + (1 - rho) * grads * grads
        return params - lr * grads / (torch.sqrt(new_m) + eps), new_m, v
    if name == "adam":
        b1 = hyper.get("beta1", 0.9)
        b2 = hyper.get("beta2", 0.999)
        eps = hyper.get("eps", 1e-8)
        new_m = b1 * m + (1 - b1) * grads
        new_v = b2 * v + (1 - b2) * grads * grads
        mhat = new_m / (1 - b1 ** t)
        vhat = new_v / (1 - b2 ** t)
        return params - lr * mhat / (torch.sqrt(vhat) + eps), new_m, new_v
    raise ValueError(f"unknown optimizer {name!r}")
