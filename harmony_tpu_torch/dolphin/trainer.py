"""The Trainer SPI — the user-facing training contract.

Counterpart of ``harmony_tpu/dolphin/trainer.py`` (the reference's 4-phase
Trainer API: initGlobalSettings / pull / localCompute / push / onEpochFinished
/ evaluate / cleanup). ``compute`` is a function of tensors on the table's
device; the worker runs PULL, ``compute`` and PUSH as one step under the table
lock.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from harmony_tpu_torch.config.params import TrainerParams


@dataclasses.dataclass
class TrainerContext:
    """What a trainer sees of the framework: its tables and hyper-params.

    ``model_table`` is the job's parameter-server table; ``local_table`` the
    optional worker-local table (NMF's L rows, LDA's topic assignments)."""

    params: TrainerParams
    model_table: Any = None          # DenseTable
    local_table: Any = None          # DenseTable or None
    worker_id: str = "worker-0"
    num_workers: int = 1


class Trainer:
    """Base class; apps override the compute parts.

    ``pull_mode`` selects the PULL realization:
      * "all"  — the whole model is pulled each batch; ``compute`` receives
        ``model`` of shape [capacity, *value_shape].
      * "keys" — ``pull_keys(batch)`` names the rows needed (sparse apps);
        ``compute`` receives the gathered rows.
    """

    pull_mode: str = "all"
    # True: the job also carries a worker-local table; the step then pulls
    # both tables whole and calls ``compute_with_local`` instead of
    # ``compute``.
    uses_local_table: bool = False
    # Name of the trainer's objective in its metrics when it is NOT "loss"
    # (LDA's "log_likelihood"): per-batch and per-epoch progress fall back to
    # it. None: only "loss" counts.
    objective_metric: Optional[str] = None
    # Opt-in: True when ``on_epoch_finished`` depends only on ``epoch_idx`` and
    # the trainer's own attributes (decay schedules, PRNG epoch counters),
    # never on trained values, so the worker may run it between the epochs
    # of a multi-epoch window, before their device results drain (see
    # :meth:`_epoch_hook_windowable`).
    epoch_hook_windowable: bool = False

    # -- lifecycle (host side) ------------------------------------------

    def init_global_settings(self, ctx: TrainerContext) -> None:
        """One-time setup before the first epoch (may push initial model
        values into the table)."""

    def on_training_start(self, ctx: TrainerContext, starting_epoch: int) -> None:
        """Called by the worker just before the epoch loop."""

    def on_epoch_finished(self, ctx: TrainerContext, epoch_idx: int) -> None:
        """Per-epoch hook (host side)."""

    def cleanup(self, ctx: TrainerContext) -> None:
        """Final hook after the last epoch."""

    @classmethod
    def _epoch_hook_windowable(cls, trainer: "Trainer") -> bool:
        """Whether ``trainer``'s ``on_epoch_finished`` may run between the
        epochs of a multi-epoch window, before their results drain.

        True for the base no-op. For an overrider, the ``epoch_hook_windowable``
        opt-in must be declared AT OR BELOW the class that defines the
        effective hook: a flag inherited from above describes an ancestor's
        hook, and a subclass that replaces the hook must opt in again for its
        own. An instance attribute wins."""
        if "epoch_hook_windowable" in trainer.__dict__:
            return bool(trainer.__dict__["epoch_hook_windowable"])
        mro = type(trainer).__mro__
        hook_owner = next(c for c in mro if "on_epoch_finished" in vars(c))
        if hook_owner is Trainer:
            return True  # the un-overridden no-op reads nothing
        flag_owner = next(
            (c for c in mro if "epoch_hook_windowable" in vars(c)), None)
        if flag_owner is None or not vars(flag_owner)["epoch_hook_windowable"]:
            return False
        return mro.index(flag_owner) <= mro.index(hook_owner)

    # -- compute parts (device side) -------------------------------------

    def hyperparams(self) -> Dict[str, float]:
        """Host-side hyper-parameters handed to ``compute`` each step (as
        scalar tensors on the table's device), so a per-epoch change made in
        ``on_epoch_finished`` reaches the next step."""
        return {}

    def pull_keys(self, batch: Any) -> torch.Tensor:
        """Keys to pull for this batch (pull_mode == "keys" only)."""
        raise NotImplementedError

    def compute(
        self, model: torch.Tensor, batch: Any, hyper: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The mini-batch computation. Returns ``(delta, metrics)`` where
        ``delta`` matches ``model``'s shape and is folded into the table by
        the push."""
        raise NotImplementedError

    def compute_with_local(
        self, model: torch.Tensor, local: torch.Tensor, batch: Any,
        hyper: Dict[str, torch.Tensor],
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """The step of a ``uses_local_table`` trainer: returns ``(model_delta,
        new_local, metrics)``. The model delta folds through the model table's
        update fn; ``new_local`` replaces the whole local table (worker-private
        state needs no update-fn semantics). ``model`` and ``local`` are views
        of the live storage: compute returns new tensors and never writes
        into them."""
        raise NotImplementedError

    def local_table_config(self):
        """Schema of the worker-local table (``uses_local_table`` only)."""
        raise NotImplementedError

    def evaluate(self, model: torch.Tensor, batch: Any) -> Dict[str, torch.Tensor]:
        """Model evaluation on held-out data."""
        raise NotImplementedError
