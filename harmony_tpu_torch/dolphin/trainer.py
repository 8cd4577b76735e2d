"""The Trainer SPI — the user-facing training contract.

Counterpart of ``harmony_tpu/dolphin/trainer.py`` (the reference's 4-phase
Trainer API: initGlobalSettings / pull / localCompute / push / onEpochFinished
/ evaluate / cleanup). ``compute`` is a function of tensors on the table's
device; the worker runs PULL, ``compute`` and PUSH as one step under the table
lock.

On a model table whose mesh has a data axis > 1 the worker splits each batch
over the data rows (``dolphin/worker.py::_DataParallelStep``), and a trainer
says how its step splits, in one of two ways:

  * ``batch_reduction`` ("mean" or "sum"), for a delta linear in the batch
    (MLR, Wide&Deep, AddVector): each row computes ``compute`` on its part and
    the rows' deltas and metrics combine;
  * the split contract, for every other trainer: ``row_part`` runs on each
    row's slot over the row's part and yields sufficient statistics;
    ``row_finish`` runs once, on the first row's slot, takes each round's
    statistics added over the rows in row order and turns them into the
    delta and the metrics, replying to the rows between rounds where the
    step needs several (Lasso's coordinates, GBT's levels). The rows'
    statistics add in row order, so a step gives the same bits run to run
    and the one-slot result to rounding.

A trainer with neither is refused on a data axis > 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Generator, Optional, Tuple

import torch

from harmony_tpu_torch.config.params import TrainerParams


@dataclasses.dataclass
class TrainerContext:
    """What a trainer sees of the framework: its tables and hyper-params.

    ``model_table`` is the job's parameter-server table; ``local_table`` the
    optional worker-local table (NMF's L rows, LDA's topic assignments)."""

    params: TrainerParams
    model_table: Any = None          # DenseTable or DeviceHashTable
    local_table: Any = None          # DenseTable or None
    worker_id: str = "worker-0"
    num_workers: int = 1


@dataclasses.dataclass
class RowResult:
    """What a row's part of a split step returns (``Trainer.row_part``):
    the delta of the row's own keys (a keyed pull; the rows' deltas are
    pushed together, in row order) and the worker-local rows its part writes
    (``local_keys``, ``local_rows``), which are written into every replica
    of the local table."""

    delta: Optional[torch.Tensor] = None
    local_keys: Optional[torch.Tensor] = None
    local_rows: Optional[torch.Tensor] = None


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
    # How the deltas and metrics of parts of a batch combine into the whole
    # batch's, for a model table on a mesh with a data axis > 1, when the
    # delta is linear in the batch: "mean" when compute returns batch means
    # (each part weighs by its share of the examples), "sum" when it returns
    # batch sums. None: the trainer runs on a data axis > 1 only through the
    # split contract (row_part, row_finish), or not at all.
    batch_reduction: Optional[str] = None

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

    def mask_delta(self, delta: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
        """Hook of a hash-table step, between COMP and PUSH: reconcile the
        delta with the admission mask ``ok`` (one bool per pulled key). The
        identity by default; a trainer that keeps an invariant across rows
        (sparse LDA's summary row, the sum of its word rows) drops a refused
        row's contribution everywhere."""
        return delta

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

    # -- the split contract (a data axis > 1; see the module doc) ----------

    @property
    def splits_rows(self) -> bool:
        """Whether the trainer implements the split contract."""
        return type(self).row_part is not Trainer.row_part

    def row_part(self, model: torch.Tensor, batch: Any, hyper: Dict[str, torch.Tensor],
                 local: Optional[torch.Tensor] = None
                 ) -> Generator[Dict[str, torch.Tensor], Any, Optional[RowResult]]:
        """A generator run on each data row's slot over the row's part of the
        batch (``model`` and ``local``: the row's replicas; ``hyper`` on its
        slot). Each ``yield`` hands the finish a dict of statistics and
        receives the finish's reply to that round on the row's slot (None
        once the finish has returned); the part then returns a
        :class:`RowResult` (or None)."""
        raise NotImplementedError

    def row_finish(self, model: torch.Tensor, hyper: Dict[str, torch.Tensor], n: int,
                   local: Optional[torch.Tensor] = None) -> Generator[Any, Dict, Tuple]:
        """A generator run once, on the first row's slot, for a batch of
        ``n`` examples: each ``stats = yield reply`` receives a round's
        statistics added over the rows (the first ``yield`` replies
        nothing). It returns ``(delta, metrics)``, or ``(delta, metrics,
        (local_keys, local_rows))`` to write local rows into every replica;
        the delta is None for a keyed pull (the rows return theirs)."""
        raise NotImplementedError

    def local_keys(self, batch: Any) -> Optional[torch.Tensor]:
        """The worker-local rows a batch's step writes (NMF's rows, LDA's
        documents), or None: on a data axis > 1 a batch that writes one of
        them twice is refused."""
        return None

    def local_table_config(self):
        """Schema of the worker-local table (``uses_local_table`` only)."""
        raise NotImplementedError

    def evaluate(self, model: torch.Tensor, batch: Any) -> Dict[str, torch.Tensor]:
        """Model evaluation on held-out data."""
        raise NotImplementedError
