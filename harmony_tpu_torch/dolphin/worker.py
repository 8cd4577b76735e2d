"""WorkerTasklet — the training hot loop.

Counterpart of ``harmony_tpu/dolphin/worker.py``: per epoch, per mini-batch
one step

    PULL  (the batch's rows, or the whole model)
    COMP  (the trainer's compute: loss, gradient, delta)
    PUSH  (fold the delta into the table)

run through ``DenseTable.apply_step``, so the step and its commit happen under
the table lock while the push updates the storage in place. Per-batch losses
stay on the device until the epoch ends; one host read per epoch drains them.

Ported here: the keys-mode step (the reference's fused keyed step), the
all-mode step, the all-mode step of a trainer with a worker-local table
(``compute_with_local``, both tables pulled whole, run through
``DenseTable.apply_step_with``), the epoch loop with per-epoch ``losses`` (the
primary metric: "loss", else the trainer's ``objective_metric``) in the
result, and ``evaluate``. Not ported yet: the unfused and async step modes, the fused
multi-epoch windows, the prefetch pipeline, the device batch cache, the comm
probe, dispatch turnstiles and TaskUnit scheduling.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.trainer import Trainer, TrainerContext


class WorkerTasklet:
    """Drives the training loop for one job on its table's device."""

    def __init__(
        self,
        job_id: str,
        ctx: TrainerContext,
        trainer: Trainer,
        data: TrainingDataProvider,
        global_init: bool = True,
    ) -> None:
        self.job_id = job_id
        self.ctx = ctx
        self.trainer = trainer
        self.data = data
        self.device = ctx.model_table.device
        # exactly one worker of a job runs the trainer's global init: it writes
        # the shared table
        self.global_init = global_init

    # -- step construction ----------------------------------------------

    def _step_core(self, push_route: str) -> Callable:
        """The PULL/COMP/PUSH body, ``step(arr, batch, hyper) -> (arr, metrics)``
        for ``DenseTable.apply_step``. The push updates ``arr`` in place.

        The reference pins an ``optimization_barrier`` between the phases so
        that XLA cannot fuse across them (``_phase_boundary``); eager PyTorch
        runs each phase as its own operations, so there is nothing to pin."""
        spec = self.ctx.model_table.spec
        trainer = self.trainer
        if trainer.uses_local_table:
            if trainer.pull_mode != "all":
                raise NotImplementedError(
                    "a worker-local table beside a keyed pull (sparse LDA) is not "
                    "ported yet")
            local_spec = self.ctx.local_table.spec

            def _step(arr, local, batch, hyper):
                model, lmodel = spec.pull_all(arr), local_spec.pull_all(local)  # PULL
                delta, new_local, metrics = trainer.compute_with_local(
                    model, lmodel, batch, hyper)                               # COMP
                return (spec.push_all(arr, delta),                             # PUSH
                        local_spec.write_all(local, new_local)), metrics

        elif trainer.pull_mode == "all":

            def _step(arr, batch, hyper):
                model = spec.pull_all(arr)                              # PULL
                delta, metrics = trainer.compute(model, batch, hyper)   # COMP
                return spec.push_all(arr, delta), metrics               # PUSH

        else:

            def _step(arr, batch, hyper):
                keys = trainer.pull_keys(batch)
                model = spec.pull(arr, keys)                            # PULL
                delta, metrics = trainer.compute(model, batch, hyper)   # COMP
                return spec.push(arr, keys, delta, via=push_route), metrics  # PUSH

        return _step

    def _to_device(self, batch: Tuple[np.ndarray, ...]) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.as_tensor(np.ascontiguousarray(a), device=self.device)
                     for a in batch)

    def _hyper(self) -> Dict[str, torch.Tensor]:
        return {k: torch.tensor(v, dtype=torch.float32, device=self.device)
                for k, v in self.trainer.hyperparams().items()}

    def _primary_key(self, metrics: Dict[str, torch.Tensor]) -> Optional[str]:
        """The one metric that is this job's progress scalar: "loss", else the
        trainer's ``objective_metric`` (LDA's "log_likelihood"), else none."""
        if "loss" in metrics:
            return "loss"
        om = self.trainer.objective_metric
        return om if om and om in metrics else None

    def _drain(self, metrics: List[Dict[str, torch.Tensor]]) -> List[float]:
        """The epoch's per-batch primary metrics as host floats (0.0 for a
        trainer that reports none): one device read, which also waits for the
        epoch's device work to finish."""
        key = self._primary_key(metrics[0]) if metrics else None
        if key is None:
            return [0.0] * len(metrics)
        return torch.stack([m[key].detach().float() for m in metrics]).cpu().tolist()

    # -- the loop ---------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        ctx, params, table = self.ctx, self.ctx.params, self.ctx.model_table
        # Float32 products in full float32, as the reference computes them on
        # the CPU (and at HIGHEST precision on the TPU): TF32 keeps ~10
        # mantissa bits. This is PyTorch's default; it is set, not assumed.
        torch.backends.cuda.matmul.allow_tf32 = False
        if self.global_init:
            self.trainer.init_global_settings(ctx)
        self.trainer.on_training_start(ctx, 0)
        step = self._step_core(table.push_via)
        apply = (functools.partial(table.apply_step_with, ctx.local_table)
                 if self.trainer.uses_local_table else table.apply_step)
        epoch_losses: List[float] = []
        batch_losses: List[float] = []
        epoch_seconds: List[float] = []
        started = time.perf_counter()
        for epoch in range(params.num_epochs):
            t0 = time.perf_counter()
            hyper = self._hyper()
            with torch.no_grad():  # compute takes its own gradient
                metrics = [apply(step, self._to_device(b), hyper)
                           for b in self.data.epoch_batches()]
            losses = self._drain(metrics)
            epoch_seconds.append(time.perf_counter() - t0)
            batch_losses.extend(losses)
            epoch_losses.append(losses[-1] if losses else 0.0)
            self.trainer.on_epoch_finished(ctx, epoch)
        finished = time.perf_counter()
        self.trainer.cleanup(ctx)
        return {
            "job_id": self.job_id,
            "epochs_run": len(epoch_losses),
            "losses": epoch_losses,
            "batch_losses": batch_losses,
            "epoch_seconds": epoch_seconds,
            # perf_counter at the first step's start and the last epoch's end
            "train_span": [started, finished],
        }

    # -- evaluation --------------------------------------------------------

    def evaluate(self, batch: Tuple[np.ndarray, ...]) -> Dict[str, float]:
        model = self.ctx.model_table.pull_array()
        with torch.no_grad():
            metrics = self.trainer.evaluate(model, self._to_device(batch))
        return {k: float(v) for k, v in metrics.items()}
