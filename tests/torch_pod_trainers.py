"""Trainers and an optimizer for the port's pod tests, importable by the
pod's processes (``tests.torch_pod_trainers:...``, as the reference's pod
tests import ``tests.helpers``).

``SlowStart*`` are the apps' trainers with a host sleep of ``start_lag_sec``
before the first epoch, in every process: a plan sent in that time meets the
job at its observed epoch 0, so the smallest legal plan epoch is
``EPOCH_WINDOW`` + 1. ``SlowEpochsMLR`` sleeps ``epoch_lag_sec`` after each
epoch (its epochs run one a window). ``leader_only_test_data`` is test data
that only process 0 can read. Sleeps are host delays only: the values
are the apps' own."""
from __future__ import annotations

import time

from harmony_tpu_torch.apps.mlr import MLRTrainer
from harmony_tpu_torch.apps.widedeep import FMTrainer, WideDeepTrainer
from harmony_tpu_torch.optimizer.api import DolphinPlan, TransferStep


def _slow_start(base):
    class SlowStart(base):
        def __init__(self, start_lag_sec: float = 0.0, **kw) -> None:
            super().__init__(**kw)
            self._start_lag_sec = start_lag_sec

        def on_training_start(self, ctx, starting_epoch: int) -> None:
            time.sleep(self._start_lag_sec)
            super().on_training_start(ctx, starting_epoch)

    SlowStart.__name__ = SlowStart.__qualname__ = f"SlowStart{base.__name__}"
    return SlowStart


SlowStartMLRTrainer = _slow_start(MLRTrainer)
SlowStartWideDeepTrainer = _slow_start(WideDeepTrainer)
SlowStartFMTrainer = _slow_start(FMTrainer)


class SlowEpochsMLR(MLRTrainer):
    def __init__(self, epoch_lag_sec: float = 0.0, **kw) -> None:
        super().__init__(**kw)
        self._epoch_lag_sec = epoch_lag_sec

    def on_epoch_finished(self, ctx, epoch_idx: int) -> None:
        time.sleep(self._epoch_lag_sec)
        super().on_epoch_finished(ctx, epoch_idx)


def leader_only_test_data(**data_args):
    """MLR's synthetic data in the pod's process 0; any other process fails
    to read it (a follower that fails before its READY ack)."""
    from harmony_tpu_torch.apps.mlr import make_synthetic
    from harmony_tpu_torch.parallel import multihost

    if multihost.process_index() != 0:
        raise RuntimeError(f"test data unreadable on process {multihost.process_index()}")
    return make_synthetic(**data_args)


class MoveOncePodOptimizer:
    """One move-only plan as soon as worker metrics exist: half the blocks of
    the last executor onto executor-0 (the reference's
    ``tests/helpers.py::MoveOncePodOptimizer`` drains executor-4 of its 2 x 4
    pod; half keeps every process an owner on a pod of one slot a process)."""

    def __init__(self) -> None:
        self.fired = False

    def optimize(self, params, num_available_evaluators):
        if self.fired or not params.worker_metrics:
            return DolphinPlan()
        src = max(params.block_counts, key=lambda e: int(e.rsplit("-", 1)[1]))
        n = params.block_counts.get(src, 0) // 2
        if not n:
            return DolphinPlan()
        self.fired = True
        return DolphinPlan(transfer_steps=[TransferStep(params.table_id, src, "executor-0", n)])


class DeleteOnePodOptimizer:
    """A plan that deletes an executor: a pod declines it."""

    def optimize(self, params, num_available_evaluators):
        if not params.worker_metrics:
            return DolphinPlan()
        return DolphinPlan(evaluators_to_delete=[max(params.block_counts)])


class FenceAtMLR(MLRTrainer):
    """MLR that schedules an elastic fence plan for ``fence_epoch`` in every
    process when epoch ``fence_epoch - 1`` finishes: the plan a pod's leader
    would send, delivered to a job no elastic loop owns."""

    def __init__(self, fence_epoch: int = 3, **kw) -> None:
        super().__init__(**kw)
        self._fence_epoch = fence_epoch

    def on_epoch_finished(self, ctx, epoch_idx: int) -> None:
        if epoch_idx + 1 == self._fence_epoch:
            from harmony_tpu_torch.jobserver import podplan

            podplan.schedule(ctx.worker_id.rsplit("/", 1)[0],
                             {"epoch": self._fence_epoch, "elastic_fence": "shrink"})
        super().on_epoch_finished(ctx, epoch_idx)
