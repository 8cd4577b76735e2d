"""Model checkpoint chains and their offline evaluation.

Counterpart of ``harmony_tpu/dolphin/evaluator.py`` (the reference's
ModelChkpManager, dolphin/core/master/ModelChkpManager.java:40-80, and
ModelEvaluator, dolphin/core/worker/ModelEvaluator.java):
:class:`ModelChkpManager` chains snapshots of a job's model table from its
epoch hook; :class:`ModelEvaluator` restores each chained checkpoint into a
temporary table and runs the trainer's evaluation on it.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from harmony_tpu_torch.checkpoint.manager import (
    CheckpointManager,
    CheckpointStillWriting,
    PendingCheckpoint,
)
from harmony_tpu_torch.dolphin.trainer import Trainer
from harmony_tpu_torch.parallel.mesh import mesh_spans_processes
from harmony_tpu_torch.runtime.master import ETMaster, TableHandle


class ModelChkpManager:
    """Chains per-epoch snapshots of the model table during training.

    Snapshots are ASYNC: the epoch hook runs on the worker's thread, so it
    takes only the device-side copy (under the table lock, on the worker's
    stream); the device-to-host copies and file I/O drain on a background
    thread, and ``drain()`` (before evaluation, at job end) joins the
    writers. ``stats`` records each snapshot's cost (see
    ``PendingCheckpoint``).

    On a table over several processes the snapshot is the synchronous
    collective ``checkpoint()`` instead: the hook runs in every process's
    chief at the same point of its schedule (inside the chief's turnstile
    turn, whatever the worker count), where background fences would race
    the pod's lockstep dispatch order. Its whole cost lands on the step."""

    # Cap on concurrent background writers: each in-flight checkpoint pins a
    # device-side copy of the table.
    MAX_PENDING = 2

    def __init__(self, chkp_manager: CheckpointManager, handle: TableHandle,
                 period: int = 1, commit: bool = True) -> None:
        self._mgr = chkp_manager
        self._handle = handle
        self._period = max(1, period)
        self._commit = commit
        self.chkp_ids: List[str] = []
        self._pending: List[PendingCheckpoint] = []
        self._written: List[PendingCheckpoint] = []
        self._pod_stats: List[Dict[str, float]] = []

    def on_epoch(self, epoch_idx: int) -> Optional[str]:
        """Epoch hook: snapshot every ``period`` epochs, tagged
        ``{"epoch": epoch_idx}`` (the resume path's restart key)."""
        if (epoch_idx + 1) % self._period:
            return None
        meta = {"epoch": float(epoch_idx)}
        if mesh_spans_processes(self._handle.table.mesh):
            t0 = time.perf_counter()
            cid = self._mgr.checkpoint(self._handle, commit=self._commit, app_meta=meta)
            staged = self._mgr.last_staged
            self._pod_stats.append({
                "chkp_id": cid, "snapshot_seconds": time.perf_counter() - t0,
                "write_seconds": staged["seconds"], "bytes": staged["bytes"],
                "blocks": staged["blocks"], "block_ids": list(staged["block_ids"])})
            self.chkp_ids.append(cid)
            return cid
        while len(self._pending) >= self.MAX_PENDING:
            oldest = self._pending.pop(0)  # backpressure: join the oldest
            try:
                oldest.wait()
            except BaseException:
                # a failed writer's id must not stay replayable
                if oldest.chkp_id in self.chkp_ids:
                    self.chkp_ids.remove(oldest.chkp_id)
                raise
            self._written.append(oldest)
        p = self._mgr.checkpoint_async(self._handle, commit=self._commit, app_meta=meta)
        self._pending.append(p)
        self.chkp_ids.append(p.chkp_id)
        return p.chkp_id

    def drain(self, timeout: float = 300.0) -> List[str]:
        """Join ALL background writers; failed ids leave the chain so the
        survivors stay replayable, then the first failure is raised. A
        TIMED-OUT writer stays in the chain and pending (its checkpoint may
        still complete): drain() again joins it."""
        errors: List[BaseException] = []
        still_pending: List[PendingCheckpoint] = []
        for p in self._pending:
            try:
                p.wait(timeout=timeout)
                self._written.append(p)
            except CheckpointStillWriting as e:
                still_pending.append(p)
                errors.append(e)
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)
                if p.chkp_id in self.chkp_ids:
                    self.chkp_ids.remove(p.chkp_id)
        self._pending = still_pending
        if errors:
            # a writer's failure outranks a timeout (the timed-out one stays
            # pending for a retry; the failure would be lost)
            for e in errors:
                if not isinstance(e, CheckpointStillWriting):
                    raise e
            raise errors[0]
        return list(self.chkp_ids)

    @property
    def stats(self) -> List[Dict[str, float]]:
        """Per written snapshot: ``snapshot_seconds`` (on the worker's
        thread), ``write_seconds`` (the background write) and ``bytes``. A pod
        snapshot's are this process's: the whole collective on the worker's
        thread, its staging, and the bytes, count and ids of the blocks it
        staged (``CheckpointManager.last_staged``)."""
        return self._pod_stats + [
            {"chkp_id": p.chkp_id, "snapshot_seconds": p.snapshot_seconds,
             "write_seconds": p.write_seconds, "bytes": p.bytes_written}
            for p in self._written]


def resolve_eval_inputs(config):
    """(trainer, batch) for a job's offline evaluation, resolved from its
    JobConfig: ``user["test_data_fn"]`` with ``test_data_args``, or else the
    training ``data_fn`` with ``test_data_args`` falling back to
    ``data_args``. A function and its arguments fall back TOGETHER: a custom
    test_data_fn is never called with the training data's kwargs."""
    from harmony_tpu_torch.config.base import resolve_symbol

    user = config.user
    if "test_data_fn" in user:
        fn = resolve_symbol(user["test_data_fn"])
        args = user.get("test_data_args", {})
    else:
        fn = resolve_symbol(user["data_fn"])
        args = user.get("test_data_args", user.get("data_args", {}))
    out = fn(**args)
    batch = tuple(np.asarray(a) for a in (out if isinstance(out, (tuple, list)) else (out,)))
    trainer = resolve_symbol(config.trainer)(**config.params.app_params)
    return trainer, batch


class ModelEvaluator:
    """Replays checkpoints through a trainer's evaluation on test data: each
    checkpoint restores into a temporary table ``__eval__:<id>`` on the given
    executors, is evaluated there (the batch on the table's device) and is
    dropped."""

    def __init__(self, master: ETMaster, chkp_manager: CheckpointManager) -> None:
        self._master = master
        self._mgr = chkp_manager

    def evaluate_checkpoints(self, chkp_ids: List[str], trainer: Trainer,
                             test_batch: Tuple[np.ndarray, ...],
                             executor_ids: List[str]) -> List[Dict[str, float]]:
        out: List[Dict[str, float]] = []
        for cid in chkp_ids:
            handle = self._mgr.restore(self._master, cid, executor_ids,
                                       table_id=f"__eval__:{cid}")
            try:
                table = handle.table
                with torch.no_grad():
                    if table.spec.config.sparse:
                        # no full-model array exists over an unbounded key
                        # domain: the trainer evaluates through a keyed lookup
                        sparse_eval = getattr(trainer, "evaluate_sparse", None)
                        if sparse_eval is None:
                            raise NotImplementedError(
                                f"{type(trainer).__name__} has no "
                                "evaluate_sparse(table, batch); required to "
                                "evaluate a sparse (hash-backed) checkpoint")
                        metrics = sparse_eval(table, tuple(map(np.asarray, test_batch)))
                    else:
                        batch = tuple(torch.as_tensor(np.asarray(a), device=table.device)
                                      for a in test_batch)
                        metrics = trainer.evaluate(table.pull_array(), batch)
                out.append({k: float(v) for k, v in metrics.items()})
            finally:
                handle.drop()
        return out
