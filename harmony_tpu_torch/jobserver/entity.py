"""DolphinJobEntity — a training job between the JobServer and the worker.

Counterpart of ``harmony_tpu/jobserver/entity.py``'s ``DolphinJobEntity``: the
trainer and its data come from the serializable ``JobConfig`` (dotted-path
symbols), the job's model table is created on the master's device under a
job-namespaced id, and the run drives one ``WorkerTasklet``. Not ported yet:
shared tables, checkpoint chains and resume, elastic recovery, multi-worker
jobs (SSP barriers, turnstiles, TaskUnits), the optimizer loop and the pod
branch.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from harmony_tpu_torch.config.base import resolve_symbol
from harmony_tpu_torch.config.params import JobConfig
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.trainer import Trainer, TrainerContext
from harmony_tpu_torch.dolphin.worker import WorkerTasklet
from harmony_tpu_torch.runtime.master import ETMaster
from harmony_tpu_torch.table.table import DenseTable


class DolphinJobEntity:
    def __init__(self, config: JobConfig) -> None:
        if config.app_type != "dolphin":
            raise ValueError(f"job {config.job_id}: app_type {config.app_type!r} "
                             "is not ported; only 'dolphin' jobs run")
        if config.num_workers > 1:
            raise NotImplementedError(
                f"job {config.job_id}: multi-worker jobs are not ported yet")
        self.config = config
        self._master: Optional[ETMaster] = None
        self._table: Optional[DenseTable] = None
        self._data_arrays: List[np.ndarray] = []

    def _make_trainer(self) -> Trainer:
        if not self.config.trainer:
            raise ValueError(f"job {self.config.job_id}: no trainer configured")
        return resolve_symbol(self.config.trainer)(**self.config.params.app_params)

    def _make_data(self) -> List[np.ndarray]:
        user = self.config.user
        if "data_fn" not in user:
            raise ValueError(f"job {self.config.job_id}: user.data_fn missing")
        out = resolve_symbol(user["data_fn"])(**user.get("data_args", {}))
        return [np.asarray(a)
                for a in (out if isinstance(out, (tuple, list)) else (out,))]

    def setup(self, master: ETMaster) -> None:
        """Create the job's PRIVATE model table (namespaced by job id so two
        jobs of one app never collide on the trainer's default table id) and
        materialize its data."""
        self._master = master
        table_cfg = self._make_trainer().model_table_config()
        self._table = master.create_table(
            table_cfg.replace(table_id=f"{self.config.job_id}:{table_cfg.table_id}"))
        self._data_arrays = self._make_data()

    def run(self) -> Dict[str, Any]:
        cfg = self.config
        params = cfg.params
        wid = f"{cfg.job_id}/w0"
        data = TrainingDataProvider(self._data_arrays, params.num_mini_batches)
        ctx = TrainerContext(params=params, model_table=self._table,
                             worker_id=wid, num_workers=1)
        worker = WorkerTasklet(cfg.job_id, ctx, self._make_trainer(), data)
        return {"job_id": cfg.job_id, "workers": {wid: worker.run()}}

    def cleanup(self) -> None:
        if self._master is not None and self._table is not None:
            self._master.drop_table(self._table.spec.table_id)
        self._table = None
