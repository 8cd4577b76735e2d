"""Job entities — a job between the JobServer and its runtime.

Counterpart of ``harmony_tpu/jobserver/entity.py``. :func:`build_entity` is
the reference's app-type switch: ``"dolphin"`` jobs get a
:class:`DolphinJobEntity`, ``"pregel"`` jobs a :class:`PregelJobEntity`, and
any other type raises.

``DolphinJobEntity``: the trainer and its data come from the serializable
``JobConfig`` (dotted-path symbols); the job's model table (a
``DeviceHashTable`` when its config is ``sparse``), and its worker-local table
when the trainer has one, are created on its executors' device under
job-namespaced ids, so two jobs of one app never collide; the run drives one
``WorkerTasklet``; cleanup drops both tables. The dataset is cached under its
data source (``_data_source_key``): a second job with the same ``data_fn`` and
``data_args`` reads the cached host arrays, and its worker the device-resident
batches, as in the reference.

``PregelJobEntity``: ``config.trainer`` names the Computation class,
``user.graph_fn``/``user.graph_args`` build the Graph, ``user.max_supersteps``
bounds the run; a Computation whose ``__init__`` takes ``graph`` gets it. Its
``PregelMaster`` holds the vertex and message tables on the executors' device;
cleanup closes it, which drops them.

Not ported yet: shared tables, checkpoint chains and resume, elastic
recovery, multi-worker jobs (SSP barriers, turnstiles, TaskUnit admission),
the optimizer loop and the pod branch.
"""
from __future__ import annotations

import inspect
import time
from typing import Any, Dict, List, Optional

import numpy as np

from harmony_tpu_torch.config.base import resolve_symbol
from harmony_tpu_torch.config.params import JobConfig
from harmony_tpu_torch.data import devcache
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.trainer import Trainer, TrainerContext
from harmony_tpu_torch.dolphin.worker import WorkerTasklet
from harmony_tpu_torch.pregel.master import PregelMaster
from harmony_tpu_torch.runtime.master import ETMaster, Table
from harmony_tpu_torch.table.table import DenseTable


class DolphinJobEntity:
    def __init__(self, config: JobConfig) -> None:
        if config.num_workers > 1:
            raise NotImplementedError(
                f"job {config.job_id}: multi-worker jobs are not ported yet")
        self.config = config
        self._master: Optional[ETMaster] = None
        self._table: Optional[Table] = None
        self._local: Optional[DenseTable] = None
        self._data_arrays: List[np.ndarray] = []
        self._setup_start = 0.0

    def _make_trainer(self) -> Trainer:
        if not self.config.trainer:
            raise ValueError(f"job {self.config.job_id}: no trainer configured")
        return resolve_symbol(self.config.trainer)(**self.config.params.app_params)

    def _data_source_key(self) -> "tuple | None":
        """Identity of this job's data source: the generator's dotted path and
        its canonicalized args. Jobs that share it share the host arrays and
        the device-resident batches (data/devcache.py). None when an arg is
        unhashable."""
        user = self.config.user

        def tag(v):
            # type-tagged recursively: True == 1 == 1.0 must not collide, as
            # a data_fn may behave differently by type
            if isinstance(v, (list, tuple)):
                return (type(v).__name__, tuple(tag(x) for x in v))
            return (type(v).__name__, v)

        try:
            args = tuple(sorted(
                (k, tag(v)) for k, v in user.get("data_args", {}).items()))
            hash(args)
        except TypeError:
            return None
        return (user.get("data_fn"), args)

    def _make_data(self) -> List[np.ndarray]:
        """The job's dataset. Jobs with the SAME (data_fn, data_args) see the
        same dataset by definition: the host arrays are cached under the
        source key (``devcache.host_data``), so a second submission does not
        call ``data_fn`` again. A source that must differ per job varies its
        args (a seed)."""
        user = self.config.user
        if "data_fn" not in user:
            raise ValueError(f"job {self.config.job_id}: user.data_fn missing")
        key = self._data_source_key()
        cached = devcache.host_data.get(key)
        if cached is not None:
            return cached
        out = resolve_symbol(user["data_fn"])(**user.get("data_args", {}))
        arrays = [np.asarray(a)
                  for a in (out if isinstance(out, (tuple, list)) else (out,))]
        devcache.host_data.put(key, arrays)
        return arrays

    def _create(self, master: ETMaster, table_cfg, executor_ids) -> Table:
        return master.create_table(
            table_cfg.replace(table_id=f"{self.config.job_id}:{table_cfg.table_id}"),
            executor_ids)

    def setup(self, master: ETMaster, executor_ids: List[str]) -> None:
        """Create the job's PRIVATE tables on its executors' device and
        materialize its data."""
        self._setup_start = time.perf_counter()
        self._master = master
        probe = self._make_trainer()
        self._table = self._create(master, probe.model_table_config(), executor_ids)
        if probe.uses_local_table:
            self._local = self._create(master, probe.local_table_config(), executor_ids)
        self._data_arrays = self._make_data()

    def make_worker(self) -> WorkerTasklet:
        """The job's one worker over the tables and data that ``setup`` made."""
        cfg = self.config
        nb = cfg.params.num_mini_batches
        src = self._data_source_key()
        n = len(self._data_arrays[0])
        data = TrainingDataProvider(
            self._data_arrays, nb,
            dataset_key=None if src is None else (src, 0, n, nb))
        ctx = TrainerContext(params=cfg.params, model_table=self._table,
                             local_table=self._local, worker_id=f"{cfg.job_id}/w0",
                             num_workers=1)
        return WorkerTasklet(cfg.job_id, ctx, self._make_trainer(), data)

    def run(self) -> Dict[str, Any]:
        worker = self.make_worker()
        result = worker.run()
        # perf_counter from the start of setup (tables, data) to the worker's end
        return {"job_id": self.config.job_id, "workers": {worker.ctx.worker_id: result},
                "span": [self._setup_start, time.perf_counter()]}

    def cleanup(self) -> None:
        for table in (self._table, self._local):
            if self._master is not None and table is not None:
                self._master.drop_table(table.spec.table_id)
        self._table = self._local = None


class PregelJobEntity:
    """A vertex-centric BSP job (the reference's ``PregelJobEntity``)."""

    def __init__(self, config: JobConfig) -> None:
        self.config = config
        self._pregel_master: Optional[PregelMaster] = None

    def setup(self, master: ETMaster, executor_ids: List[str]) -> None:
        cfg = self.config
        user = cfg.user
        if "graph_fn" not in user:
            raise ValueError(f"job {cfg.job_id}: user.graph_fn missing")
        graph = resolve_symbol(user["graph_fn"])(**user.get("graph_args", {}))
        comp_cls = resolve_symbol(cfg.trainer)
        app_params = dict(cfg.params.app_params)
        if "graph" in inspect.signature(comp_cls.__init__).parameters:
            app_params["graph"] = graph
        devices = {master.executor(e).device for e in executor_ids}
        if len(devices) != 1:
            raise NotImplementedError(
                f"job {cfg.job_id}: executors {list(executor_ids)} span devices "
                f"{sorted(map(str, devices))}; a Pregel job runs on one device")
        self._pregel_master = PregelMaster(
            graph, comp_cls(**app_params), devices.pop(),
            max_supersteps=int(user.get("max_supersteps", 100)), job_id=cfg.job_id)

    def run(self) -> Dict[str, Any]:
        return self._pregel_master.run()

    def cleanup(self) -> None:
        if self._pregel_master is not None:
            self._pregel_master.close()
        self._pregel_master = None


def build_entity(config: JobConfig):
    """The app-type switch (the reference's ``JobEntity.getJobEntity``)."""
    if config.app_type == "dolphin":
        return DolphinJobEntity(config)
    if config.app_type == "pregel":
        return PregelJobEntity(config)
    raise ValueError(f"unknown app_type {config.app_type!r}")
