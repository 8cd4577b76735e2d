"""Data axis 2 for the trainers whose delta is not linear in the batch, and
beside a worker-local table (``dolphin/worker.py::_DataParallelStep``'s split,
``dolphin/rows.py``, the apps' ``row_part``/``row_finish``), on the CPU.

NMF, LDA (dense and sparse), GBT and Lasso on (data 2, model 2) of 4 virtual
CPU slots, against the reference's jobs on ``build_mesh(4 of the 8 virtual
CPU devices, data=2, model=2)`` (its JobServer with ``data_axis`` 2) and
against the port's one-slot runs. Tolerances:

* Losses (NMF's and Lasso's loss, GBT's, LDA's log-likelihood), per batch:
  1e-5 x max(1, |loss|), against the reference and against the port's one
  slot. The rows' sums add in another order than one slot's (or XLA's)
  sums.
* LDA's counts and assignments: exact against the port's one-slot run (the
  counts are integer-valued f32; each document's draws depend on its own
  seed, never on its row).
* GBT's trees: equal as partitions of their batches where no exact tie
  occurs (``tests/test_torch_gbt.py``'s rule), leaf values within 1e-5.
* NMF's R and L: 1e-5 against one slot, relative and absolute.
* A data-axis run is the same bits twice; the local table's replicas are
  alike after every step.
"""
import jax
import numpy as np
import pytest
import torch

from harmony_tpu.config.params import JobConfig as JaxJobConfig
from harmony_tpu.config.params import TrainerParams as JaxTrainerParams
from harmony_tpu.jobserver import JobServer as JaxJobServer
from harmony_tpu.parallel import DevicePool as JaxDevicePool
from harmony_tpu_torch import cli
from harmony_tpu_torch.apps import nmf
from harmony_tpu_torch.config.base import resolve_symbol
from harmony_tpu_torch.config.params import JobConfig, TrainerParams
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.prefetch import PrefetchPipeline
from harmony_tpu_torch.dolphin.rows import RowBatch, RowInput, run_split
from harmony_tpu_torch.dolphin.trainer import Trainer, TrainerContext
from harmony_tpu_torch.dolphin.worker import WorkerTasklet, _DataParallelStep
from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.models.pytree_trainer import PyTreeTrainer
from harmony_tpu_torch.parallel.mesh import DevicePool, build_mesh
from harmony_tpu_torch.runtime.master import ETMaster
from harmony_tpu_torch.table.table import DenseTable, TableSpec

CPU = torch.device("cpu")
TIMEOUT = 300
RTOL = 1e-5

APPS = {
    "nmf": ("nmf:NMFTrainer", "nmf:make_synthetic",
            {"num_rows": 128, "num_cols": 48, "rank": 8, "step_size": 0.05},
            {"num_rows": 128, "num_cols": 48, "rank": 8}),
    "lda": ("lda:LDATrainer", "lda:make_synthetic",
            {"vocab_size": 80, "num_topics": 5, "num_docs": 128, "max_doc_len": 12},
            {"num_docs": 128, "vocab_size": 80, "doc_len": 12, "num_topics": 5}),
    "sparse-lda": ("lda:LDATrainer", "lda:make_synthetic_sparse",
                   {"vocab_size": 80, "num_topics": 5, "num_docs": 128, "max_doc_len": 12,
                    "sparse": True},
                   {"num_docs": 128, "vocab_size": 80, "doc_len": 12, "num_topics": 5}),
    "gbt": ("gbt:GBTTrainer", "gbt:make_binned_synthetic",
            {"num_features": 6, "num_examples": 256, "num_rounds": 8, "max_depth": 3,
             "step_size": 0.4},
            {"n": 256, "num_features": 6}),
    "lasso": ("lasso:LassoTrainer", "lasso:make_training_data",
              {"num_features": 24, "lam": 0.05},
              {"n": 256, "num_features": 24}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def job(app, data_axis=1, pkg="harmony_tpu_torch", epochs=2):
    trainer, data_fn, app_params, data_args = APPS[app]
    cls, params = ((JobConfig, TrainerParams) if pkg == "harmony_tpu_torch"
                   else (JaxJobConfig, JaxTrainerParams))
    # the reference's lasso data function returns its ground truth too, which
    # its provider refuses: its jobs read the port's copy of the same draws
    data_pkg = "harmony_tpu_torch" if app == "lasso" else pkg
    user = {"data_fn": f"{data_pkg}.apps.{data_fn}", "data_args": dict(data_args)}
    if data_axis > 1:
        user["data_axis"] = data_axis
    return cls(job_id=app, app_type="dolphin", trainer=f"{pkg}.apps.{trainer}",
               params=params(num_epochs=epochs, num_mini_batches=4,
                             app_params=dict(app_params)),
               num_workers=1, user=user)


def server_run(config, executors):
    pool = DevicePool.virtual(CPU, executors) if executors > 1 else DevicePool([CPU])
    server = JobServer(executors, device_pool=pool)
    server.start()
    try:
        res = server.submit(config).result(timeout=TIMEOUT)
    finally:
        server.shutdown(timeout=TIMEOUT)
    (w,) = res["workers"].values()
    return w


def ref_losses(config):
    ref = JaxJobServer(num_executors=4, device_pool=JaxDevicePool(jax.devices()[:4]))
    ref.start()
    try:
        ref.submit(config).result(timeout=TIMEOUT)
        ms = sorted(ref.metrics.worker_batch_metrics(job_id=config.job_id),
                    key=lambda m: (m.epoch_idx, m.batch_idx))
    finally:
        ref.shutdown(timeout=TIMEOUT)
    return [m.loss for m in ms]


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    gap = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert gap.max() <= RTOL, (gap.max(), got, want)


@pytest.mark.parametrize("app", sorted(APPS))
def test_data_axis_2_runs_the_jobserver_job_near_the_reference_and_one_slot(app):
    one = server_run(job(app), 1)
    two = server_run(job(app, data_axis=2), 4)
    again = server_run(job(app, data_axis=2), 4)
    assert two["mesh"] == {"data": 2, "model": 2} and two["step_mode"] == "data_parallel"
    assert two["batch_losses"] == again["batch_losses"]
    assert len(two["batch_losses"]) == 8
    # every step's batch came staged per row (the prefetch ring, then the caches)
    assert two["input"]["restaged_batches"] == 0
    close(two["batch_losses"], one["batch_losses"])
    close(two["batch_losses"], ref_losses(job(app, data_axis=2, pkg="harmony_tpu")))


def entity_run(app, executors, data_axis=1, epochs=2):
    """A lone worker (fused windows over the row-staged stack) through the
    entity's set-up: (result, model table, local table or None), the tables
    copied before cleanup."""
    pool = DevicePool.virtual(CPU, executors) if executors > 1 else DevicePool([CPU])
    master = ETMaster(pool)
    ids = [e.id for e in master.add_executors(executors)]
    entity = DolphinJobEntity(job(app, data_axis=data_axis, epochs=epochs))
    entity.setup(master, ids)
    try:
        worker = entity.make_worker()
        res = worker.run()
        model = None if APPS[app][2].get("sparse") else entity._table.pull_array().clone()
        local = None if entity._local is None else entity._local.pull_array().clone()
        return res, model, local, entity, worker
    finally:
        entity.cleanup()


def test_lda_counts_and_assignments_are_the_one_slot_bits():
    one, m1, l1, _, _ = entity_run("lda", 1, epochs=3)
    two, m2, l2, _, _ = entity_run("lda", 4, data_axis=2, epochs=3)
    assert two["step_mode"] == "data_parallel" and two["fused_epochs"]
    assert torch.equal(m2, m1) and torch.equal(l2, l1)
    assert (l2 >= 0).any()
    close(two["batch_losses"], one["batch_losses"])


def test_nmf_factors_match_one_slot():
    one, r1, l1, _, _ = entity_run("nmf", 1)
    two, r2, l2, _, _ = entity_run("nmf", 4, data_axis=2)
    np.testing.assert_allclose(r2.numpy(), r1.numpy(), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=RTOL, atol=RTOL)
    close(two["batch_losses"], one["batch_losses"])


def _settled_at(tree, bins, n):
    feat, thr = tree[:n].astype(np.int64), tree[n:2 * n].astype(np.int64)
    leaf = tree[2 * n:3 * n] > 0.5
    pos = np.zeros(len(bins), np.int64)
    while not leaf[pos].all():
        right = bins[np.arange(len(bins)), feat[pos]] > thr[pos]
        pos = np.where(leaf[pos], pos, 2 * pos + 1 + right)
    return pos


def test_gbt_trees_are_the_one_slot_trees_as_partitions():
    one, t1, s1, entity, _ = entity_run("gbt", 1)
    two, t2, s2, _, _ = entity_run("gbt", 4, data_axis=2)
    assert float(s1[0, 0]) == float(s2[0, 0]) == 8.0   # one round a step, not a row
    t1, t2 = t1.numpy(), t2.numpy()
    n = 2 ** 4 - 1
    np.testing.assert_array_equal(t2[:, 2 * n:3 * n], t1[:, 2 * n:3 * n])
    np.testing.assert_allclose(t2[:, 3 * n:], t1[:, 3 * n:], rtol=RTOL, atol=RTOL)
    batches = np.split(entity._data_arrays[0], 4)
    for r in range(8):
        np.testing.assert_array_equal(_settled_at(t2[r], batches[r % 4], n),
                                      _settled_at(t1[r], batches[r % 4], n))
    close(two["batch_losses"], one["batch_losses"])


def test_nmf_averaged_row_deltas_would_differ_where_the_projection_clamps():
    """The combine happens on sufficient statistics, before the projection.
    At a large step the projected delta clamps R at zero for part of its
    entries; there the mean of two half-batch projected deltas differs from
    the whole batch's by far more than rounding, and the split does not."""
    rng = np.random.default_rng(0)
    t = nmf.NMFTrainer(num_rows=16, num_cols=12, rank=4, step_size=0.5)
    model = torch.as_tensor(rng.uniform(0, 0.5, (12, 4)).astype(np.float32))
    local = torch.as_tensor(rng.uniform(0, 1.0, (16, 4)).astype(np.float32))
    rows = torch.arange(16, dtype=torch.int32)
    x = torch.as_tensor(rng.uniform(0, 1.0, (16, 12)).astype(np.float32))
    hyper = {"lr": torch.tensor(0.5)}
    whole, _, m_whole = t.compute_with_local(model, local, (rows, x), hyper)
    halves = [t.compute_with_local(model, local, (rows[s], x[s]), hyper)[0]
              for s in (slice(0, 8), slice(8, 16))]
    averaged = (halves[0] + halves[1]) / 2
    split, metrics, _, results = run_split(t, [
        RowInput(CPU, model, (rows[s], x[s]), hyper, local)
        for s in (slice(0, 8), slice(8, 16))], 16)
    clamped = (model + whole) == 0
    assert clamped.any() and not clamped.all()
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=RTOL, atol=1e-6)
    assert (averaged - whole).abs().max() > 1e-2
    close([float(metrics["loss"])], [float(m_whole["loss"])])
    assert [r.local_keys.tolist() for r in results] == [list(range(8)), list(range(8, 16))]


def _dp_tables(trainer, mesh):
    model = DenseTable(TableSpec(trainer.model_table_config()), mesh)
    local = DenseTable(TableSpec(trainer.local_table_config()), mesh)
    return model, local


@pytest.mark.parametrize("app", ["nmf", "lda", "gbt"])
def test_the_local_tables_replicas_are_alike_after_every_step(app):
    trainer_path, data_fn, app_params, data_args = APPS[app]
    trainer = resolve_symbol(f"harmony_tpu_torch.apps.{trainer_path}")(**app_params)
    arrays = resolve_symbol(f"harmony_tpu_torch.apps.{data_fn}")(**data_args)
    mesh = build_mesh(DevicePool.virtual(CPU, 4).slots, data=2, model=2)
    model, local = _dp_tables(trainer, mesh)
    ctx = TrainerContext(params=TrainerParams(num_epochs=1, num_mini_batches=4),
                         model_table=model, local_table=local)
    worker = WorkerTasklet(app, ctx, trainer, TrainingDataProvider(list(arrays), 4))
    trainer.init_global_settings(ctx)
    worker._build_step()
    assert isinstance(worker._step, _DataParallelStep)
    hyper = worker._hyper()
    for b in range(4):
        batch = worker._place(worker.data.batch_at(b))
        assert isinstance(batch, RowBatch)
        model.apply_step_with(local, worker._layout_step, batch, hyper)
        shards = local.array.shards
        for slot, t in shards.items():
            twin = [u for s, u in shards.items()
                    if local.sharding.shard_of(s) == local.sharding.shard_of(slot)]
            assert all(torch.equal(t, u) for u in twin), f"step {b}"


def test_a_batch_that_writes_a_local_row_twice_is_refused():
    row_idx, x = nmf.make_synthetic(64, 16, 4)
    row_idx = row_idx.copy()
    row_idx[40] = 33            # batch 1 holds rows 32..47: 33 twice
    trainer = nmf.NMFTrainer(num_rows=64, num_cols=16, rank=4)
    mesh = build_mesh(DevicePool.virtual(CPU, 4).slots, data=2, model=2)
    model, local = _dp_tables(trainer, mesh)
    ctx = TrainerContext(params=TrainerParams(num_epochs=1, num_mini_batches=4),
                         model_table=model, local_table=local)
    worker = WorkerTasklet("nmf", ctx, trainer, TrainingDataProvider([row_idx, x], 4))
    with pytest.raises(ValueError, match="batch 2 writes local row 33 .* more than once"):
        worker.run()
    # one slot writes it as before (the reference leaves it undefined)
    one = DenseTable(TableSpec(trainer.model_table_config()), "cpu")
    one_local = DenseTable(TableSpec(trainer.local_table_config()), "cpu")
    ctx1 = TrainerContext(params=TrainerParams(num_epochs=1, num_mini_batches=4),
                          model_table=one, local_table=one_local)
    assert WorkerTasklet("nmf", ctx1, nmf.NMFTrainer(num_rows=64, num_cols=16, rank=4),
                         TrainingDataProvider([row_idx, x], 4)).run()["epochs_run"] == 1


def test_each_rows_part_is_staged_on_its_row_and_the_step_copies_none(monkeypatch):
    """The stack of a lone worker and the batches of a JobServer worker come
    cut over the rows: the tensors a row computes on are its staged part
    (the same storage), holding its contiguous slice of the batch."""
    seen = []
    real = nmf.NMFTrainer.row_part

    def spy(self, model, batch, hyper, local=None):
        seen.append(batch)
        return real(self, model, batch, hyper, local)

    monkeypatch.setattr(nmf.NMFTrainer, "row_part", spy)
    res, _, _, _, worker = entity_run("nmf", 4, data_axis=2, epochs=1)
    assert res["input"]["restaged_batches"] == 0
    stack = worker._stacked_cache
    assert isinstance(stack, RowBatch) and len(stack.parts) == 2
    assert len(seen) == 2 * 4
    for i, batch in enumerate(seen):
        b, r = divmod(i, 2)
        staged = stack.parts[r][0]
        assert batch[0].untyped_storage().data_ptr() == staged.untyped_storage().data_ptr()
        assert batch[0].tolist() == list(range(32 * b + 16 * r, 32 * b + 16 * r + 16))


def test_the_prefetch_ring_stages_each_rows_part():
    arrays = [np.arange(40, dtype=np.int32), np.arange(80, dtype=np.float32).reshape(40, 2)]
    pipe = PrefetchPipeline(TrainingDataProvider(arrays, 2), CPU, lambda: 2,
                            rows=[CPU, CPU])
    try:
        staged = list(pipe)
    finally:
        pipe.close()
    assert [s.index for s in staged] == [0, 1]
    for s in staged:
        batch = s.take()
        assert isinstance(batch, RowBatch)
        lo = 20 * s.index
        assert batch.parts[0][0].tolist() == list(range(lo, lo + 10))
        assert batch.parts[1][0].tolist() == list(range(lo + 10, lo + 20))
        assert batch.joined(CPU)[1].shape == (20, 2)


class _Neither(Trainer):
    def compute(self, model, batch, hyper):
        return torch.zeros_like(model), {}


class _LinearBesideALocal(Trainer):
    uses_local_table = True
    batch_reduction = "mean"


def test_a_trainer_with_neither_contract_is_refused():
    spec = TableSpec(nmf.NMFTrainer(8, 8, 2).model_table_config())
    with pytest.raises(ValueError, match="neither .*batch_reduction.* nor a split"):
        _DataParallelStep(spec, _Neither(), push_route=None, is_hash=False)
    with pytest.raises(ValueError, match="ROADMAP A.12"):
        _DataParallelStep(spec, PyTreeTrainer.__new__(PyTreeTrainer), push_route=None,
                          is_hash=False)
    with pytest.raises(ValueError, match="worker-local table: on a data axis > 1"):
        _DataParallelStep(spec, _LinearBesideALocal(), push_route=None, is_hash=False)
    for app in ("nmf", "lda", "gbt", "lasso"):
        t = resolve_symbol(f"harmony_tpu_torch.apps.{APPS[app][0]}")(**APPS[app][2])
        assert t.splits_rows and t.batch_reduction is None


@pytest.mark.parametrize("app", ["nmf", "lda", "gbt", "lasso"])
def test_cli_configs_with_a_data_axis_run_on_a_jobserver_of_four_slots(app):
    overrides = {
        "nmf": ["--set", "num_rows=64", "--set", "num_cols=32", "--data", "num_rows=64",
                "--data", "num_cols=32"],
        "lda": ["--set", "num_docs=64", "--data", "num_docs=64"],
        "gbt": ["--set", "num_examples=256", "--data", "n=256"],
        "lasso": ["--data", "n=256", "--set", "num_features=16", "--data", "num_features=16"],
    }[app]
    args = cli.build_parser().parse_args(
        ["run", app, "--device", "cpu", "--epochs", "1", "--batches", "2",
         "--workers", "1", "--set", "data_axis=2", *overrides])
    cfg = cli.build_config(args.app, args)
    assert cfg.user["data_axis"] == 2
    two = server_run(cfg, 4)
    one = server_run(cfg.replace(user={k: v for k, v in cfg.user.items()
                                       if k != "data_axis"}), 1)
    assert two["mesh"] == {"data": 2, "model": 2} and two["step_mode"] == "data_parallel"
    close(two["batch_losses"], one["batch_losses"])
