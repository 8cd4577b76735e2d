"""Lasso (``apps/lasso.py``) and AddVector/AddInteger (``apps/addvector.py``)
against harmony_tpu's on the CPU.

Tolerances:

* Data, table schemas, AddVector's and AddInteger's totals: exact (integer
  counts in f32).
* Lasso's weights, loss and residual-based metrics: 1e-5 relative (absolute
  1e-6 for weights near 0). Each coordinate's dot products sum the batch in
  another order than XLA's, so weights differ in the last bits; the
  soft-threshold keeps the same coordinates at zero in these runs (``nnz``
  is compared exactly, and no coordinate flips).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.apps import addvector as jax_addvector
from harmony_tpu.apps import lasso as jax_lasso
from harmony_tpu.config.params import TrainerParams as JaxTrainerParams
from harmony_tpu.dolphin import TrainerContext as JaxTrainerContext
from harmony_tpu.dolphin import TrainingDataProvider as JaxData
from harmony_tpu.dolphin import WorkerTasklet as JaxWorker
from harmony_tpu.parallel import build_mesh
from harmony_tpu.table import DenseTable as JaxDenseTable
from harmony_tpu.table import TableSpec as JaxTableSpec
from harmony_tpu_torch import cli
from harmony_tpu_torch.apps import addvector, lasso
from harmony_tpu_torch.config.params import JobConfig, TrainerParams
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.trainer import TrainerContext
from harmony_tpu_torch.dolphin.worker import WorkerTasklet
from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.table.table import DenseTable, TableSpec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL = 1e-5
W_ATOL = 1e-6
TIMEOUT = 120
LASSO = dict(num_features=32, lam=0.05)


def test_lasso_data_is_byte_identical():
    for a, b in zip(jax_lasso.make_synthetic(300, 40, nnz=5, seed=4),
                    lasso.make_synthetic(300, 40, nnz=5, seed=4)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    x, y = lasso.make_training_data(300, 40, nnz=5, seed=4)
    jx, jy, _ = jax_lasso.make_synthetic(300, 40, nnz=5, seed=4)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("pair", ["lasso", "addvector", "addinteger"])
def test_table_schemas_match(pair):
    jt, tt = {
        "lasso": (jax_lasso.LassoTrainer(**LASSO), lasso.LassoTrainer(**LASSO)),
        "addvector": (jax_addvector.AddVectorTrainer(20, 8),
                      addvector.AddVectorTrainer(20, 8)),
        "addinteger": (jax_addvector.AddIntegerTrainer(20),
                       addvector.AddIntegerTrainer(20)),
    }[pair]
    a, b = jt.model_table_config(), tt.model_table_config()
    for field in ("table_id", "capacity", "value_shape", "num_blocks", "is_ordered",
                  "update_fn", "dtype"):
        assert getattr(b, field) == getattr(a, field), field
    assert tt.pull_mode == jt.pull_mode and tt.uses_local_table == jt.uses_local_table


def test_lasso_sweep_matches():
    """One shooting sweep from a nonzero model: the delta, the loss and nnz."""
    x, y, _ = lasso.make_synthetic(64, LASSO["num_features"], seed=2)
    model = np.random.default_rng(3).normal(scale=0.1,
                                            size=LASSO["num_features"]).astype(np.float32)
    jd, jm = jax.jit(jax_lasso.LassoTrainer(**LASSO).compute)(
        jnp.asarray(model), (jnp.asarray(x), jnp.asarray(y)), {})
    td, tm = lasso.LassoTrainer(**LASSO).compute(
        torch.as_tensor(model), (torch.as_tensor(x), torch.as_tensor(y)), {})
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=W_ATOL)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL)
    assert int(tm["nnz"]) == int(jm["nnz"])
    np.testing.assert_array_equal(td.numpy() + model == 0, np.asarray(jd) + model == 0)


def test_lasso_two_epochs_match_the_jax_worker():
    """Two epochs of 4 mini-batches through each package's WorkerTasklet: the
    per-epoch losses, nnz of the final weights, the weights (the same zero
    pattern) and the evaluation."""
    x, y = lasso.make_training_data(256, LASSO["num_features"], seed=1)
    jt, tt = jax_lasso.LassoTrainer(**LASSO), lasso.LassoTrainer(**LASSO)
    mesh = build_mesh(jax.devices()[:1])
    jm = JaxDenseTable(JaxTableSpec(jt.model_table_config()), mesh)
    jres = JaxWorker("lasso", JaxTrainerContext(
        params=JaxTrainerParams(num_epochs=2, num_mini_batches=4), model_table=jm),
        jt, JaxData([x, y], 4), mesh).run()
    tm = DenseTable(TableSpec(tt.model_table_config()), "cpu")
    worker = WorkerTasklet("lasso", TrainerContext(
        params=TrainerParams(num_epochs=2, num_mini_batches=4), model_table=tm),
        tt, TrainingDataProvider([x, y], 4))
    tres = worker.run()
    np.testing.assert_allclose(tres["losses"], jres["losses"], rtol=RTOL)
    w, jw = tm.pull_array().numpy(), np.asarray(jm.pull_array())
    np.testing.assert_allclose(w, jw, rtol=RTOL, atol=W_ATOL)
    np.testing.assert_array_equal(np.abs(w) > 1e-6, np.abs(jw) > 1e-6)
    assert 0 < int((np.abs(w) > 1e-6).sum()) < LASSO["num_features"]
    je = jax.jit(jt.evaluate)(jnp.asarray(jw), (jnp.asarray(x), jnp.asarray(y)))
    te = worker.evaluate((x, y))
    for key in ("loss", "mse"):
        np.testing.assert_allclose(te[key], float(je[key]), rtol=RTOL)


def _job(app, job_id, **app_params):
    trainer = {"addvector": "AddVectorTrainer", "addinteger": "AddIntegerTrainer"}[app]
    return JobConfig(
        job_id=job_id, app_type="dolphin",
        trainer=f"harmony_tpu_torch.apps.addvector:{trainer}",
        params=TrainerParams(num_epochs=3, num_mini_batches=5, app_params=app_params),
        user={"data_fn": "harmony_tpu_torch.apps.addvector:make_marks",
              "data_args": {"n": 1003}})


def test_addvector_and_addinteger_totals_are_exact_through_the_jobserver(monkeypatch):
    """Both jobs at once on one JobServer: when each job ends, every key of its
    table holds exactly expected_value(examples processed), 1003 examples in
    5 batches of 200 (3 dropped) for 3 epochs; then the tables are dropped.
    The tables are read as the entity's cleanup begins."""
    seen = {}
    cleanup = DolphinJobEntity.cleanup

    def read_then_cleanup(entity):
        seen[entity.config.job_id] = entity._table.pull_array().numpy()
        cleanup(entity)

    monkeypatch.setattr(DolphinJobEntity, "cleanup", read_then_cleanup)
    jobs = {"addvector": ({"num_keys": 20, "vector_dim": 8, "delta": 0.5}, (20, 8)),
            "addinteger": ({"num_keys": 12, "delta": 2.0}, (12,))}
    server = JobServer(1, device_pool=DevicePool(["cpu"]))
    server.start()
    try:
        futures = [server.submit(_job(app, app, **params)) for app, (params, _) in jobs.items()]
        for fut in futures:
            (worker,) = fut.result(timeout=TIMEOUT)["workers"].values()
            assert worker["epochs_run"] == 3
    finally:
        server.shutdown(timeout=TIMEOUT)
    assert server.master.table_ids() == []
    for app, (params, shape) in jobs.items():
        trainer = getattr(addvector, _job(app, app).trainer.split(":")[1])(**params)
        np.testing.assert_array_equal(
            seen[app], np.full(shape, trainer.expected_value(3 * 1000), np.float32))


@pytest.mark.parametrize("app,params,shape", [
    ("addvector", {"num_keys": 20, "vector_dim": 8, "delta": 0.5}, (20, 8)),
    ("addinteger", {"num_keys": 12, "delta": 2.0}, (12,)),
])
def test_addvector_table_holds_the_expected_value(app, params, shape):
    """The worker's table after 3 epochs equals expected_value at every key,
    exactly, in both packages."""
    jcls = getattr(jax_addvector, _job(app, app).trainer.split(":")[1])
    tcls = getattr(addvector, _job(app, app).trainer.split(":")[1])
    jt, tt = jcls(**params), tcls(**params)
    (marks,) = addvector.make_marks(1003)
    mesh = build_mesh(jax.devices()[:1])
    jm = JaxDenseTable(JaxTableSpec(jt.model_table_config()), mesh)
    JaxWorker(app, JaxTrainerContext(params=JaxTrainerParams(num_epochs=3,
                                                             num_mini_batches=5),
                                     model_table=jm), jt, JaxData([marks], 5), mesh).run()
    tm = DenseTable(TableSpec(tt.model_table_config()), "cpu")
    WorkerTasklet(app, TrainerContext(params=TrainerParams(num_epochs=3, num_mini_batches=5),
                                      model_table=tm), tt,
                  TrainingDataProvider([marks], 5)).run()
    want = np.full(shape, tt.expected_value(3 * 1000), np.float32)
    assert tt.expected_value(3000) == jt.expected_value(3000)
    np.testing.assert_array_equal(tm.pull_array().numpy(), want)
    np.testing.assert_array_equal(np.asarray(jm.pull_array()), want)


@pytest.mark.parametrize("app", ["lasso", "addvector", "addinteger"])
def test_cli_runs_the_preset_on_the_cpu(capsys, app):
    """The preset through cli -> JobServer -> WorkerTasklet: 3 epochs of 4
    mini-batches; Lasso's loss falls (AddVector and AddInteger report no
    loss)."""
    argv = ["run", app, "--device", "cpu", "--epochs", "3", "--batches", "4"]
    if app == "lasso":
        argv += ["--set", "num_features=64", "--data", "num_features=64",
                 "--data", "n=512"]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (worker,) = out["result"]["workers"].values()
    assert worker["epochs_run"] == 3 and len(worker["batch_losses"]) == 12
    if app == "lasso":
        assert worker["batch_losses"][-1] < worker["batch_losses"][0]
    else:
        assert worker["losses"] == [0.0, 0.0, 0.0]   # no "loss" metric: progress 0
