"""harmony_tpu_torch's FM / Wide&Deep slice against harmony_tpu on the CPU.

The same numpy rows, batches and starting table go through the JAX trainers
and worker (one-device CPU mesh) and through the port's.

Tolerances: ``make_synthetic``, ``pull_keys`` and the seeded initial table
are numpy draws and integer arithmetic, so they are exact. Everything that
sums floats (the scores, the MLP's matrix products, the loss mean, the push's
duplicate folds) takes its f32 additions in another order in the two
frameworks; at these widths that moves the last one or two of f32's ~7
digits, so losses and deltas agree to 1e-5 relative and 1e-6 absolute, and
after 8 SGD steps the losses and the whole table agree to 1e-5 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.apps import widedeep as jax_wd
from harmony_tpu.config.params import TrainerParams as JaxTrainerParams
from harmony_tpu.dolphin import TrainerContext as JaxTrainerContext
from harmony_tpu.dolphin import TrainingDataProvider as JaxData
from harmony_tpu.dolphin import WorkerTasklet as JaxWorker
from harmony_tpu.parallel import build_mesh
from harmony_tpu.table import DenseTable as JaxDenseTable
from harmony_tpu.table import TableSpec as JaxTableSpec
from harmony_tpu_torch.apps import widedeep as torch_wd
from harmony_tpu_torch.config.params import TrainerParams
from harmony_tpu_torch.convert import table_from_numpy
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.trainer import TrainerContext
from harmony_tpu_torch.dolphin.worker import WorkerTasklet
from harmony_tpu_torch.ops.histogram import weighted_histogram
from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows
from harmony_tpu_torch.table.table import TableSpec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL, ATOL = 1e-5, 1e-6
SLICE_ATOL = 1e-5

# the slice at a small size: vocab 512, 4 slots, emb 8, hidden 16
SMALL = dict(vocab_size=512, num_slots=4, emb_dim=8)
APPS = {
    "fm": (jax_wd.FMTrainer, torch_wd.FMTrainer, dict(SMALL, step_size=0.5)),
    "widedeep": (jax_wd.WideDeepTrainer, torch_wd.WideDeepTrainer,
                 dict(SMALL, hidden=16, step_size=0.5)),
}


@pytest.fixture()
def mesh1():
    return build_mesh(jax.devices()[:1])


def _trainers(app):
    jcls, tcls, kw = APPS[app]
    return jcls(**kw), tcls(**kw)


def _batch(n=64, seed=0):
    return jax_wd.make_synthetic(n, SMALL["vocab_size"], SMALL["num_slots"], seed=seed)


def test_make_synthetic_is_byte_identical():
    for a, b in zip(_batch(300, seed=3),
                    torch_wd.make_synthetic(300, SMALL["vocab_size"],
                                            SMALL["num_slots"], seed=3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle", [False, True])
def test_data_provider_batches_are_byte_identical(shuffle):
    """Both providers draw their shuffles from numpy default_rng(seed): the
    same arrays give the same batches, epoch after epoch."""
    arrays = list(_batch(203, seed=5))
    jdata = JaxData(arrays, 4, shuffle_each_epoch=shuffle, seed=9)
    tdata = TrainingDataProvider(arrays, 4, shuffle_each_epoch=shuffle, seed=9)
    assert tdata.batch_size == jdata.batch_size == 50
    for _ in range(3):
        jbatches, tbatches = list(jdata.epoch_batches()), list(tdata.epoch_batches())
        assert len(tbatches) == len(jbatches) == 4
        for jb, tb in zip(jbatches, tbatches):
            for a, b in zip(jb, tb):
                np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("app", sorted(APPS))
def test_compute_matches_from_the_same_rows(app):
    jt, tt = _trainers(app)
    ids, y = _batch()
    jkeys = np.asarray(jt.pull_keys((jnp.asarray(ids), jnp.asarray(y))))
    tkeys = tt.pull_keys((torch.as_tensor(ids), torch.as_tensor(y)))
    np.testing.assert_array_equal(tkeys.numpy(), jkeys)
    rows = np.random.default_rng(1).normal(
        scale=0.3, size=(len(jkeys), tt.width)).astype(np.float32)
    jdelta, jm = jt.compute(jnp.asarray(rows), (jnp.asarray(ids), jnp.asarray(y)),
                            {"lr": jnp.asarray(0.5, jnp.float32)})
    tdelta, tm = tt.compute(torch.as_tensor(rows), (torch.as_tensor(ids), torch.as_tensor(y)),
                            {"lr": torch.tensor(0.5)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL, atol=ATOL)
    assert tdelta.shape == rows.shape
    np.testing.assert_allclose(tdelta.numpy(), np.asarray(jdelta), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("app", sorted(APPS))
def test_evaluate_matches(app):
    jt, tt = _trainers(app)
    ids, y = _batch(seed=2)
    cap = tt.model_table_config().capacity
    model = np.random.default_rng(2).normal(scale=0.3, size=(cap, tt.width)).astype(np.float32)
    jm = jt.evaluate(jnp.asarray(model), (jnp.asarray(ids), jnp.asarray(y)))
    tm = tt.evaluate(torch.as_tensor(model), (torch.as_tensor(ids), torch.as_tensor(y)))
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL, atol=ATOL)


def _jax_table(jt, mesh):
    table = JaxDenseTable(JaxTableSpec(jt.model_table_config()), mesh)
    jt.init_global_settings(JaxTrainerContext(params=JaxTrainerParams(), model_table=table))
    return table


@pytest.mark.parametrize("app", sorted(APPS))
def test_seeded_init_is_byte_identical(app, mesh1):
    from harmony_tpu_torch.table.table import DenseTable

    jt, tt = _trainers(app)
    cfg = tt.model_table_config()
    assert cfg.capacity == jt.model_table_config().capacity
    assert cfg.num_blocks == jt.model_table_config().num_blocks
    table = DenseTable(TableSpec(cfg), "cpu")
    tt.init_global_settings(TrainerContext(params=TrainerParams(), model_table=table))
    np.testing.assert_array_equal(table.array.numpy(), np.asarray(_jax_table(jt, mesh1).array))


@pytest.mark.parametrize("route", ["scatter", "mxu", "sparse"])
def test_slice_matches_jax_worker(route, mesh1, monkeypatch):
    """The whole slice: the JAX WorkerTasklet (built as tests/test_widedeep.py
    builds it) against the port's, from the same seeded table carried across
    with table_from_numpy, on each push route (plain versions on the CPU):
    per-epoch losses and the final table."""
    epochs, batches = 2, 4
    jt, tt = _trainers("widedeep")
    ids, y = _batch(n=512, seed=4)
    jtable = _jax_table(jt, mesh1)
    start = np.asarray(jtable.array).copy()
    jres = JaxWorker(
        "wd", JaxTrainerContext(params=JaxTrainerParams(num_epochs=epochs,
                                                        num_mini_batches=batches),
                                model_table=jtable),
        jt, JaxData([ids, y], batches), mesh1, global_init=False,
    ).run()

    monkeypatch.setenv("HARMONY_PUSH_VIA", route)
    ttable = table_from_numpy(TableSpec(tt.model_table_config()), start, device="cpu")
    counts = (gather_rows.launches, segment_sum_rows.launches, weighted_histogram.launches)
    tres = WorkerTasklet(
        "wd", TrainerContext(params=TrainerParams(num_epochs=epochs, num_mini_batches=batches),
                             model_table=ttable),
        tt, TrainingDataProvider([ids, y], batches), global_init=False,
    ).run()
    # on the CPU every wrapper takes its plain version
    assert counts == (gather_rows.launches, segment_sum_rows.launches,
                      weighted_histogram.launches)
    assert tres["epochs_run"] == jres["epochs_run"] == epochs
    assert len(tres["batch_losses"]) == epochs * batches
    np.testing.assert_allclose(tres["losses"], jres["losses"], rtol=0, atol=SLICE_ATOL)
    np.testing.assert_allclose(ttable.array.numpy(), np.asarray(jtable.array),
                               rtol=0, atol=SLICE_ATOL)
    assert tres["losses"][-1] < tres["losses"][0]


def test_fm_learns_through_the_port_worker():
    """tests/test_widedeep.py's learning check, on the port."""
    ids, y = torch_wd.make_synthetic(1024, vocab_size=64, num_slots=4, seed=0)
    tr = torch_wd.FMTrainer(vocab_size=64, num_slots=4, emb_dim=4, step_size=2.0)
    from harmony_tpu_torch.table.table import DenseTable

    table = DenseTable(TableSpec(tr.model_table_config()), "cpu")
    w = WorkerTasklet("fm", TrainerContext(params=TrainerParams(num_epochs=8,
                                                                num_mini_batches=4),
                                           model_table=table),
                      tr, TrainingDataProvider([ids, y], 4))
    result = w.run()
    assert result["losses"][-1] < result["losses"][0] - 0.05, result["losses"]
    assert w.evaluate((ids, y))["accuracy"] > 0.6


def test_sparse_mode_is_not_ported():
    """Sparse mode is ported now: ``sparse=True`` builds the reference's hash
    table schema, with the lazy init under its durable factory name."""
    for cls in ("FMTrainer", "WideDeepTrainer"):
        jt = getattr(jax_wd, cls)(vocab_size=8, num_slots=2, sparse=True)
        tt = getattr(torch_wd, cls)(vocab_size=8, num_slots=2, sparse=True)
        jc, tc = jt.model_table_config(), tt.model_table_config()
        for field in ("capacity", "value_shape", "num_blocks", "is_ordered", "sparse"):
            assert getattr(tc, field) == getattr(jc, field), field
        assert tc.update_fn == jc.update_fn.replace("harmony_tpu.", "harmony_tpu_torch.", 1)
        assert tt.extra_base == jt.extra_base == torch_wd.SPARSE_EXTRA_BASE
        assert tt.slot_budget == 32


# -- sparse mode: the model in a DeviceHashTable --------------------------------

SPARSE = dict(SMALL, step_size=0.5, sparse=True, slot_budget=300)
SPARSE_APPS = {
    "fm": dict(SPARSE),
    "widedeep": dict(SPARSE, hidden=16),
}
SPARSE_CLS = {"fm": "FMTrainer", "widedeep": "WideDeepTrainer"}


def _sparse_trainers(app, **over):
    kw = dict(SPARSE_APPS[app], **over)
    return getattr(jax_wd, SPARSE_CLS[app])(**kw), getattr(torch_wd, SPARSE_CLS[app])(**kw)


def test_make_synthetic_sparse_and_the_lazy_init_are_the_references_bits():
    for a, b in zip(jax_wd.make_synthetic_sparse(300, 512, 4, seed=3),
                    torch_wd.make_synthetic_sparse(300, 512, 4, seed=3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    rng = np.random.default_rng(0)
    keys = np.concatenate([rng.integers(-2**31, 2**31, 500),
                           [0, 1, -1, torch_wd.SPARSE_EXTRA_BASE - 1,
                            torch_wd.SPARSE_EXTRA_BASE, 2**31 - 1]]).astype(np.int32)
    for width, scale, seed in ((9, 0.05, 0), (17, 0.3, 7)):
        jfn = jax_wd.make_embed_init(width, scale, seed)
        tfn = torch_wd.make_embed_init(width, scale, seed)
        want = np.asarray(jax.vmap(jfn.init)(jnp.asarray(keys)))
        got = tfn.init(torch.as_tensor(keys)).numpy()
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
        assert (got[:, 0] == 0).all() and (got[keys >= torch_wd.SPARSE_EXTRA_BASE] == 0).all()


def _jax_hash_table(jt, mesh):
    from harmony_tpu.table.hashtable import DeviceHashTable, HashTableSpec

    table = DeviceHashTable(HashTableSpec(jt.model_table_config()), mesh)
    jt.init_global_settings(JaxTrainerContext(params=JaxTrainerParams(), model_table=table))
    return table


@pytest.mark.parametrize("app", sorted(SPARSE_APPS))
def test_sparse_global_init_is_byte_identical(app, mesh1):
    from harmony_tpu_torch.table.hashtable import DeviceHashTable, HashTableSpec

    jt, tt = _sparse_trainers(app)
    table = DeviceHashTable(HashTableSpec(tt.model_table_config()), "cpu")
    tt.init_global_settings(TrainerContext(params=TrainerParams(), model_table=table))
    jtable = _jax_hash_table(jt, mesh1)
    for a, b in zip(jtable.state, table.state):
        assert b.numpy().tobytes() == np.asarray(a).tobytes()


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("app,budget", [("fm", 300), ("widedeep", 300), ("fm", 8)])
def test_sparse_slice_matches_jax_worker(app, budget, fused, mesh1):
    """The sparse slice through each package's WorkerTasklet, from the JAX
    table's state carried across with hash_table_from_numpy: per-epoch
    losses (SLICE_ATOL), the final slot keys byte for byte, the values
    (SLICE_ATOL: the push's fold order), and the refused keys (budget 8:
    288 slots for ~500 ids, the table overflows) counted the same."""
    from harmony_tpu_torch.convert import hash_table_from_numpy
    from harmony_tpu_torch.table.hashtable import HashTableSpec

    epochs, batches = 2, 4
    jt, tt = _sparse_trainers(app, slot_budget=budget)
    ids, y = jax_wd.make_synthetic_sparse(512, SMALL["vocab_size"], SMALL["num_slots"], seed=4)
    jtable = _jax_hash_table(jt, mesh1)
    start = [np.asarray(a).copy() for a in jtable.state]
    jres = JaxWorker(
        app, JaxTrainerContext(params=JaxTrainerParams(num_epochs=epochs,
                                                       num_mini_batches=batches,
                                                       fused_step=fused),
                               model_table=jtable),
        jt, JaxData([ids, y], batches), mesh1, global_init=False,
    ).run()
    ttable = hash_table_from_numpy(HashTableSpec(tt.model_table_config()), *start,
                                   device="cpu")
    tres = WorkerTasklet(
        app, TrainerContext(params=TrainerParams(num_epochs=epochs, num_mini_batches=batches,
                                                 fused_step=fused),
                            model_table=ttable),
        tt, TrainingDataProvider([ids, y], batches), global_init=False,
    ).run()
    assert tres["step_mode"] == ("fused" if fused else "unfused")
    np.testing.assert_allclose(tres["losses"], jres["losses"], rtol=0, atol=SLICE_ATOL)
    jk, jv = (np.asarray(a) for a in jtable.state)
    assert ttable.state[0].numpy().tobytes() == jk.tobytes()
    np.testing.assert_allclose(ttable.state[1].numpy(), jv, rtol=0, atol=SLICE_ATOL)
    assert tres["overflow_count"] == ttable.overflow_count == jtable.overflow_count
    assert (ttable.overflow_count > 0) == (budget == 8)
    assert tres["push_route"] is None


@pytest.mark.parametrize("app", sorted(SPARSE_APPS))
def test_sparse_jobs_through_the_jobserver_match_the_reference(app):
    """bench-fm-hash's JobConfig shape at a small size, submitted to each
    package's JobServer: both start from the same bytes (the lazy init and the
    seeded tail rows are the reference's), so the step losses agree."""
    from harmony_tpu.config.params import JobConfig as JaxJobConfig
    from harmony_tpu.jobserver.server import JobServer as JaxJobServer
    from harmony_tpu.parallel.mesh import DevicePool as JaxDevicePool
    from harmony_tpu_torch.config.params import JobConfig
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    def config(package, cls, params):
        return cls(job_id=f"{app}-hash", app_type="dolphin",
                   trainer=f"{package}.apps.widedeep:{SPARSE_CLS[app]}",
                   params=params(num_epochs=2, num_mini_batches=4, comm_probe_period=6,
                                 app_params=SPARSE_APPS[app]),
                   num_workers=1,
                   user={"data_fn": f"{package}.apps.widedeep:make_synthetic_sparse",
                         "data_args": {"n": 256, "vocab_size": SMALL["vocab_size"],
                                       "num_slots": SMALL["num_slots"]}})

    ref = JaxJobServer(num_executors=1, device_pool=JaxDevicePool(jax.devices("cpu")[:1]))
    ref.start()
    try:
        ref.submit(config("harmony_tpu", JaxJobConfig, JaxTrainerParams)).result(timeout=120)
        want = [m.loss for m in sorted(ref.metrics.worker_batch_metrics(job_id=f"{app}-hash"),
                                       key=lambda m: (m.epoch_idx, m.batch_idx))]
    finally:
        ref.shutdown(timeout=120)
    server = JobServer(1, device_pool=DevicePool(["cpu"]))
    server.start()
    try:
        result = server.submit(config("harmony_tpu_torch", JobConfig, TrainerParams)
                               ).result(timeout=120)
    finally:
        server.shutdown(timeout=120)
    (worker,) = result["workers"].values()
    assert len(worker["batch_losses"]) == len(want) == 8
    np.testing.assert_allclose(worker["batch_losses"], want, rtol=0, atol=SLICE_ATOL)
    assert worker["overflow_count"] == 0 and worker["comm_probe"]["probes"] == 1
    assert server.master.table_ids() == []


def test_sparse_fm_learns_and_evaluates_through_its_keyed_pull():
    ids, y = torch_wd.make_synthetic_sparse(1024, vocab_size=64, num_slots=4, seed=0)
    tr = torch_wd.FMTrainer(vocab_size=64, num_slots=4, emb_dim=4, step_size=2.0, sparse=True)
    from harmony_tpu_torch.table.hashtable import DeviceHashTable, HashTableSpec

    table = DeviceHashTable(HashTableSpec(tr.model_table_config()), "cpu")
    w = WorkerTasklet("fm", TrainerContext(params=TrainerParams(num_epochs=8,
                                                                num_mini_batches=4),
                                           model_table=table),
                      tr, TrainingDataProvider([ids, y], 4))
    result = w.run()
    assert result["losses"][-1] < result["losses"][0] - 0.05, result["losses"]
    present = table.num_present()
    metrics = tr.evaluate_sparse(table, (ids, y))
    assert float(metrics["accuracy"]) > 0.6
    assert table.num_present() == present   # evaluation admits no key
    with pytest.raises(NotImplementedError, match="unbounded key domain"):
        w.evaluate((ids, y))


def test_cli_runs_fm_with_sparse_set_on_the_presets_data(capsys):
    """``cli run fm --set sparse=true`` keeps the preset's data generator, as
    the reference's CLI does: its ids start at 0, the hash table's reserved
    key, so some keys are refused and counted."""
    import json

    from harmony_tpu_torch import cli

    assert cli.main(["run", "fm", "--device", "cpu", "--epochs", "1", "--batches", "2",
                     "--set", "sparse=true", "--set", "vocab_size=256",
                     "--data", "vocab_size=256", "--data", "n=256"]) == 0
    (worker,) = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "result"]["workers"].values()
    assert all(np.isfinite(worker["batch_losses"])) and len(worker["batch_losses"]) == 2
    assert worker["overflow_count"] > 0
