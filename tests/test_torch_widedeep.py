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
    with pytest.raises(NotImplementedError):
        torch_wd.FMTrainer(vocab_size=8, num_slots=2, sparse=True)
