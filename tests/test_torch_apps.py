"""The BASELINE config-4 apps (MLR, NMF, LDA) against harmony_tpu on the CPU.

The same numpy data, tables and batches go through the JAX trainers and the
port's. Tolerances:

* Data generators, table schemas, seeded initial tables, LDA's topic draws and
  count deltas, and the local tables: exact (numpy draws, integer arithmetic,
  jax's threefry bits, integer-valued f32 sums).
* MLR's and NMF's losses and deltas: both products take bf16-rounded operands
  (exact f32 products) and sum in f32 in another order, as do the softmax and
  the loss means: 1e-5 relative and absolute, several f32 ulps at these widths.
* LDA's log-likelihood: a mean of f32 logits whose logs may round differently
  in the last bit: 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.apps import lda as jax_lda
from harmony_tpu.apps import mlr as jax_mlr
from harmony_tpu.apps import nmf as jax_nmf
from harmony_tpu.config.params import TrainerParams as JaxTrainerParams
from harmony_tpu.dolphin import TrainerContext as JaxTrainerContext
from harmony_tpu.dolphin import TrainingDataProvider as JaxData
from harmony_tpu.dolphin import WorkerTasklet as JaxWorker
from harmony_tpu.parallel import build_mesh
from harmony_tpu.table import DenseTable as JaxDenseTable
from harmony_tpu.table import TableSpec as JaxTableSpec
from harmony_tpu_torch.apps import lda, mlr, nmf
from harmony_tpu_torch.config.params import TrainerParams
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.trainer import TrainerContext
from harmony_tpu_torch.dolphin.worker import WorkerTasklet
from harmony_tpu_torch.table.table import DenseTable, TableSpec

RTOL = ATOL = 1e-5

MLR = dict(num_classes=8, num_features=128, features_per_partition=32, step_size=0.5,
           decay_rate=0.5, decay_period=2)
NMF = dict(num_rows=32, num_cols=48, rank=8, step_size=0.01)
LDA = dict(vocab_size=64, num_topics=8, num_docs=32, max_doc_len=16)


def _data(app, seed=0):
    if app == "mlr":
        return mlr.make_synthetic(128, MLR["num_features"], MLR["num_classes"], seed=seed)
    if app == "nmf":
        return nmf.make_synthetic(NMF["num_rows"], NMF["num_cols"], NMF["rank"], seed=seed)
    return lda.make_synthetic(LDA["num_docs"], LDA["vocab_size"], LDA["num_topics"], 16,
                              seed=seed)


@pytest.mark.parametrize("app,jfn,args", [
    ("mlr", jax_mlr.make_synthetic, (300, 64, 5)),
    ("nmf", jax_nmf.make_synthetic, (40, 24, 4)),
    ("lda", jax_lda.make_synthetic, (40, 100, 5, 12)),
])
def test_make_synthetic_is_byte_identical(app, jfn, args):
    mine = {"mlr": mlr, "nmf": nmf, "lda": lda}[app].make_synthetic(*args, seed=3)
    for a, b in zip(jfn(*args, seed=3), mine):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


def _pairs():
    return {"mlr": (jax_mlr.MLRTrainer(**MLR), mlr.MLRTrainer(**MLR)),
            "nmf": (jax_nmf.NMFTrainer(**NMF), nmf.NMFTrainer(**NMF)),
            "lda": (jax_lda.LDATrainer(**LDA), lda.LDATrainer(**LDA))}


@pytest.mark.parametrize("app", ["mlr", "nmf", "lda"])
def test_table_schemas_match(app):
    jt, tt = _pairs()[app]
    fns = ["model_table_config"] + (["local_table_config"] if tt.uses_local_table else [])
    for fn in fns:
        a, b = getattr(jt, fn)(), getattr(tt, fn)()
        for field in ("table_id", "capacity", "value_shape", "num_blocks", "is_ordered",
                      "update_fn", "dtype"):
            assert getattr(b, field) == getattr(a, field), (fn, field)
    for attr in ("pull_mode", "uses_local_table", "objective_metric", "epoch_hook_windowable"):
        assert getattr(tt, attr) == getattr(jt, attr), attr


def test_mlr_compute_and_evaluate_match():
    jt, tt = _pairs()["mlr"]
    x, y = _data("mlr")
    x, y = x[:32], y[:32]
    cap = tt.model_table_config().capacity
    model = np.random.default_rng(1).normal(scale=0.1, size=(cap, 32)).astype(np.float32)
    jd, jm = jax.jit(jt.compute)(jnp.asarray(model), (jnp.asarray(x), jnp.asarray(y)),
                                 {"lr": jnp.asarray(0.5, jnp.float32)})
    td, tm = tt.compute(torch.as_tensor(model), (torch.as_tensor(x), torch.as_tensor(y)),
                        {"lr": torch.tensor(0.5)})
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL, atol=ATOL)
    je = jax.jit(jt.evaluate)(jnp.asarray(model), (jnp.asarray(x), jnp.asarray(y)))
    te = tt.evaluate(torch.as_tensor(model), (torch.as_tensor(x), torch.as_tensor(y)))
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(te[k]), float(je[k]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("start", [0, 3])
def test_mlr_decay_schedule_matches(start):
    jt, tt = _pairs()["mlr"]
    lrs = []
    for t in (jt, tt):
        t.on_training_start(None, start)
        seq = [t.hyperparams()["lr"]]
        for e in range(start, start + 6):
            t.on_epoch_finished(None, e)
            seq.append(t.hyperparams()["lr"])
        lrs.append(seq)
    assert lrs[0] == lrs[1]


def _jax_tables(jt, mesh):
    model = JaxDenseTable(JaxTableSpec(jt.model_table_config()), mesh)
    local = JaxDenseTable(JaxTableSpec(jt.local_table_config()), mesh)
    return model, local


def _torch_tables(tt):
    return (DenseTable(TableSpec(tt.model_table_config()), "cpu"),
            DenseTable(TableSpec(tt.local_table_config()), "cpu"))


@pytest.mark.parametrize("app", ["nmf", "lda"])
def test_global_init_is_byte_identical(app):
    jt, tt = _pairs()[app]
    jm, jl = _jax_tables(jt, build_mesh(jax.devices()[:1]))
    tm, tl = _torch_tables(tt)
    jt.init_global_settings(JaxTrainerContext(params=JaxTrainerParams(), model_table=jm,
                                              local_table=jl))
    tt.init_global_settings(TrainerContext(params=TrainerParams(), model_table=tm,
                                           local_table=tl))
    for j, t in ((jm, tm), (jl, tl)):
        assert t.array.dtype == getattr(torch, str(np.asarray(j.array).dtype))
        np.testing.assert_array_equal(t.array.numpy(), np.asarray(j.array))


def test_nmf_compute_with_local_matches():
    jt, tt = _pairs()["nmf"]
    rows, x = _data("nmf")
    rng = np.random.default_rng(4)
    model = rng.uniform(0, 0.5, (NMF["num_cols"], NMF["rank"])).astype(np.float32)
    local = rng.uniform(0, 0.5, (NMF["num_rows"], NMF["rank"])).astype(np.float32)
    batch = (rows[8:20], x[8:20])
    jd, jl, jm = jax.jit(jt.compute_with_local)(jnp.asarray(model), jnp.asarray(local),
                                                tuple(map(jnp.asarray, batch)),
                                                {"lr": jnp.asarray(0.01, jnp.float32)})
    td, tl, tm = tt.compute_with_local(torch.as_tensor(model), torch.as_tensor(local),
                                       tuple(map(torch.as_tensor, batch)),
                                       {"lr": torch.tensor(0.01)})
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tl.numpy()[:8], local[:8])     # rows outside the batch
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL)


def test_lda_compute_with_local_draws_as_jax():
    """Two steps from the unset state: the first assigns every token, the second
    samples against those counts. Draws, local tables and count deltas exact."""
    jt, tt = _pairs()["lda"]
    doc, tokens, seeds = _data("lda")
    tokens[3, 10:] = -1                                   # padding
    model = np.zeros((LDA["vocab_size"] + 1, LDA["num_topics"]), np.float32)
    local = np.full((LDA["num_docs"], 16), -1, np.int32)
    jstep = jax.jit(jt.compute_with_local)
    for epoch in (0, 1):
        batch = (doc[:16], tokens[:16], seeds[:16])
        jd, jl, jm = jstep(jnp.asarray(model), jnp.asarray(local), tuple(map(jnp.asarray, batch)),
                           {"epoch": jnp.asarray(float(epoch), jnp.float32)})
        td, tl, tm = tt.compute_with_local(torch.as_tensor(model), torch.as_tensor(local),
                                           tuple(map(torch.as_tensor, batch)),
                                           {"epoch": torch.tensor(float(epoch))})
        assert tl.dtype == torch.int32
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(float(tm["log_likelihood"]), float(jm["log_likelihood"]),
                                   rtol=RTOL)
        assert (tl.numpy()[3, 10:] == -1).all() and (tl.numpy()[:16, :10] >= 0).all()
        model, local = model + td.numpy(), tl.numpy()
    assert model[:-1].sum(axis=0).tolist() == model[-1].tolist()  # summary = sum of words


@pytest.mark.parametrize("app", ["nmf", "lda"])
def test_worker_runs_match_the_jax_worker(app):
    """Two epochs of 4 batches through each package's WorkerTasklet, from each
    trainer's global init: per-epoch primary metrics, and LDA's final
    assignments exactly."""
    jt, tt = _pairs()[app]
    arrays = list(_data(app, seed=1))
    jm, jl = _jax_tables(jt, build_mesh(jax.devices()[:1]))
    jres = JaxWorker(app, JaxTrainerContext(
        params=JaxTrainerParams(num_epochs=2, num_mini_batches=4), model_table=jm,
        local_table=jl), jt, JaxData(arrays, 4), build_mesh(jax.devices()[:1])).run()
    tm, tl = _torch_tables(tt)
    tres = WorkerTasklet(app, TrainerContext(
        params=TrainerParams(num_epochs=2, num_mini_batches=4), model_table=tm,
        local_table=tl), tt, TrainingDataProvider(arrays, 4)).run()
    assert len(tres["batch_losses"]) == 8 and tres["epochs_run"] == jres["epochs_run"] == 2
    np.testing.assert_allclose(tres["losses"], jres["losses"], rtol=1e-4)
    if app == "lda":
        np.testing.assert_array_equal(tl.pull_array().numpy(), np.asarray(jl.pull_array()))
        np.testing.assert_array_equal(tm.pull_array().numpy(), np.asarray(jm.pull_array()))
    else:
        np.testing.assert_allclose(tm.pull_array().numpy(), np.asarray(jm.pull_array()),
                                   rtol=1e-4, atol=1e-6)


def test_nmf_at_the_bench_settings_collapses_in_both_packages():
    """bench.py's NMF (rank 256 over 4,096 columns, step 0.01) at the
    baseline's scale 0.125 (512 rows), 4 epochs of 8 batches through each
    package's WorkerTasklet. The step overshoots (gradients of ~1e4): R grows
    from [0, 0.1) past 1e2, the same rows of L are clamped to zero in both
    (loss: the batch's mean sum of x**2, each epoch's last loss from the
    second on), and the other rows' losses run to 1e12 and beyond. The
    per-epoch losses agree within 1e-4 relative; the factors, past a chaotic
    step, within 1e-3 relative to max(1, |value|)."""
    params = dict(num_rows=512, num_cols=4096, rank=256, step_size=0.01)
    jt, tt = jax_nmf.NMFTrainer(**params), nmf.NMFTrainer(**params)
    arrays = list(nmf.make_synthetic(512, 4096, 256))
    jm, jl = _jax_tables(jt, build_mesh(jax.devices()[:1]))
    jres = JaxWorker("nmf", JaxTrainerContext(
        params=JaxTrainerParams(num_epochs=4, num_mini_batches=8), model_table=jm,
        local_table=jl), jt, JaxData(arrays, 8), build_mesh(jax.devices()[:1])).run()
    tm, tl = _torch_tables(tt)
    tres = WorkerTasklet("nmf", TrainerContext(
        params=TrainerParams(num_epochs=4, num_mini_batches=8), model_table=tm,
        local_table=tl), tt, TrainingDataProvider(arrays, 8)).run()
    np.testing.assert_allclose(tres["losses"], jres["losses"], rtol=1e-4)
    last_batch = arrays[1][-64:]
    plateau = float(np.mean(np.sum(last_batch * last_batch, axis=-1)))
    np.testing.assert_allclose(tres["losses"][1:], plateau, rtol=1e-5)
    assert tres["losses"][0] < plateau
    for mine, ref in ((tm, jm), (tl, jl)):
        got, want = mine.pull_array().numpy(), np.asarray(ref.pull_array())
        assert np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))) <= 1e-3
    assert np.asarray(jm.pull_array()).max() > 1e2
    zero_rows = ~tl.pull_array().numpy().any(axis=1)
    np.testing.assert_array_equal(zero_rows, ~np.asarray(jl.pull_array()).any(axis=1))
    assert zero_rows.mean() >= 0.5


def test_sparse_lda_is_not_ported():
    with pytest.raises(NotImplementedError, match="A.4"):
        lda.LDATrainer(vocab_size=8, num_topics=2, num_docs=4, max_doc_len=4, sparse=True)
    assert lda.MAX_KEY == 2**31 - 3 and lda.LDA_SUMMARY_KEY == jax_lda.LDA_SUMMARY_KEY
    assert (lda.LDA_PAD_KEY, lda.LDA_MAX_WORD_KEY) == (jax_lda.LDA_PAD_KEY,
                                                       jax_lda.LDA_MAX_WORD_KEY)
