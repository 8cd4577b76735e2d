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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    """Sparse LDA is ported now: the reference's reserved keys and its hash
    table schema, keyed pulls, a keyed delta, and the summary's mask."""
    jt = jax_lda.LDATrainer(vocab_size=8, num_topics=2, num_docs=4, max_doc_len=4, sparse=True)
    tt = lda.LDATrainer(vocab_size=8, num_topics=2, num_docs=4, max_doc_len=4, sparse=True)
    assert lda.MAX_KEY == 2**31 - 3 and lda.LDA_SUMMARY_KEY == jax_lda.LDA_SUMMARY_KEY
    assert (lda.LDA_PAD_KEY, lda.LDA_MAX_WORD_KEY) == (jax_lda.LDA_PAD_KEY,
                                                       jax_lda.LDA_MAX_WORD_KEY)
    assert tt.pull_mode == jt.pull_mode == "keys"
    assert lda.LDATrainer(vocab_size=8, num_topics=2, num_docs=4, max_doc_len=4).pull_mode == "all"
    tc, jc = tt.model_table_config(), jt.model_table_config()
    for field in ("table_id", "capacity", "value_shape", "num_blocks", "is_ordered",
                  "update_fn", "sparse"):
        assert getattr(tc, field) == getattr(jc, field), field


# -- sparse LDA: topic-word counts in a DeviceHashTable ---------------------------

SPARSE_LDA = dict(LDA, vocab_size=64, sparse=True, slot_budget=256)


def _sparse_lda_data(seed=3, **kw):
    args = dict(num_docs=LDA["num_docs"], vocab_size=LDA["vocab_size"],
                num_topics=LDA["num_topics"], doc_len=16, seed=seed)
    args.update(kw)
    return jax_lda.make_synthetic_sparse(**args)


def test_sparse_lda_data_keys_and_mask_match():
    for a, b in zip(_sparse_lda_data(), lda.make_synthetic_sparse(
            LDA["num_docs"], LDA["vocab_size"], LDA["num_topics"], 16, seed=3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    jt, tt = jax_lda.LDATrainer(**SPARSE_LDA), lda.LDATrainer(**SPARSE_LDA)
    doc, tokens, seeds = _sparse_lda_data()
    tokens[2, 5:] = -1
    tokens[3, 0] = 0                                   # the reserved key: padding
    tokens[3, 1] = lda.LDA_PAD_KEY                     # aliases a reserved row
    batch = (doc[:8], tokens[:8], seeds[:8])
    jk = np.asarray(jt.pull_keys(tuple(map(jnp.asarray, batch))))
    tk = tt.pull_keys(tuple(map(torch.as_tensor, batch)))
    assert tk.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), jk)
    rng = np.random.default_rng(5)
    delta = rng.integers(-2, 3, (len(jk), LDA["num_topics"])).astype(np.float32)
    ok = rng.random(len(jk)) < 0.8
    np.testing.assert_array_equal(
        tt.mask_delta(torch.as_tensor(delta), torch.as_tensor(ok)).numpy(),
        np.asarray(jt.mask_delta(jnp.asarray(delta), jnp.asarray(ok))))


def test_sparse_lda_compute_with_local_draws_as_jax():
    """The keyed layout: a row per token position and the summary row; the
    draws, the local table and the keyed delta exact."""
    jt, tt = jax_lda.LDATrainer(**SPARSE_LDA), lda.LDATrainer(**SPARSE_LDA)
    doc, tokens, seeds = _sparse_lda_data()
    tokens[1, 12:] = -1
    B, L, K = 8, 16, LDA["num_topics"]
    rng = np.random.default_rng(6)
    model = rng.integers(0, 4, (B * L + 1, K)).astype(np.float32)
    model[-1] = model[:-1].sum(axis=0) + 3
    local = rng.integers(-1, K, (LDA["num_docs"], L)).astype(np.int32)
    batch = (doc[:B], tokens[:B], seeds[:B])
    jd, jl, jm = jax.jit(jt.compute_with_local)(
        jnp.asarray(model), jnp.asarray(local), tuple(map(jnp.asarray, batch)),
        {"epoch": jnp.asarray(1.0, jnp.float32)})
    td, tl, tm = tt.compute_with_local(torch.as_tensor(model), torch.as_tensor(local),
                                       tuple(map(torch.as_tensor, batch)),
                                       {"epoch": torch.tensor(1.0)})
    assert td.shape == (B * L + 1, K)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(float(tm["log_likelihood"]), float(jm["log_likelihood"]),
                               rtol=RTOL)


def _sparse_lda_runs(fused, budget=256, vocab=64, doc_len=16):
    from harmony_tpu.table.hashtable import DeviceHashTable as JaxHashTable
    from harmony_tpu.table.hashtable import HashTableSpec as JaxHashSpec
    from harmony_tpu_torch.table.hashtable import DeviceHashTable, HashTableSpec

    kw = dict(SPARSE_LDA, slot_budget=budget, vocab_size=vocab, max_doc_len=doc_len)
    jt, tt = jax_lda.LDATrainer(**kw), lda.LDATrainer(**kw)
    arrays = list(_sparse_lda_data(vocab_size=vocab, doc_len=doc_len))
    mesh = build_mesh(jax.devices()[:1])
    jm = JaxHashTable(JaxHashSpec(jt.model_table_config()), mesh)
    jl = JaxDenseTable(JaxTableSpec(jt.local_table_config()), mesh)
    jres = JaxWorker("slda", JaxTrainerContext(
        params=JaxTrainerParams(num_epochs=2, num_mini_batches=4, fused_step=fused),
        model_table=jm, local_table=jl), jt, JaxData(arrays, 4), mesh).run()
    tm = DeviceHashTable(HashTableSpec(tt.model_table_config()), "cpu")
    tl = DenseTable(TableSpec(tt.local_table_config()), "cpu")
    tres = WorkerTasklet("slda", TrainerContext(
        params=TrainerParams(num_epochs=2, num_mini_batches=4, fused_step=fused),
        model_table=tm, local_table=tl), tt, TrainingDataProvider(arrays, 4)).run()
    return (jres, jm, jl), (tres, tm, tl)


@pytest.mark.parametrize("fused", [True, False])
def test_sparse_lda_worker_runs_match_the_jax_worker(fused):
    """tests/test_sparse_step.py's sparse LDA run in both packages: the slot
    keys and the counts byte for byte, the assignments exactly, the epoch
    log-likelihoods to 1e-5 relative."""
    (jres, jm, jl), (tres, tm, tl) = _sparse_lda_runs(fused)
    assert tres["step_mode"] == ("fused" if fused else "unfused")
    for a, b in zip(jm.state, tm.state):
        assert b.numpy().tobytes() == np.asarray(a).tobytes()
    np.testing.assert_array_equal(tl.pull_array().numpy(), np.asarray(jl.pull_array()))
    np.testing.assert_allclose(tres["losses"], jres["losses"], rtol=RTOL)
    counts = tm.items()
    summary = counts.pop(lda.LDA_SUMMARY_KEY)
    pad = counts.pop(lda.LDA_PAD_KEY, np.zeros_like(summary))
    assert not pad.any()
    np.testing.assert_array_equal(summary, np.sum(list(counts.values()), axis=0))
    assert tres["overflow_count"] == 0


def test_sparse_lda_overflow_is_counted_and_masked_as_the_reference():
    """A table of 2,048 slots for ~3,000 distinct words: the same words are
    refused in both packages, the summary row stays the sum of the admitted
    word rows (mask_delta), and the refused keys are counted the same."""
    (jres, jm, jl), (tres, tm, tl) = _sparse_lda_runs(True, budget=62, vocab=20000,
                                                      doc_len=100)
    for a, b in zip(jm.state, tm.state):
        assert b.numpy().tobytes() == np.asarray(a).tobytes()
    np.testing.assert_array_equal(tl.pull_array().numpy(), np.asarray(jl.pull_array()))
    assert tres["overflow_count"] == tm.overflow_count == jm.overflow_count > 0
    counts = tm.items()
    summary = counts.pop(lda.LDA_SUMMARY_KEY)
    counts.pop(lda.LDA_PAD_KEY, None)
    np.testing.assert_array_equal(summary, np.sum(list(counts.values()), axis=0))


def test_sparse_lda_through_the_jobservers_matches():
    from harmony_tpu.config.params import JobConfig as JaxJobConfig
    from harmony_tpu.jobserver.server import JobServer as JaxJobServer
    from harmony_tpu.parallel.mesh import DevicePool as JaxDevicePool
    from harmony_tpu_torch.config.params import JobConfig
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    def config(package, cls, params):
        return cls(job_id="lda-hash", app_type="dolphin",
                   trainer=f"{package}.apps.lda:LDATrainer",
                   params=params(num_epochs=2, num_mini_batches=4,
                                 app_params=dict(SPARSE_LDA, max_doc_len=16)),
                   num_workers=1,
                   user={"data_fn": f"{package}.apps.lda:make_synthetic_sparse",
                         "data_args": {"num_docs": LDA["num_docs"],
                                       "vocab_size": LDA["vocab_size"],
                                       "num_topics": LDA["num_topics"], "doc_len": 16}})

    ref = JaxJobServer(num_executors=1, device_pool=JaxDevicePool(jax.devices("cpu")[:1]))
    ref.start()
    try:
        ref.submit(config("harmony_tpu", JaxJobConfig, JaxTrainerParams)).result(timeout=120)
        want = [m.loss for m in sorted(ref.metrics.worker_batch_metrics(job_id="lda-hash"),
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
    np.testing.assert_allclose(worker["batch_losses"], want, rtol=RTOL)
    assert worker["overflow_count"] == 0
