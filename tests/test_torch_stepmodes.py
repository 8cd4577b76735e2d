"""The port's step modes and epoch windows (harmony_tpu_torch/dolphin/worker.py)
on the CPU, within the port and against harmony_tpu's WorkerTasklet.

Tolerances:

* Within the port, fused, unfused and async-bound-0 runs do the same float32
  operations on the same values in the same order (only the phase boundaries
  and where the model lives between them differ), so their losses and final
  tables are compared bit for bit; so are runs with windows against forced
  one-epoch windows, and a table before and after a comm probe.
* Against the JAX unfused worker (PERF.md §2): per-epoch losses within
  1e-4·max(1, |loss|) for MLR and NMF (f32 sums in another order); LDA's
  log-likelihood within 1e-4 relative and its tables exact, as in
  tests/test_torch_apps.py.
* Window sequences: equal, element for element.
"""
import threading
import time

import jax
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
from harmony_tpu_torch.apps import lda, mlr, nmf, widedeep
from harmony_tpu_torch.config.params import TableConfig, TrainerParams
from harmony_tpu_torch.data import devcache
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.trainer import TrainerContext
from harmony_tpu_torch.dolphin.worker import AsyncStepDriver, WorkerTasklet, _UnfusedStep
from harmony_tpu_torch.table.table import DenseTable, TableSpec

CPU = torch.device("cpu")
APPS = {
    "mlr": (dict(num_classes=4, num_features=16, features_per_partition=8,
                 step_size=0.5, decay_period=2),
            lambda m: m.make_synthetic(64, 16, 4, seed=1)),
    "nmf": (dict(num_rows=32, num_cols=24, rank=4, seed=2),
            lambda m: m.make_synthetic(32, 24, 4, seed=2)),
    "lda": (dict(vocab_size=50, num_topics=5, num_docs=32, max_doc_len=10),
            lambda m: m.make_synthetic(32, 50, 5, 10, seed=3)),
}
TRAINERS = {"mlr": "MLRTrainer", "nmf": "NMFTrainer", "lda": "LDATrainer"}


@pytest.fixture(autouse=True)
def _empty_caches():
    devcache.clear()
    devcache.host_data.clear()
    yield
    devcache.clear()
    devcache.host_data.clear()


def _port(app, trainer=None):
    kw, data = APPS[app]
    module = {"mlr": mlr, "nmf": nmf, "lda": lda}[app]
    return trainer or getattr(module, TRAINERS[app])(**kw), list(data(module))


def _run(trainer, arrays, *, epochs=3, batches=4, shuffle=False, **params):
    table = DenseTable(TableSpec(trainer.model_table_config()), CPU)
    local = (DenseTable(TableSpec(trainer.local_table_config()), CPU)
             if trainer.uses_local_table else None)
    ctx = TrainerContext(params=TrainerParams(num_epochs=epochs, num_mini_batches=batches,
                                              **params),
                         model_table=table, local_table=local)
    worker = WorkerTasklet("w", ctx, trainer,
                           TrainingDataProvider(arrays, batches, shuffle_each_epoch=shuffle,
                                                seed=9))
    return worker.run(), table, local, worker


def _tables_equal(a, b):
    for x, y in zip(a, b):
        if x is not None:
            assert torch.equal(x.array, y.array)


MODES = {"unfused": dict(fused_step=False),
         "async0": dict(async_step=True, staleness_bound=0),
         "unfused_no_prefetch": dict(fused_step=False, input_prefetch=False)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("app", ["mlr", "nmf", "lda"])
def test_step_modes_are_bit_identical(app, mode):
    """tests/test_sparse_step.py:148-198 and tests/test_async_step.py:69-106,
    on the port: fused, unfused and async bound 0 give the same losses and
    tables bit for bit."""
    fused, ft, fl, _ = _run(*_port(app))
    other, ot, ol, w = _run(*_port(app), **MODES[mode])
    assert other["step_mode"] == ("async" if mode == "async0" else "unfused")
    assert fused["step_mode"] == "fused"
    assert other["batch_losses"] == fused["batch_losses"]
    assert other["losses"] == fused["losses"]
    _tables_equal((ft, fl), (ot, ol))
    if mode == "async0":
        st = w._step.staleness_stats()
        assert st["max_lag"] == 0 and st["applied"] == st["submitted"] == 12


def _jax_unfused(app, epochs=3, batches=4):
    kw, data = APPS[app]
    module = {"mlr": jax_mlr, "nmf": jax_nmf, "lda": jax_lda}[app]
    trainer = getattr(module, TRAINERS[app])(**kw)
    mesh = build_mesh(jax.devices()[:1])
    table = JaxDenseTable(JaxTableSpec(trainer.model_table_config()), mesh)
    local = (JaxDenseTable(JaxTableSpec(trainer.local_table_config()), mesh)
             if trainer.uses_local_table else None)
    ctx = JaxTrainerContext(params=JaxTrainerParams(num_epochs=epochs,
                                                    num_mini_batches=batches,
                                                    fused_step=False),
                            model_table=table, local_table=local)
    worker = JaxWorker(app, ctx, trainer, JaxData(list(data(module)), batches), mesh)
    return worker.run(), table, local


@pytest.mark.parametrize("app", ["mlr", "nmf", "lda"])
def test_unfused_matches_the_jax_unfused_worker(app):
    jres, jt, jl = _jax_unfused(app)
    tres, tt, tl, w = _run(*_port(app), fused_step=False)
    assert tres["epochs_run"] == jres["epochs_run"] == 3
    if app == "lda":
        np.testing.assert_allclose(tres["losses"], jres["losses"], rtol=1e-4)
        np.testing.assert_array_equal(tl.pull_array().numpy(), np.asarray(jl.pull_array()))
        np.testing.assert_array_equal(tt.pull_array().numpy(), np.asarray(jt.pull_array()))
    else:
        got, ref = np.array(tres["losses"]), np.array(jres["losses"])
        assert np.all(np.abs(got - ref) <= 1e-4 * np.maximum(1.0, np.abs(ref))), (got, ref)
    assert set(tres["phase_seconds"]) == {"pull", "comp", "push"}


WD = dict(vocab_size=300, num_slots=4, emb_dim=4, hidden=8)


@pytest.mark.parametrize("route", ["scatter", "mxu", "sparse"])
def test_widedeep_keyed_step_fused_and_unfused_are_bit_identical(route, monkeypatch):
    monkeypatch.setenv("HARMONY_PUSH_VIA", route)
    arrays = list(widedeep.make_synthetic(256, WD["vocab_size"], WD["num_slots"], seed=4))
    fused, ft, _, _ = _run(widedeep.WideDeepTrainer(**WD), arrays)
    unfused, ut, _, w = _run(widedeep.WideDeepTrainer(**WD), arrays, fused_step=False)
    assert unfused["batch_losses"] == fused["batch_losses"]
    assert torch.equal(ut.array, ft.array)
    assert w._step.steps == 12 and w._step.timed_steps == 11


def test_mean_phase_seconds_leave_out_the_first_call():
    calls = []

    def pull(arr):
        calls.append(len(calls))
        time.sleep(0.2 if len(calls) == 1 else 0.0)   # the first call is slow
        return arr

    step = _UnfusedStep(pull, lambda m, b, h: (torch.zeros_like(m), {}),
                        lambda arr, d: arr + d, device=CPU, uses_local=False,
                        keys_push=False)
    for _ in range(3):
        step(torch.ones(4), None, {})
    pull_s, comp_s, push_s = step.mean_phase_seconds()
    assert step.steps == 3 and step.timed_steps == 2
    assert pull_s < 0.05


def test_async_refuses_a_keyed_trainer():
    step = _UnfusedStep(lambda a, b: a, lambda m, b, h: (m, {}), lambda a, b, d: a,
                        device=CPU, uses_local=False, keys_push=True)
    table = DenseTable(TableSpec(TableConfig(table_id="k", capacity=8, value_shape=(2,))), CPU)
    with pytest.raises(ValueError, match="pull_mode='all'"):
        AsyncStepDriver(step, bound=1, model_table=table)
    # a keyed job asking for async keeps the fused step, as in the reference
    arrays = list(widedeep.make_synthetic(64, WD["vocab_size"], WD["num_slots"], seed=4))
    res, _, _, w = _run(widedeep.WideDeepTrainer(**WD), arrays, epochs=1, async_step=True)
    assert res["step_mode"] == "fused" and not isinstance(w._step, AsyncStepDriver)


def _marks_driver(bound, push_delay=0.0):
    """A driver over an add table whose deltas do not depend on the model:
    staleness cannot change the sum, so the fence's result is exact."""
    spec = TableSpec(TableConfig(table_id="fence", capacity=8, value_shape=(4,),
                                 num_blocks=8))
    table = DenseTable(spec, CPU)

    def comp(model, amount, hyper):
        return torch.ones_like(model) * amount, {"amount": amount}

    def push(arr, delta):
        time.sleep(push_delay)   # a stalled comm thread
        return spec.push_all(arr, delta)

    step = _UnfusedStep(spec.pull_all, comp, push, device=CPU, uses_local=False,
                        keys_push=False)
    return table, AsyncStepDriver(step, bound=bound, model_table=table)


def test_the_bound_holds_under_a_stalled_push():
    table, drv = _marks_driver(bound=2, push_delay=0.05)
    try:
        for _ in range(8):
            drv.submit(torch.tensor(1.0), {})
        drv.drain()
    finally:
        drv.shutdown()
    st = drv.staleness_stats()
    assert 1 <= st["max_lag"] <= 2, st
    assert st["applied"] == st["submitted"] == 8
    assert torch.equal(table.pull_array(), torch.full((8, 4), 8.0))


def test_drain_is_reentrant():
    table, drv = _marks_driver(bound=3)
    drv.drain()   # nothing submitted, nothing started: a no-op fence
    drv.submit(torch.tensor(2.0), {})
    drv.drain()
    drv.drain()
    st = drv.staleness_stats()
    assert st["applied"] == st["submitted"] == 1
    drv.shutdown()
    assert not any(t.name.startswith("async-step") for t in threading.enumerate())
    assert torch.equal(table.pull_array(), torch.full((8, 4), 2.0))


def test_a_comm_thread_failure_surfaces_on_drain():
    spec = TableSpec(TableConfig(table_id="boom", capacity=8, value_shape=(4,)))
    table = DenseTable(spec, CPU)

    def push(arr, delta):
        raise RuntimeError("push failed")

    step = _UnfusedStep(spec.pull_all, lambda m, b, h: (m * 0, {}), push, device=CPU,
                        uses_local=False, keys_push=False)
    drv = AsyncStepDriver(step, bound=1, model_table=table)
    drv.submit(None, {})
    with pytest.raises(RuntimeError, match="comm thread failed"):
        drv.drain()
    drv.shutdown()


def test_the_env_overrides_turn_the_knobs(monkeypatch):
    monkeypatch.setenv("HARMONY_FUSED_STEP", "0")
    res, _, _, w = _run(*_port("mlr"), epochs=1)
    assert res["step_mode"] == "unfused" and not w._fused_on
    monkeypatch.setenv("HARMONY_FUSED_STEP", "1")
    res, _, _, w = _run(*_port("mlr"), epochs=1, fused_step=False)
    assert res["step_mode"] == "fused"
    monkeypatch.delenv("HARMONY_FUSED_STEP")
    monkeypatch.setenv("HARMONY_ASYNC_STEP", "1")
    monkeypatch.setenv("HARMONY_STALENESS_BOUND", "3")
    res, _, _, w = _run(*_port("mlr"), epochs=1)
    assert res["step_mode"] == "async" and res["staleness"]["bound"] == 3
    monkeypatch.setenv("HARMONY_ASYNC_STEP", "off")
    monkeypatch.setenv("HARMONY_STALENESS_BOUND", "not-a-number")
    res, _, _, w = _run(*_port("mlr"), epochs=1, async_step=True, staleness_bound=2)
    assert res["step_mode"] == "fused" and w._staleness_bound == 2


class _HookedMLR(mlr.MLRTrainer):
    """Overrides the hook without opting in again: not windowable."""

    def on_epoch_finished(self, ctx, epoch_idx):
        super().on_epoch_finished(ctx, epoch_idx)


class _JaxHookedMLR(jax_mlr.MLRTrainer):
    def on_epoch_finished(self, ctx, epoch_idx):
        super().on_epoch_finished(ctx, epoch_idx)


def _jax_windows(trainer, arrays, params, batches):
    mesh = build_mesh(jax.devices()[:1])
    table = JaxDenseTable(JaxTableSpec(trainer.model_table_config()), mesh)
    local = (JaxDenseTable(JaxTableSpec(trainer.local_table_config()), mesh)
             if trainer.uses_local_table else None)
    worker = JaxWorker("win", JaxTrainerContext(params=params, model_table=table,
                                                local_table=local),
                       trainer, JaxData(arrays, batches), mesh)
    seen = []

    def recorded(epoch, num_epochs):
        w = JaxWorker._epoch_window_len(worker, epoch, num_epochs)
        seen.append(w)
        return w

    worker._epoch_window_len = recorded
    worker.run()
    return seen


@pytest.mark.parametrize("app", ["mlr", "nmf", "lda", "hooked"])
def test_windows_are_the_jax_workers(app):
    """bench.py's trio settings (12 epochs, comm_probe_period 6, 8 batches) at a
    small size: the JAX worker's window sequence, recorded as it runs, is the
    port's; an overridden hook without its own opt-in gets one-epoch
    windows in both."""
    epochs, batches = 12, 8
    if app == "hooked":
        kw, data = APPS["mlr"]
        jax_trainer, port_trainer = _JaxHookedMLR(**kw), _HookedMLR(**kw)
        arrays = list(data(mlr))
    else:
        kw, data = APPS[app]
        jmod = {"mlr": jax_mlr, "nmf": jax_nmf, "lda": jax_lda}[app]
        jax_trainer = getattr(jmod, TRAINERS[app])(**kw)
        port_trainer, arrays = _port(app)
    ref = _jax_windows(jax_trainer, arrays,
                       JaxTrainerParams(num_epochs=epochs, num_mini_batches=batches,
                                        comm_probe_period=6), batches)
    res, _, _, w = _run(port_trainer, arrays, epochs=epochs, batches=batches,
                        comm_probe_period=6)
    assert res["windows"] == ref
    assert ref == ([1] * 12 if app == "hooked" else [8, 4])
    assert res["comm_probe"]["probes"] == 1
    assert len(res["epoch_seconds"]) == len(res["losses"]) == 12


@pytest.mark.parametrize("app", ["mlr", "lda"])
def test_windows_match_one_epoch_windows_bit_for_bit(app):
    """The windowable hooks (MLR's decay, LDA's epoch fold) run between the
    epochs of a window exactly as they run after one-epoch windows."""
    windowed, wt, wl, _ = _run(*_port(app), epochs=10, comm_probe_period=0)
    trainer, arrays = _port(app)
    table = DenseTable(TableSpec(trainer.model_table_config()), CPU)
    local = (DenseTable(TableSpec(trainer.local_table_config()), CPU)
             if trainer.uses_local_table else None)
    worker = WorkerTasklet("one", TrainerContext(
        params=TrainerParams(num_epochs=10, num_mini_batches=4, comm_probe_period=0),
        model_table=table, local_table=local), trainer, TrainingDataProvider(arrays, 4))
    worker.EPOCH_WINDOW = 1
    single = worker.run()
    assert windowed["windows"] == [8, 2] and single["windows"] == [1] * 10
    assert windowed["batch_losses"] == single["batch_losses"]
    _tables_equal((wt, wl), (table, local))


def _negative_zeros(table):
    """Every other stored value set to -0.0."""
    flat = table.array.view(-1)
    flat[::2] = -0.0
    flat[1::2] = torch.linspace(-1, 1, flat[1::2].numel())
    return table.array.clone()


@pytest.mark.parametrize("app", ["mlr", "widedeep"])
def test_a_comm_probe_changes_no_table_byte(app):
    """The probe times PULL and PULL+PUSH of a zero delta. A zero push into
    the live table is not a no-op (-0.0 + 0.0 is +0.0), so the port probes a
    copy: the table's bytes are as they were."""
    if app == "mlr":
        trainer, arrays = _port("mlr")
    else:
        trainer = widedeep.WideDeepTrainer(**WD)
        arrays = list(widedeep.make_synthetic(64, WD["vocab_size"], WD["num_slots"], seed=4))
    table = DenseTable(TableSpec(trainer.model_table_config()), CPU)
    before = _negative_zeros(table)
    worker = WorkerTasklet("probe", TrainerContext(
        params=TrainerParams(num_epochs=1, num_mini_batches=4), model_table=table),
        trainer, TrainingDataProvider(arrays, 4))
    worker._build_step()
    worker._probe_comm()
    assert torch.equal(table.array.view(torch.int32), before.view(torch.int32))
    assert worker._probes == 1 and min(worker._comm_probe_times) >= 0.0
    # the hazard is real: the same zero push into the storage itself flips -0.0
    spec, live = table.spec, before.clone()
    if app == "mlr":
        spec.push_all(live, torch.zeros_like(spec.pull_all(live)))
    else:
        keys = trainer.pull_keys(worker._probe_batch())
        spec.push(live, keys, torch.zeros_like(spec.pull(live, keys)), via="scatter")
    assert not torch.equal(live.view(torch.int32), before.view(torch.int32))
