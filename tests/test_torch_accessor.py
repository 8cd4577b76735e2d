"""The ModelAccessor family, FusedSparseStep, accessor_async_step and the
push-route autotune, against harmony_tpu on the CPU.

tests/test_accessor.py's and tests/test_sparse_step.py's FusedSparseStep
cases, with the same numpy keys, deltas and batches given to the JAX
accessor (one-device CPU mesh) and to the port's. Tolerances: accessor pulls,
pushes and caches carry integer-valued f32 values, exact in any order of
addition. FusedSparseStep's losses and tables: its SGD compute sums f32 in
another order than XLA, 1e-6 absolute over 12 steps of |values| < 4. Within
the port, fused against unfused and async bound 0 against the synchronous
cycle: bit for bit (the same operations in the same order).
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.config.params import TableConfig as JaxTableConfig
from harmony_tpu.dolphin import ModelAccessor as JaxModelAccessor
from harmony_tpu.dolphin import CachedModelAccessor as JaxCachedAccessor
from harmony_tpu.parallel import build_mesh
from harmony_tpu.table import DenseTable as JaxDenseTable
from harmony_tpu.table import TableSpec as JaxTableSpec
from harmony_tpu_torch.config.params import TableConfig, TrainerParams
from harmony_tpu_torch.dolphin.accessor import (
    CachedModelAccessor,
    ModelAccessor,
    make_accessor,
)
from harmony_tpu_torch.dolphin.worker import (
    AsyncStepDriver,
    FusedSparseStep,
    accessor_async_step,
)
from harmony_tpu_torch.metrics.tracer import Tracer
from harmony_tpu_torch.table import autotune
from harmony_tpu_torch.table.hashtable import DeviceHashTable, HashTableSpec
from harmony_tpu_torch.table.table import DenseTable, TableSpec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FUSED_ATOL = 1e-6


@pytest.fixture()
def mesh1():
    return build_mesh(jax.devices()[:1])


def _cfg(**kw):
    base = dict(table_id="acc", capacity=16, value_shape=(4,), num_blocks=8)
    base.update(kw)
    return base


def _pair(mesh, **kw):
    return (JaxDenseTable(JaxTableSpec(JaxTableConfig(**_cfg(**kw))), mesh),
            DenseTable(TableSpec(TableConfig(**_cfg(**kw))), "cpu"))


# -- the accessors (tests/test_accessor.py) -----------------------------------


def test_model_accessor_pull_push_pull_all_match(mesh1):
    jt, tt = _pair(mesh1, update_fn="add_nonneg")
    ja, ta = JaxModelAccessor(jt), ModelAccessor(tt)
    rng = np.random.default_rng(0)
    for _ in range(3):
        keys = rng.integers(0, 16, 10)
        deltas = rng.integers(-3, 5, (10, 4)).astype(np.float32)
        ja.push(keys, deltas)
        ta.push(keys, deltas)
        np.testing.assert_array_equal(ta.pull(keys), ja.pull(keys))
    np.testing.assert_array_equal(ta.pull_all(), ja.pull_all())
    pull_s, push_s = ta.get_and_reset_times()
    assert pull_s > 0 and push_s > 0
    assert ta.get_and_reset_times() == (0.0, 0.0)


def test_pull_loads_and_caches(mesh1):
    jt, tt = _pair(mesh1)
    ja, ta = (JaxCachedAccessor(jt, refresh_period_sec=0),
              CachedModelAccessor(tt, refresh_period_sec=0))   # no refresher thread
    for acc, t in ((ja, jt), (ta, tt)):
        assert acc.pull([1, 2, 3]).shape == (3, 4)
        t.multi_update([1], np.ones((1, 4), np.float32) * 5)   # another writer
    # stale until a refresh re-pulls the cached keys
    np.testing.assert_array_equal(ta.pull([1])[0], np.zeros(4))
    np.testing.assert_array_equal(ta.pull([1]), ja.pull([1]))
    ja.refresh_now()
    ta.refresh_now()
    np.testing.assert_array_equal(ta.pull([1])[0], np.full(4, 5.0))
    np.testing.assert_array_equal(ta.pull([1, 2]), ja.pull([1, 2]))
    ja.close()
    ta.close()


def test_push_applies_locally_and_remotely(mesh1):
    """Read-your-own-push: the cache sees the push at once, through the
    update fn's apply (add_nonneg clamps), and the table got it too."""
    jt, tt = _pair(mesh1, update_fn="add_nonneg")
    ja, ta = (JaxCachedAccessor(jt, refresh_period_sec=0),
              CachedModelAccessor(tt, refresh_period_sec=0))
    for acc in (ja, ta):
        acc.pull([0, 1])
        acc.push([0, 1], np.asarray([[2] * 4, [-3] * 4], np.float32))
    np.testing.assert_array_equal(ta.pull([0, 1]), [[2] * 4, [0] * 4])
    np.testing.assert_array_equal(ta.pull([0, 1]), ja.pull([0, 1]))
    np.testing.assert_array_equal(tt.get(0), np.full(4, 2.0))
    np.testing.assert_array_equal(tt.multi_get([0, 1]), np.asarray(jt.multi_get([0, 1])))
    ja.close()
    ta.close()


def test_a_refresh_that_raced_a_push_keeps_the_pushed_value():
    """The per-key write version: a refresh whose table read predates a local
    push must not install its (older) value over the pushed one."""
    tt = DenseTable(TableSpec(TableConfig(**_cfg())), "cpu")
    acc = CachedModelAccessor(tt, refresh_period_sec=0)
    acc.pull([3])
    read = threading.Event()
    original = tt.multi_get_or_init

    def slow_read(keys):
        out = original(keys)       # the table before the push
        read.set()
        time.sleep(0.2)
        return out

    tt.multi_get_or_init = slow_read
    t = threading.Thread(target=acc.refresh_now)
    t.start()
    assert read.wait(5.0)
    acc.push([3], np.full((1, 4), 7.0, np.float32))
    t.join(5.0)
    assert not t.is_alive()
    tt.multi_get_or_init = original
    np.testing.assert_array_equal(acc.pull([3])[0], np.full(4, 7.0))
    acc.close()


def test_background_refresh_tracks_writers():
    tt = DenseTable(TableSpec(TableConfig(**_cfg())), "cpu")
    acc = CachedModelAccessor(tt, refresh_period_sec=0.05)
    acc.pull([7])
    tt.multi_update([7], np.ones((1, 4), np.float32) * 3)
    deadline = time.time() + 5.0
    while time.time() < deadline and not (acc.pull([7])[0] == 3.0).all():
        time.sleep(0.05)
    np.testing.assert_array_equal(acc.pull([7])[0], np.full(4, 3.0))
    acc.close()
    assert not acc._refresher.is_alive()


def test_factory_honors_flag():
    tt = DenseTable(TableSpec(TableConfig(**_cfg())), "cpu")
    plain = make_accessor(tt, model_cache_enabled=False)
    cached = make_accessor(tt, model_cache_enabled=True, refresh_period_sec=0)
    assert type(plain) is ModelAccessor
    assert isinstance(cached, CachedModelAccessor)
    cached.close()


def test_an_accessor_over_a_hash_table_admits_on_pull():
    ht = DeviceHashTable(HashTableSpec(TableConfig(
        table_id="h", capacity=64, value_shape=(4,), num_blocks=8, is_ordered=False,
        sparse=True)), "cpu")
    acc = ModelAccessor(ht)
    keys = [12345, 2**30, 7]
    np.testing.assert_array_equal(acc.pull(keys), np.zeros((3, 4)))
    acc.push(keys, np.ones((3, 4), np.float32))
    np.testing.assert_array_equal(acc.pull(keys), np.ones((3, 4)))
    assert ht.num_present() == 3


def test_the_tracer_times_and_resets():
    tr = Tracer(instrument="x")
    with pytest.raises(RuntimeError):
        tr.record()
    tr.start()
    assert tr.record(5, block_on={"a": torch.zeros(2), "b": [torch.ones(1)]}) >= 0
    assert (tr.count, tr.elem_count) == (1, 5) and tr.avg_sec() == tr.total_sec
    tr.reset()
    assert (tr.count, tr.total_sec, tr.instrument) == (0, 0.0, "x")


# -- FusedSparseStep (tests/test_sparse_step.py) --------------------------------


def _emb_cfg(rows=128, width=8):
    return dict(table_id="emb", capacity=rows, value_shape=(width,), num_blocks=16)


def _jax_sgd(rows, targets):
    err = rows - targets
    return -0.1 * err, {"loss": jnp.mean(jnp.sum(err * err, -1))}


def _sgd(rows, targets):
    err = rows - targets
    return -0.1 * err, {"loss": torch.mean(torch.sum(err * err, -1))}


def _emb_batches(rows=128, width=8, n=12, batch=16, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, rows, batch).astype(np.int32),
             rng.normal(size=(batch, width)).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("route", ["scatter", "mxu", "sparse"])
def test_fused_sparse_step_matches_the_jax_step_and_the_accessor_loop(mesh1, route,
                                                                      monkeypatch):
    """run_batches against the JAX FusedSparseStep (tolerance), and against
    the port's host-driven pull -> compute -> push loop on the same route
    (bit for bit)."""
    from harmony_tpu.dolphin.worker import FusedSparseStep as JaxFused

    batches = _emb_batches()
    jt = JaxDenseTable(JaxTableSpec(JaxTableConfig(**_emb_cfg())), mesh1)
    jl = [float(a["loss"]) for a in JaxFused(jt, _jax_sgd, push_via=route).run_batches(batches)]

    monkeypatch.setenv("HARMONY_PUSH_VIA", route)   # the port's push_via, both loops
    t1 = DenseTable(TableSpec(TableConfig(**_emb_cfg())), "cpu")
    fs = ModelAccessor(t1).fused_step(_sgd)
    assert fs.push_route == route
    auxes = fs.run_batches(batches)
    fl = [float(a["loss"]) for a in auxes]
    np.testing.assert_allclose(fl, jl, rtol=0, atol=FUSED_ATOL)
    np.testing.assert_allclose(t1.pull_array().numpy(), np.asarray(jt.pull_array()),
                               rtol=0, atol=FUSED_ATOL)

    t0 = DenseTable(TableSpec(TableConfig(**_emb_cfg())), "cpu")
    acc = ModelAccessor(t0)
    ul = []
    for keys, tgt in batches:
        delta, aux = _sgd(torch.as_tensor(acc.pull(keys)), torch.as_tensor(tgt))
        acc.push(keys, delta.numpy())
        ul.append(float(aux["loss"]))
    assert fl == ul
    assert torch.equal(t1.pull_array(), t0.pull_array())


def test_fused_sparse_step_charges_comp_only():
    t = DenseTable(TableSpec(TableConfig(**_emb_cfg())), "cpu")
    acc = ModelAccessor(t)
    fs = acc.fused_step(_sgd, signature=("emb-sgd", 1))
    keys, tgt = _emb_batches(n=1)[0]
    fs.step(keys, tgt)
    assert acc.get_and_reset_times() == (0.0, 0.0)   # no separable phases
    assert fs.comp_tracer.count == 1 and fs.comp_tracer.elem_count == 16


def test_fused_step_donates_the_table_buffer():
    """donate=True updates the storage in place; donate=False commits a new
    tensor and leaves the pre-step one unchanged."""
    keys, tgt = _emb_batches(n=1)[0]
    t = DenseTable(TableSpec(TableConfig(**_emb_cfg())), "cpu")
    before, snapshot = t.array, t.array.clone()
    FusedSparseStep(t, _sgd).step(keys, tgt)
    assert t.array is before and not torch.equal(before, snapshot)

    t2 = DenseTable(TableSpec(TableConfig(**_emb_cfg())), "cpu")
    before2, snapshot2 = t2.array, t2.array.clone()
    FusedSparseStep(t2, _sgd, donate=False).step(keys, tgt)
    assert t2.array is not before2 and torch.equal(before2, snapshot2)
    assert torch.equal(t2.array, t.array)
    assert t2.data_version == t.data_version == 1


def test_fused_step_never_writes_its_operands():
    from harmony_tpu_torch.data import devcache

    t = DenseTable(TableSpec(TableConfig(**_emb_cfg())), "cpu")
    fs = FusedSparseStep(t, _sgd)
    staged = fs._stage(_emb_batches(n=1)[0])
    copies = tuple(a.clone() for a in staged)
    devcache.put(("sparse-step-test", 0), staged)
    for _ in range(3):
        fs.step(*staged)
    for a, b in zip(devcache.get(("sparse-step-test", 0)), copies):
        assert torch.equal(a, b)
    devcache.clear()


def test_run_batches_surfaces_a_producer_failure():
    t = DenseTable(TableSpec(TableConfig(**_emb_cfg())), "cpu")
    fs = FusedSparseStep(t, _sgd)

    def batches():
        yield _emb_batches(n=1)[0]
        raise ValueError("bad batch")

    with pytest.raises(ValueError, match="bad batch"):
        fs.run_batches(batches())
    assert not any(th.name == "fused-sparse-stage" for th in threading.enumerate())


@pytest.mark.parametrize("maker", ["fused", "async"])
def test_the_host_driven_steps_reject_hash_tables(maker):
    ht = DeviceHashTable(HashTableSpec(TableConfig(
        table_id="h", capacity=64, value_shape=(4,), num_blocks=8, is_ordered=False,
        sparse=True)), "cpu")
    with pytest.raises(TypeError, match="hash|DenseTable"):
        if maker == "fused":
            FusedSparseStep(ht, _sgd)
        else:
            ModelAccessor(ht).async_step(lambda m, x: m * 0)
    with pytest.raises(TypeError, match="DenseTable"):
        accessor_async_step(object(), lambda m: m)


# -- accessor_async_step (tests/test_async_step.py) ------------------------------


def _marks(bound, **kw):
    """An add table whose deltas do not depend on the model: staleness cannot
    change the sum, so the fence's result is exact."""
    table = DenseTable(TableSpec(TableConfig(table_id="fence", capacity=8, value_shape=(4,),
                                             num_blocks=8)), "cpu")

    def compute(model, amount):
        return torch.ones_like(model) * amount, {"amount": amount}

    return table, ModelAccessor(table).async_step(compute, staleness_bound=bound, **kw)


def test_async_bound0_is_bit_identical_to_the_synchronous_cycle():
    """A model-dependent compute: bound 0 is the synchronous pull_all ->
    compute -> push_all cycle, bit for bit, with a bare delta (no metrics)."""
    rng = np.random.default_rng(3)
    targets = [torch.as_tensor(rng.normal(size=(16, 3)).astype(np.float32)) for _ in range(6)]

    def compute(model, target):
        return -0.3 * (model - target)

    def table():
        t = DenseTable(TableSpec(TableConfig(table_id="a", capacity=16, value_shape=(3,),
                                             num_blocks=4)), "cpu")
        t.write_all(rng.normal(size=(16, 3)).astype(np.float32) * 0 + 0.5)
        return t

    ta = table()
    drv = accessor_async_step(ta, compute, staleness_bound=0, signature=("a", 0))
    assert isinstance(drv, AsyncStepDriver)
    try:
        for tgt in targets:
            assert drv.submit(tgt) == {}
        drv.drain()
    finally:
        drv.shutdown()
    tb = table()
    spec = tb.spec
    for tgt in targets:
        tb.apply_step(lambda arr: (spec.push_all(arr, compute(spec.pull_all(arr).clone(), tgt)),
                                   None))
    assert torch.equal(ta.pull_array(), tb.pull_array())
    st = drv.staleness_stats()
    assert (st["max_lag"], st["applied"], st["submitted"]) == (0, 6, 6)


def test_async_bound_holds_and_the_fence_is_exact():
    table, drv = _marks(bound=2)
    try:
        for _ in range(8):
            drv.submit(torch.tensor(1.0))
        drv.drain()
        drv.drain()   # re-entrant
    finally:
        drv.shutdown()
    st = drv.staleness_stats()
    assert st["max_lag"] <= 2 and st["applied"] == st["submitted"] == 8
    assert torch.equal(table.pull_array(), torch.full((8, 4), 8.0))


# -- the push-route autotune ----------------------------------------------------


def _push_spec(capacity=4096, nkeys=None):
    return TableSpec(TableConfig(table_id="at", capacity=capacity, value_shape=(4,),
                                 num_blocks=16, is_ordered=False))


def test_autotune_keeps_the_static_gate_on_the_cpu():
    autotune.reset()
    spec = _push_spec()
    cpu = torch.device("cpu")
    assert autotune.choose_push_route(spec, cpu, 64) == "mxu"       # >= max(32, 4096 // 256)
    assert autotune.choose_push_route(spec, cpu, 8) == "scatter"
    assert autotune.measurements() == {}
    minspec = TableSpec(TableConfig(table_id="m", capacity=64, value_shape=(4,),
                                    update_fn="min"))
    assert autotune.choose_push_route(minspec, cpu, 64, timer=lambda fn: 0.0) == "scatter"


def test_autotune_measures_each_arm_and_caches_per_signature():
    autotune.reset()
    spec = _push_spec()
    cpu = torch.device("cpu")
    table = DenseTable(spec, cpu)
    before = table.array.clone()
    calls = []
    times = iter([2.0, 1.0, 1.0, 3.0])

    def timer(fn):
        fn()                       # a push into a copy of the table
        calls.append(1)
        return next(times)

    assert autotune.choose_push_route(spec, cpu, 64, table=table, timer=timer) == "sparse"
    assert autotune.choose_push_route(spec, cpu, 64, table=table, timer=timer) == "sparse"
    assert len(calls) == 2         # the second call hit the cache
    assert autotune.choose_push_route(spec, cpu, 128, table=table, timer=timer) == "mxu"
    assert len(calls) == 4
    meas = autotune.measurements()
    assert len(meas) == 2
    assert {tuple(m) for m in meas.values()} == {("mxu_ms", "sparse_ms")}
    assert torch.equal(table.array, before)   # the live table never changed
    autotune.reset()
    assert autotune.measurements() == {}


def test_autotune_does_not_hide_a_failing_arm():
    autotune.reset()

    def timer(fn):
        raise RuntimeError("kernel failed to launch")

    with pytest.raises(RuntimeError, match="launch"):
        autotune.choose_push_route(_push_spec(), torch.device("cpu"), 64, timer=timer)
    assert autotune.measurements() == {}


def test_the_worker_resolves_mxu_auto_through_the_autotune(monkeypatch):
    """A keyed job on a forced mxu_auto route resolves it once, at its own
    push size (the batch's keys plus the tail rows), before the first step."""
    from harmony_tpu_torch.apps import widedeep
    from harmony_tpu_torch.dolphin.data import TrainingDataProvider
    from harmony_tpu_torch.dolphin.trainer import TrainerContext
    from harmony_tpu_torch.dolphin.worker import WorkerTasklet

    seen = []

    def fake(spec, device, nkeys, table=None, timer=None):
        seen.append(nkeys)
        return "sparse"

    monkeypatch.setenv("HARMONY_PUSH_VIA", "mxu_auto")
    monkeypatch.setattr(autotune, "choose_push_route", fake)
    tr = widedeep.FMTrainer(vocab_size=64, num_slots=4, emb_dim=4)
    table = DenseTable(TableSpec(tr.model_table_config()), "cpu")
    arrays = list(widedeep.make_synthetic(64, 64, 4, seed=1))
    res = WorkerTasklet("at", TrainerContext(params=TrainerParams(num_epochs=1,
                                                                  num_mini_batches=2),
                                             model_table=table),
                        tr, TrainingDataProvider(arrays, 2)).run()
    assert seen == [32 * 4 + 1]
    assert res["push_route"] == "sparse"


def test_autotune_keeps_the_incumbent_unless_the_other_arm_wins_by_the_margin():
    """The arms are one kernel pair: mxu stays unless sparse is faster by more
    than MARGIN, and stays when an arm could not be measured."""
    spec, cpu = _push_spec(), torch.device("cpu")
    for nkeys, (mxu_ms, sparse_ms), route in (
            (64, (1.0, 0.97), "mxu"),
            (65, (1.0, 1.0), "mxu"),
            (66, (1.0, 0.9), "sparse"),
            (67, (None, 0.5), "mxu"),
            (68, (0.5, None), "mxu")):
        autotune.reset()
        times = iter([mxu_ms, sparse_ms])
        assert autotune.choose_push_route(spec, cpu, nkeys,
                                          timer=lambda fn: next(times)) == route, nkeys
        (meas,) = autotune.measurements().values()
        assert meas == {"mxu_ms": mxu_ms, "sparse_ms": sparse_ms}
    autotune.reset()


def test_autotune_retries_a_sleep_that_ended_before_the_host_had_enqueued():
    tries = []

    def attempt(outcomes):
        def run(cycles):
            tries.append(cycles)
            return outcomes[len(tries) - 1]
        return run

    c = autotune._SLEEP_CYCLES
    assert autotune._behind_short_sleeps(attempt([None, None, 0.25, 9.0])) == 0.25
    assert tries == [c, 4 * c, 16 * c]
    tries.clear()
    assert autotune._behind_short_sleeps(
        attempt([None] * autotune._SLEEP_TRIES)) is None
    assert tries == [c * 4 ** i for i in range(autotune._SLEEP_TRIES)]


_TENANT_IN_STEP = threading.Event()
_MEASURED = threading.Event()


def _gated_mlr(**kw):
    """The port's MLR trainer whose first step holds until the other job's
    autotune has measured, so the measurement runs while this job is live."""
    from harmony_tpu_torch.apps.mlr import MLRTrainer

    class GatedMLR(MLRTrainer):
        def compute(self, model, batch, hyper):
            if not _TENANT_IN_STEP.is_set():
                _TENANT_IN_STEP.set()
                assert _MEASURED.wait(60), "the autotune never measured"
            return super().compute(model, batch, hyper)

    return GatedMLR(**kw)


def test_autotune_inside_a_live_jobserver_leaves_the_other_tenant_alone(monkeypatch):
    """A keyed job resolves mxu_auto by a measurement (a stub timer running
    the real pushes into a copy) while another job of the same JobServer is
    in its step: each job's losses equal those of the job run alone."""
    from harmony_tpu_torch.config.params import JobConfig
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    real = autotune.choose_push_route
    seen = []

    def measured(spec, device, nkeys, table=None, timer=None):
        times = iter([2.0, 1.0])   # mxu, then sparse

        def arm(fn):
            assert _TENANT_IN_STEP.wait(60)
            for _ in range(3):
                fn()                 # the real pushes, into a copy of the table
            return next(times)

        seen.append(nkeys)
        try:
            return real(spec, device, nkeys, table=table, timer=arm)
        finally:
            _MEASURED.set()

    def config(app, gated):
        if app == "mlr":
            return JobConfig(
                job_id="tenant", app_type="dolphin",
                trainer=(f"{__name__}:_gated_mlr" if gated
                         else "harmony_tpu_torch.apps.mlr:MLRTrainer"),
                params=TrainerParams(num_epochs=2, num_mini_batches=2, app_params={
                    "num_classes": 4, "num_features": 32, "features_per_partition": 8,
                    "step_size": 0.5}),
                num_workers=1,
                user={"data_fn": "harmony_tpu_torch.apps.mlr:make_synthetic",
                      "data_args": {"n": 64, "num_features": 32, "num_classes": 4}})
        return JobConfig(
            job_id="tuned", app_type="dolphin",
            trainer="harmony_tpu_torch.apps.widedeep:FMTrainer",
            params=TrainerParams(num_epochs=2, num_mini_batches=2, app_params={
                "vocab_size": 64, "num_slots": 4, "emb_dim": 4}),
            num_workers=1,
            user={"data_fn": "harmony_tpu_torch.apps.widedeep:make_synthetic",
                  "data_args": {"n": 64, "vocab_size": 64, "num_slots": 4, "seed": 1}})

    def run(jobs):
        server = JobServer(1, device_pool=DevicePool([torch.device("cpu")]))
        server.start()
        try:
            futures = [server.submit(config(app, gated)) for app, gated in jobs]
            return [next(iter(f.result(timeout=120)["workers"].values())) for f in futures]
        finally:
            server.shutdown()

    monkeypatch.setenv("HARMONY_PUSH_VIA", "mxu_auto")
    (alone_tenant,) = run([("mlr", False)])
    autotune.reset()
    (alone_tuned,) = run([("fm", False)])       # the CPU's static gate
    assert alone_tuned["push_route"] == "mxu"

    monkeypatch.setattr(autotune, "choose_push_route", measured)
    _TENANT_IN_STEP.clear()
    _MEASURED.clear()
    autotune.reset()
    try:
        tenant, tuned = run([("mlr", True), ("fm", False)])
    finally:
        autotune.reset()
    assert _TENANT_IN_STEP.is_set() and _MEASURED.is_set() and seen == [32 * 4 + 1]
    assert tuned["push_route"] == "sparse"     # 1.0 ms beats 2.0 by more than MARGIN
    assert tenant["batch_losses"] == alone_tenant["batch_losses"]
    np.testing.assert_allclose(tuned["batch_losses"], alone_tuned["batch_losses"],
                               rtol=0, atol=1e-6)
