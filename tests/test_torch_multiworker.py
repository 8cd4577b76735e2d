"""Multi-worker SSP jobs, TaskUnit admission and shared tables in the port
(harmony_tpu_torch/dolphin/master.py, jobserver/entity.py, runtime/master.py,
dolphin/worker.py) on the CPU, against the reference where it has the same
thing.

* The SSP classes (``MiniBatchController``, ``BatchProgressTracker``,
  ``WorkerStateManager``, ``DispatchTurnstile``) are copies of the
  reference's: each case of ``tests/test_master.py::TestMiniBatchController``
  and ``TestWorkerStateManager`` (and a turnstile case) runs on each module
  and the outcomes are compared exactly.
* AddVector sums are exact: every key holds examples processed x delta.
* A ``force_lockstep`` 2-worker MLR job runs its steps in one fixed order, so
  two runs give the same losses bit for bit; against the reference's same job
  under its JobServer the f32 sums run in another order in the two
  frameworks: within 1e-5 absolute (the losses are ~1).
* C4: under a JobServer a Dolphin worker runs per-batch epochs, a COMP unit
  per batch group; the same worker outside a JobServer runs fused windows;
  both give the same losses bit for bit.

Every thread join and future read is bounded.
"""
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from harmony_tpu.config.params import JobConfig as JaxJobConfig
from harmony_tpu.config.params import TrainerParams as JaxTrainerParams
from harmony_tpu.dolphin import master as ref_master
from harmony_tpu.jobserver.server import JobServer as JaxJobServer
from harmony_tpu.parallel.mesh import DevicePool as JaxDevicePool
from harmony_tpu_torch import cli
from harmony_tpu_torch.apps.addvector import AddVectorTrainer, make_marks
from harmony_tpu_torch.apps.pagerank import PageRankComputation
from harmony_tpu_torch.config.params import JobConfig, TableConfig, TrainerParams
from harmony_tpu_torch.dolphin import master as port_master
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.trainer import TrainerContext
from harmony_tpu_torch.dolphin.worker import WorkerTasklet
from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.pregel.graph import random_graph
from harmony_tpu_torch.pregel.master import PregelMaster
from harmony_tpu_torch.runtime.master import ETMaster
from harmony_tpu_torch.runtime.taskunit import CPU, NET
from harmony_tpu_torch.table.table import DenseTable, TableSpec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TIMEOUT = 120
LOCKSTEP_ATOL = 1e-5


def _join(threads, timeout=10):
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


# -- the SSP classes against the reference ------------------------------------


def _slack_blocks_fast_worker(mod):
    c = mod.MiniBatchController(clock_slack=2, batches_per_worker=100)
    c.register_worker("fast")
    c.register_worker("slow")
    seen = []
    t = threading.Thread(target=lambda: [seen.append((i, c.on_sync("fast", i)))
                                         for i in range(6)])
    t.start()
    deadline = time.monotonic() + 10
    while len(seen) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    blocked_at = max(i for i, _ in seen)      # 0 + slack 2 < 3
    for i in range(6):
        c.on_sync("slow", i)
    _join([t])
    return blocked_at, seen


def _slack_zero_is_bsp(mod):
    c = mod.MiniBatchController(clock_slack=0, batches_per_worker=10)
    c.register_worker("a")
    c.register_worker("b")
    done = []
    t = threading.Thread(target=lambda: (c.on_sync("a", 0), c.on_sync("a", 1),
                                         done.append("a1")))
    t.start()
    time.sleep(0.1)
    before = list(done)
    c.on_sync("b", 0)
    c.on_sync("b", 1)
    _join([t])
    return before, done


def _budget_stop_broadcast(mod):
    c = mod.MiniBatchController(clock_slack=10, batches_per_worker=3)
    c.register_worker("a")
    c.register_worker("b")
    out = [c.on_sync("a", i) for i in range(4)]
    out.append(c.on_sync("b", 1))
    return out, c.stopped


def _deregister_unblocks(mod):
    c = mod.MiniBatchController(clock_slack=0, batches_per_worker=100)
    c.register_worker("a")
    c.register_worker("dead")
    result = []
    t = threading.Thread(target=lambda: (c.on_sync("a", 1), result.append("released")))
    t.start()
    time.sleep(0.1)
    before = list(result)
    c.deregister_worker("dead")
    _join([t])
    return before, result


def _tracker_starting_epoch(mod):
    tr = mod.BatchProgressTracker(num_mini_batches_per_epoch=4)
    c = mod.MiniBatchController(clock_slack=8, batches_per_worker=100, tracker=tr)
    for i in range(9):
        c.on_sync("w0", i)
    for i in range(6):
        c.on_sync("w1", i)
    floored = mod.BatchProgressTracker(4, floor_batch=12)
    floored.on_batch("w0", 3)
    return (tr.global_min_batch(), tr.starting_epoch(),
            floored.global_min_batch(), floored.starting_epoch())


def _barrier_releases_when_all_arrive(mod):
    m = mod.WorkerStateManager(["w0", "w1"])
    order = []

    def worker(wid, delay):
        time.sleep(delay)
        order.append((wid, m.await_barrier(wid, "INIT", timeout=5)))

    ts = [threading.Thread(target=worker, args=("w0", 0.0)),
          threading.Thread(target=worker, args=("w1", 0.15))]
    for t in ts:
        t.start()
    _join(ts)
    return sorted(order), m.await_barrier("w0", "RUN", timeout=0.05)


def _membership_shrink_releases(mod):
    m = mod.WorkerStateManager(["w0", "w1", "w2"])
    released = []
    ts = [threading.Thread(target=lambda w=w: released.append(
        (w, m.await_barrier(w, "RUN", timeout=5)))) for w in ("w0", "w1")]
    for t in ts:
        t.start()
    time.sleep(0.1)
    before = list(released)
    m.update_workers(["w0", "w1"])
    _join(ts)
    with pytest.raises(ValueError, match="unknown state"):
        m.await_barrier("w0", "BOGUS")
    return before, sorted(released)


def _turnstile_cycles(mod):
    ts_ = mod.DispatchTurnstile(["w0", "w1", "w2"])
    order = []
    lock = threading.Lock()

    def worker(wid, turns):
        for _ in range(turns):
            with ts_.turn(wid):
                with lock:
                    order.append(wid)
        ts_.leave(wid)

    threads = [threading.Thread(target=worker, args=(w, n))
               for w, n in (("w2", 3), ("w1", 1), ("w0", 3))]
    for t in threads:
        t.start()
    _join(threads)
    return order


SSP_CASES = {
    "slack_blocks_fast_worker": _slack_blocks_fast_worker,
    "slack_zero_is_bsp": _slack_zero_is_bsp,
    "budget_stop_broadcast": _budget_stop_broadcast,
    "deregister_unblocks": _deregister_unblocks,
    "tracker_starting_epoch": _tracker_starting_epoch,
    "barrier_releases_when_all_arrive": _barrier_releases_when_all_arrive,
    "membership_shrink_releases": _membership_shrink_releases,
    "turnstile_cycles": _turnstile_cycles,
}
SSP_EXPECTED = {
    "slack_blocks_fast_worker": (2, [(i, False) for i in range(6)]),
    "slack_zero_is_bsp": ([], ["a1"]),
    "budget_stop_broadcast": ([False, False, False, True, True], True),
    "deregister_unblocks": ([], ["released"]),
    "tracker_starting_epoch": (5, 1, 12, 3),
    "barrier_releases_when_all_arrive": ([("w0", True), ("w1", True)], False),
    "membership_shrink_releases": ([], [("w0", True), ("w1", True)]),
    "turnstile_cycles": ["w0", "w1", "w2", "w0", "w2", "w0", "w2"],
}


@pytest.mark.parametrize("case", sorted(SSP_CASES))
def test_ssp_classes_match_the_reference(case):
    ref = SSP_CASES[case](ref_master)
    mine = SSP_CASES[case](port_master)
    assert mine == ref == SSP_EXPECTED[case]


# -- workers under an SSP gate ------------------------------------------------


def test_two_async_workers_exact_sums():
    """tests/test_master.py::TestSSPTraining's case on the port: two worker
    threads, each on its own data, share one model table under an SSP gate
    of slack 1; no push is lost."""
    n_per_worker, epochs, nb = 64, 2, 4
    trainer = AddVectorTrainer(num_keys=8, vector_dim=2, delta=1.0)
    table = DenseTable(TableSpec(trainer.model_table_config()), "cpu")
    ctrl = port_master.MiniBatchController(clock_slack=1, batches_per_worker=epochs * nb)
    results, errors = {}, []

    def run_worker(wid):
        try:
            params = TrainerParams(num_epochs=epochs, num_mini_batches=nb)
            ctx = TrainerContext(params=params, model_table=table, worker_id=wid,
                                 num_workers=2)
            w = WorkerTasklet(
                "ssp-job", ctx, AddVectorTrainer(num_keys=8, vector_dim=2, delta=1.0),
                TrainingDataProvider(list(make_marks(n_per_worker)), nb),
                global_init=(wid == "w0"), batch_barrier=ctrl.make_barrier(wid))
            results[wid] = w.run()
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)
        finally:
            ctrl.deregister_worker(wid)

    ts = [threading.Thread(target=run_worker, args=(f"w{i}",)) for i in range(2)]
    for t in ts:
        t.start()
    _join(ts, timeout=60)
    assert errors == []
    np.testing.assert_array_equal(table.pull_array().numpy(),
                                  np.full((8, 2), 2 * n_per_worker * epochs))
    for r in results.values():
        assert r["fused_epochs"] is False and r["windows"] == [1, 1]
        assert r["stopped_early"] is False and r["epochs_run"] == epochs


# -- jobs under the JobServer -------------------------------------------------


def _mlr_job(job_id="mlr", epochs=2, workers=1, slack=0, package="harmony_tpu_torch",
             cls=JobConfig, params=TrainerParams, **user):
    return cls(
        job_id=job_id, app_type="dolphin",
        trainer=f"{package}.apps.mlr:MLRTrainer",
        params=params(num_epochs=epochs, num_mini_batches=4, clock_slack=slack,
                      app_params={"num_classes": 4, "num_features": 16,
                                  "features_per_partition": 4, "step_size": 0.5}),
        num_workers=workers,
        user={"data_fn": f"{package}.apps.mlr:make_synthetic",
              "data_args": {"n": 256, "num_features": 16, "num_classes": 4, "seed": 7},
              **user})


def _addvector_job(job_id="addv", n=128, epochs=2, workers=2, slack=1,
                   trainer="harmony_tpu_torch.apps.addvector:AddVectorTrainer",
                   package="harmony_tpu_torch", cls=JobConfig, params=TrainerParams,
                   **app_extra):
    return cls(
        job_id=job_id, app_type="dolphin",
        trainer=trainer.replace("harmony_tpu_torch", package, 1),
        params=params(num_epochs=epochs, num_mini_batches=4, clock_slack=slack,
                      app_params={"num_keys": 8, "vector_dim": 2, "delta": 1.0,
                                  **app_extra}),
        num_workers=workers,
        user={"data_fn": f"{package}.apps.addvector:make_marks", "data_args": {"n": n}})


def _server():
    server = JobServer(1, device_pool=DevicePool(["cpu"]))
    server.start()
    return server


def test_concurrent_multitenant_jobs():
    """tests/test_jobserver.py::TestJobServer's multi-tenant case on the
    port: MLR (2 workers, slack 1) and AddVector (2 workers) at once on one
    CPU executor, both through one TaskUnit order."""
    server = _server()
    try:
        f1 = server.submit(_mlr_job(workers=2, slack=1))
        f2 = server.submit(_addvector_job())
        r1, r2 = f1.result(timeout=TIMEOUT), f2.result(timeout=TIMEOUT)
        grants = server.global_taskunit.grant_order()
    finally:
        server.shutdown(timeout=TIMEOUT)
    assert list(r1["workers"]) == ["mlr/w0", "mlr/w1"]
    assert list(r2["workers"]) == ["addv/w0", "addv/w1"]
    for w in r1["workers"].values():
        assert w["losses"][-1] < w["losses"][0] and not w["fused_epochs"]
    assert {j for j, _, _ in grants} == {"mlr", "addv"}
    assert server.global_taskunit.meter_execution is True   # a CPU pool
    assert server.master.table_ids() == []


def test_addvector_exact_on_a_shared_table():
    """The job names a table the caller made: it reuses it (the refcount
    keeps it past the job's cleanup), and every key holds n * epochs."""
    n, epochs = 128, 2
    server = _server()
    try:
        shared = TableConfig(table_id="shared-addv", capacity=8, value_shape=(2,),
                             num_blocks=8)
        made = server.master.create_table(shared, server.master.executor_ids())
        server.submit(_addvector_job(n=n, epochs=epochs).replace(tables=[shared])) \
            .result(timeout=TIMEOUT)
        assert server.master.get_table("shared-addv") is made
        np.testing.assert_array_equal(made.pull_array().numpy(),
                                      np.full((8, 2), n * epochs))
        server.master.drop_table("shared-addv")
        assert server.master.table_ids() == [] and made.array is None
    finally:
        server.shutdown(timeout=TIMEOUT)


_GATES = {}
_ARRIVED = {}


class GatedAddVector(AddVectorTrainer):
    """AddVector whose training starts only when the gate named ``gate`` is
    set; it signals its arrival there."""

    def __init__(self, gate, **kw):
        super().__init__(**kw)
        self.gate = gate

    def on_training_start(self, ctx, epoch):
        _ARRIVED[self.gate].set()
        assert _GATES[self.gate].wait(30)
        super().on_training_start(ctx, epoch)


def test_creator_finishing_first_does_not_free_a_tenants_table():
    """Two jobs name one table; the one that creates it finishes (and drops
    its reference) while the other, which holds its reference, has not
    started training. The tenant trains on the live table, the sums hold
    both jobs' examples, and the table is freed when the last holder drops
    it."""
    shared = TableConfig(table_id="shared-two", capacity=8, value_shape=(2,), num_blocks=8)
    for gate in ("creator", "tenant"):
        _GATES[gate], _ARRIVED[gate] = threading.Event(), threading.Event()
    seen = {}
    cleanup = DolphinJobEntity.cleanup

    def read_then_cleanup(entity):
        if entity.config.job_id == "tenant":
            seen["values"] = entity._table.pull_array().numpy().copy()
        cleanup(entity)

    def job(job_id, n, epochs, workers):
        return _addvector_job(job_id, n=n, epochs=epochs, workers=workers,
                              trainer=f"{__name__}:GatedAddVector",
                              gate=job_id).replace(tables=[shared])

    server = _server()
    try:
        DolphinJobEntity.cleanup = read_then_cleanup
        creator = server.submit(job("creator", 64, 1, 1))
        assert _ARRIVED["creator"].wait(30)          # the creator made the table
        tenant = server.submit(job("tenant", 128, 2, 2))
        assert _ARRIVED["tenant"].wait(30)           # the tenant holds it too
        _GATES["creator"].set()
        creator.result(timeout=TIMEOUT)
        assert server.master.table_ids() == ["shared-two"]
        _GATES["tenant"].set()
        tenant.result(timeout=TIMEOUT)
    finally:
        DolphinJobEntity.cleanup = cleanup
        for gate in ("creator", "tenant"):
            _GATES[gate].set()
        server.shutdown(timeout=TIMEOUT)
    np.testing.assert_array_equal(seen["values"], np.full((8, 2), 64 + 128 * 2))
    assert server.master.table_ids() == []


def test_refcounted_drops_and_atomic_get_or_create():
    master = ETMaster(DevicePool(["cpu"]))
    (ex,) = master.add_executors(1)
    cfg = TableConfig(table_id="t", capacity=4)
    a, created_a = master.get_or_create_table(cfg, [ex.id])
    b, created_b = master.get_or_create_table(cfg, [ex.id])
    assert (created_a, created_b) == (True, False) and a is b
    master.drop_table("t")
    assert master.table_ids() == ["t"] and a.array is not None
    master.drop_table("t")
    assert master.table_ids() == [] and a.array is None   # storage freed
    master.drop_table("t")                                 # idempotent
    with pytest.raises(KeyError):
        master.get_table("t")


# -- lockstep -----------------------------------------------------------------


def _lockstep_losses(result):
    return {w: r["batch_losses"] for w, r in result["workers"].items()}


def test_lockstep_two_worker_mlr_is_repeatable_and_matches_the_reference():
    runs = []
    for _ in range(2):
        server = _server()
        try:
            runs.append(server.submit(_mlr_job(workers=2, force_lockstep=True))
                        .result(timeout=TIMEOUT))
            grants = server.global_taskunit.grant_order()
        finally:
            server.shutdown(timeout=TIMEOUT)
        assert grants == []   # lockstep workers take no TaskUnits
    mine = _lockstep_losses(runs[0])
    assert mine == _lockstep_losses(runs[1])
    ref_server = JaxJobServer(num_executors=1,
                              device_pool=JaxDevicePool(jax.devices("cpu")[:1]))
    ref_server.start()
    try:
        ref = ref_server.submit(_mlr_job(
            workers=2, package="harmony_tpu", cls=JaxJobConfig, params=JaxTrainerParams,
            force_lockstep=True)).result(timeout=TIMEOUT)
    finally:
        ref_server.shutdown()
    assert sorted(ref["workers"]) == sorted(mine)
    for wid, w in runs[0]["workers"].items():
        # the reference reports each epoch's last batch loss
        assert len(w["losses"]) == 2
        np.testing.assert_allclose(w["losses"], ref["workers"][wid]["losses"],
                                   rtol=0, atol=LOCKSTEP_ATOL)


def test_addvector_two_workers_exact_in_both_packages():
    """The reference's and the port's JobServers run the same 2-worker
    AddVector job on a shared table: both tables hold n * epochs exactly."""
    n, epochs = 128, 2
    from harmony_tpu.config.params import TableConfig as JaxTableConfig

    ref_server = JaxJobServer(num_executors=1,
                              device_pool=JaxDevicePool(jax.devices("cpu")[:1]))
    ref_server.start()
    try:
        cfg = JaxTableConfig(table_id="shared", capacity=8, value_shape=(2,), num_blocks=8)
        ref_server.master.create_table(cfg, ref_server.master.executor_ids())
        ref_server.submit(_addvector_job(n=n, epochs=epochs, package="harmony_tpu",
                                         cls=JaxJobConfig, params=JaxTrainerParams)
                          .replace(tables=[cfg])).result(timeout=TIMEOUT)
        ref_vals = np.asarray(ref_server.master.get_table("shared").table.pull_array())
    finally:
        ref_server.shutdown()
    server = _server()
    try:
        cfg = TableConfig(table_id="shared", capacity=8, value_shape=(2,), num_blocks=8)
        table = server.master.create_table(cfg, server.master.executor_ids())
        server.submit(_addvector_job(n=n, epochs=epochs).replace(tables=[cfg])) \
            .result(timeout=TIMEOUT)
        mine = table.pull_array().numpy()
    finally:
        server.shutdown(timeout=TIMEOUT)
    np.testing.assert_array_equal(mine, ref_vals)
    np.testing.assert_array_equal(mine, np.full((8, 2), n * epochs))


# -- C4: TaskUnit admission pins the batched epoch -----------------------------


def test_a_jobserver_worker_runs_per_batch_units_and_a_lone_worker_fused_windows():
    epochs, nb = 3, 4
    job = _mlr_job(epochs=epochs).replace(
        params=_mlr_job().params.replace(num_epochs=epochs, input_prefetch=False,
                                         comm_probe_period=1))
    server = _server()
    try:
        served = server.submit(job).result(timeout=TIMEOUT)["workers"]["mlr/w0"]
        grants = server.global_taskunit.grant_order()
    finally:
        server.shutdown(timeout=TIMEOUT)
    assert served["fused_epochs"] is False
    # one CPU unit for global init, one for the comm probe, one COMP unit
    # (a CPU unit) a batch (an uncontended job groups one batch a unit), one
    # NET unit a drain
    kinds = [k for j, _, k in grants if j == "mlr"]
    probes = served["comm_probe"]["probes"]
    assert probes == 1
    assert kinds.count(CPU) == 1 + probes + epochs * nb
    assert kinds.count(NET) == len(served["windows"])
    assert [s for j, s, _ in grants] == list(range(len(grants)))

    master = ETMaster(DevicePool(["cpu"]))
    entity = DolphinJobEntity(job)
    entity.setup(master, [e.id for e in master.add_executors(1)])
    try:
        lone = entity.make_worker().run()
    finally:
        entity.cleanup()
    assert lone["fused_epochs"] is True
    assert lone["windows"] == served["windows"] == [epochs]   # probe, then one window
    assert lone["batch_losses"] == served["batch_losses"]


def test_the_prefetch_stages_in_net_units_for_a_single_worker_job(monkeypatch):
    """A shuffling job's staging copies ride the fair queue as NET units,
    besides the drains'."""
    from harmony_tpu_torch.dolphin import data as data_mod

    real = data_mod.TrainingDataProvider.__init__

    def shuffling(self, arrays, nb, shuffle_each_epoch=False, seed=0, dataset_key=None):
        real(self, arrays, nb, shuffle_each_epoch=True, seed=seed, dataset_key=dataset_key)

    monkeypatch.setattr(data_mod.TrainingDataProvider, "__init__", shuffling)
    job = _mlr_job(epochs=2)
    job = job.replace(params=job.params.replace(comm_probe_period=0))
    server = _server()
    try:
        r = server.submit(job).result(timeout=TIMEOUT)["workers"]["mlr/w0"]
        kinds = [k for j, _, k in server.global_taskunit.grant_order() if j == "mlr"]
    finally:
        server.shutdown(timeout=TIMEOUT)
    assert r["input"]["staged"] == 2 * 4
    assert kinds.count(NET) == len(r["windows"]) + r["input"]["staged"]


class _FakeUnits:
    def __init__(self, contended, peer=0.0):
        self._contended, self._peer = contended, peer

    def contended(self):
        return self._contended

    def peer_unit_cost(self):
        return self._peer


def test_inflight_cap_and_batch_groups_follow_contention():
    trainer = AddVectorTrainer(num_keys=8, vector_dim=2)
    table = DenseTable(TableSpec(trainer.model_table_config()), "cpu")
    ctx = TrainerContext(params=TrainerParams(num_mini_batches=4), model_table=table)
    data = TrainingDataProvider(list(make_marks(64)), 4)

    def worker(**kw):
        return WorkerTasklet("j", ctx, trainer, data, **kw)

    assert worker()._inflight_cap() == WorkerTasklet.MAX_INFLIGHT
    assert worker(taskunit=_FakeUnits(False))._inflight_cap() == WorkerTasklet.MAX_INFLIGHT
    w = worker(taskunit=_FakeUnits(True, peer=0.2))
    assert w._inflight_cap() == WorkerTasklet.CONTENDED_INFLIGHT == 2
    assert w._units_per_scope() == 1          # no batch measured yet
    w._own_batch_cost = 0.05
    assert w._units_per_scope() == 4          # 0.2 s of peer unit / 0.05 s
    w._own_batch_cost = 1e-5
    assert w._units_per_scope() == 8          # at most 8
    assert worker(taskunit=_FakeUnits(True), batch_barrier=lambda i: False) \
        ._units_per_scope() == 1              # the SSP gate is per batch
    assert worker(batch_barrier=lambda i: False)._use_fused_epoch() is False
    assert worker(taskunit=_FakeUnits(False))._use_fused_epoch() is False
    assert worker()._use_fused_epoch() is True


# -- failures, sizes, the CLI and Pregel ---------------------------------------


class CrashOnW0(AddVectorTrainer):
    """Fails in global init on worker w0 only."""

    def init_global_settings(self, ctx) -> None:
        if ctx.worker_id.endswith("/w0"):
            raise RuntimeError("synthetic failure on w0")


def test_a_worker_crash_does_not_deadlock_the_job():
    """w0 dies during init: w1 leaves the broken init barrier, the quorum
    shrinks, and the job's future resolves with the error."""
    server = _server()
    try:
        fut = server.submit(_addvector_job(
            "crashy", trainer=f"{__name__}:CrashOnW0"))
        with pytest.raises(RuntimeError, match="synthetic failure"):
            fut.result(timeout=60)
        assert server.submit(_addvector_job("after")).result(timeout=TIMEOUT)
    finally:
        server.shutdown(timeout=60)
    assert server.state == "CLOSED" and server.master.table_ids() == []


def test_worker_count_and_data_slices():
    """num_workers 0 is one worker per executor; with two, each takes a slice
    and the last takes the remainder (131 examples: 65 and 66, each in 4
    batches of 16, so 64 a worker an epoch reach the table); too few
    examples refuse the job."""
    shared = TableConfig(table_id="slices", capacity=8, value_shape=(2,), num_blocks=8)
    server = _server()
    try:
        table = server.master.create_table(shared, server.master.executor_ids())
        one = server.submit(_addvector_job("one", workers=0)).result(timeout=TIMEOUT)
        two = server.submit(_addvector_job("two", n=131, epochs=1).replace(
            tables=[shared])).result(timeout=TIMEOUT)
        values = table.pull_array().numpy()
        with pytest.raises(ValueError, match="cannot feed"):
            server.submit(_addvector_job("few", n=7)).result(timeout=TIMEOUT)
    finally:
        server.shutdown(timeout=TIMEOUT)
    assert list(one["workers"]) == ["one/w0"]
    assert list(two["workers"]) == ["two/w0", "two/w1"]
    np.testing.assert_array_equal(values, np.full((8, 2), 2 * 64))


def test_cli_runs_two_workers_with_slack(capsys):
    assert cli.main(["run", "addvector", "--device", "cpu", "--epochs", "2",
                     "--batches", "4", "--workers", "2", "--slack", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    workers = out["result"]["workers"]
    assert sorted(workers) == ["addvector-job/w0", "addvector-job/w1"]
    assert all(not w["fused_epochs"] and w["epochs_run"] == 2 for w in workers.values())
    args = cli.build_parser().parse_args(["run", "mlr", "--workers", "2", "--slack", "3"])
    cfg = cli.build_config("mlr", args)
    assert (cfg.num_workers, cfg.params.clock_slack) == (2, 3)


def test_pagerank_beside_mlr_under_taskunits():
    """A Pregel job takes a COMP unit a superstep beside an MLR job; its
    values are those of the same graph run alone."""
    graph_args = {"num_vertices": 200, "avg_degree": 4}
    pregel = JobConfig(
        job_id="pr", app_type="pregel",
        trainer="harmony_tpu_torch.apps.pagerank:PageRankComputation",
        params=TrainerParams(app_params={"num_iterations": 5}),
        user={"graph_fn": "harmony_tpu_torch.pregel.graph:random_graph",
              "graph_args": graph_args, "max_supersteps": 20})
    server = _server()
    try:
        fm = server.submit(_mlr_job(epochs=3))
        fp = server.submit(pregel)
        got = fp.result(timeout=TIMEOUT)
        fm.result(timeout=TIMEOUT)
        grants = server.global_taskunit.grant_order()
    finally:
        server.shutdown(timeout=TIMEOUT)
    g = random_graph(**graph_args)
    solo = PregelMaster(g, PageRankComputation(g, 5), "cpu", max_supersteps=20).run()
    np.testing.assert_array_equal(got["vertex_values"], solo["vertex_values"])
    assert sum(1 for j, _, k in grants if j == "pr") == got["supersteps"]
    assert {j for j, _, _ in grants} == {"pr", "mlr"}


def test_two_workers_on_a_hash_table_repeat_in_lockstep():
    """Two lockstep workers share one DeviceHashTable (FM with sparse=True):
    every probe round runs under the table's lock, so two runs give the
    same losses bit for bit, and the table refuses the keys a one-worker
    run refuses (the preset's id 0, the hash table's reserved key)."""
    args = cli.build_parser().parse_args([
        "run", "fm", "--device", "cpu", "--epochs", "2", "--batches", "4",
        "--workers", "2", "--set", "sparse=true", "--set", "vocab_size=512",
        "--set", "num_slots=4", "--data", "vocab_size=512", "--data", "num_slots=4",
        "--data", "n=512"])
    config = cli.build_config("fm", args)
    config = config.replace(user={**config.user, "force_lockstep": True})
    runs = []
    for c in (config, config, config.replace(num_workers=1)):
        server = _server()
        try:
            runs.append(server.submit(c).result(timeout=TIMEOUT)["workers"])
        finally:
            server.shutdown(timeout=TIMEOUT)
    assert sorted(runs[0]) == ["fm-job/w0", "fm-job/w1"]
    for wid, w in runs[0].items():
        assert w["batch_losses"] == runs[1][wid]["batch_losses"]
        assert np.all(np.isfinite(w["batch_losses"]))
    # each worker reads the shared count at its own end: the last one, all
    refused = [max(w["overflow_count"] for w in run.values()) for run in runs]
    assert refused[0] == refused[1] == refused[2] > 0
