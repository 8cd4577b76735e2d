"""harmony_tpu_torch.optimizer and metrics/{collector,manager} against harmony_tpu's.

The same seeded metrics go to both packages' optimizers, and their decisions
must be equal: the homogeneous cost model's plans, the plan compiler's op
DAG, the sample optimizers, the heterogeneous solver's allocations and
plans, and ``_largest_remainder``. Virtual executor ids carry a per-process
counter in both packages (``homogeneous-add-N``, ``sample-add-N``), so they
are compared up to renaming. The orchestrator is driven through ``run_once``
(not its timer) on a worker training AddVector over 4 virtual slots, against
the reference's on 4 virtual devices: the same plan, the same owning
executors and the exact sums. All exact.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from harmony_tpu import optimizer as J
from harmony_tpu.metrics import collector as jcol
from harmony_tpu.metrics.manager import MetricManager as JaxMetricManager
from harmony_tpu.optimizer import hetero as jhetero
from harmony_tpu.optimizer.api import EvaluatorParams as JaxParams
from harmony_tpu_torch import optimizer as T
from harmony_tpu_torch.metrics import collector as tcol
from harmony_tpu_torch.metrics.manager import MetricManager
from harmony_tpu_torch.optimizer import hetero as thetero
from harmony_tpu_torch.optimizer.api import EvaluatorParams


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def params(P, C, comp_sec, comm_sec, counts, n=4, table_id="t", extra=None):
    wm = [C.BatchMetrics(job_id="j", worker_id=f"j/w{i % 2}", epoch_idx=i // 2,
                         batch_idx=i % 2, comp_time_sec=comp_sec,
                         pull_time_sec=comm_sec / 2, push_time_sec=comm_sec / 2,
                         batch_time_sec=(comp_sec + comm_sec) * (1 + 0.5 * (i % 2)),
                         num_examples=100)
          for i in range(n)]
    return P(worker_metrics=wm, table_id=table_id, block_counts=dict(counts),
             **(extra or {}))


def both(comp_sec, comm_sec, counts, **kw):
    return (params(EvaluatorParams, tcol, comp_sec, comm_sec, counts, **kw),
            params(JaxParams, jcol, comp_sec, comm_sec, counts, **kw))


def canon(plan):
    """A DolphinPlan as plain data, virtual ids renamed in order of use."""
    names = {}

    def name(x):
        if x in plan.evaluators_to_add:
            return names.setdefault(x, f"v{len(names)}")
        return x

    for v in plan.evaluators_to_add:
        name(v)
    return (sorted(names.values()), list(plan.evaluators_to_delete),
            [(s.table_id, name(s.src), name(s.dst), s.num_blocks) for s in plan.transfer_steps],
            plan.empty)


GRID = [(comp, comm, counts, avail)
        for comp in (1.0, 0.2, 0.001)
        for comm in (0.0, 0.1, 1.0)
        for counts in ({"e0": 8, "e1": 8}, {"e0": 10, "e1": 4, "e2": 2}, {"e0": 16})
        for avail in (1, 3, 6)]


@pytest.mark.parametrize("min_gain", [0.05, 0.5])
def test_homogeneous_plans_are_the_references(min_gain):
    for comp, comm, counts, avail in GRID:
        ours, ref = both(comp, comm, counts)
        got = T.HomogeneousOptimizer(min_gain=min_gain).optimize(ours, avail)
        want = J.HomogeneousOptimizer(min_gain=min_gain).optimize(ref, avail)
        assert canon(got) == canon(want), (comp, comm, counts, avail)
    assert T.HomogeneousOptimizer().optimize(EvaluatorParams(block_counts={"e0": 8}), 8).empty


def test_the_cost_model_is_the_references():
    for comp, comm, counts, _ in GRID:
        ours, ref = both(comp, comm, counts)
        assert T.HomogeneousOptimizer._estimate_units(ours) == \
            J.HomogeneousOptimizer._estimate_units(ref)
        for d in range(1, 6):
            assert T.HomogeneousOptimizer.predicted_batch_time(comp, comm, d) == \
                J.HomogeneousOptimizer.predicted_batch_time(comp, comm, d)


def ops_of(plan):
    """The op DAG as data: each op's kind and fields (ids renamed), and its
    dependencies, in topological order."""
    order = plan._dag.topological_order()
    index = {op: i for i, op in enumerate(order)}
    preds = {op: set() for op in order}
    for op in order:
        for dst in plan._dag._out[op]:
            preds[dst].add(index[op])
    out = []
    for op in order:
        fields = {k: v for k, v in vars(op).items() if k not in ("op_id", "conf")}
        out.append((op.kind, sorted(fields.items()), sorted(preds[op])))
    return out


@pytest.mark.parametrize("case", ["add", "delete", "mixed"])
def test_the_compiler_builds_the_references_op_dag(case):
    plans = []
    for P in (T, J):
        TS = P.TransferStep
        dplan = {
            "add": P.DolphinPlan(evaluators_to_add=["v0", "v1"],
                                 transfer_steps=[TS("t", "e0", "v0", 2), TS("t", "e1", "v1", 3)]),
            "delete": P.DolphinPlan(evaluators_to_delete=["e2"],
                                    transfer_steps=[TS("t", "e2", "e0", 3)]),
            "mixed": P.DolphinPlan(evaluators_to_add=["v0"], evaluators_to_delete=["e1"],
                                   transfer_steps=[TS("t", "e1", "v0", 4),
                                                   TS("t", "e1", "e0", 1)]),
        }[case]
        plans.append(ops_of(P.PlanCompiler().compile(dplan, "t")))
    assert plans[0] == plans[1]
    with pytest.raises(ValueError, match="add_specs"):
        T.PlanCompiler().compile(T.DolphinPlan(add_specs={"x": None}), "t")


def test_the_sample_optimizers_decide_as_the_references():
    for counts in ({"e0": 8, "e1": 4}, {"e0": 5, "e1": 5, "e2": 6}, {"e0": 16}):
        for avail in (1, 2, 3, 4):
            ours, ref = both(1.0, 0.1, counts)
            for name in ("AddOneServerOptimizer", "DeleteOneServerOptimizer",
                         "EmptyPlanOptimizer"):
                t = getattr(T, name)() if name == "EmptyPlanOptimizer" else getattr(T, name)(2)
                j = getattr(J, name)() if name == "EmptyPlanOptimizer" else getattr(J, name)(2)
                for _ in range(3):  # fires at most twice
                    assert canon(t.optimize(ours, avail)) == canon(j.optimize(ref, avail)), \
                        (name, counts, avail)


def test_largest_remainder_is_the_references():
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(0, 7))
        weights = list(rng.random(n) * rng.choice([0.0, 1.0, 50.0]))
        total, minimum = int(rng.integers(0, 200)), int(rng.integers(0, 8))
        assert thetero._largest_remainder(total, weights, minimum) == \
            jhetero._largest_remainder(total, weights, minimum)


def profiles(mod, rng, n, known=0.7):
    return [mod.ExecutorProfile(f"e{i}", cores=int(rng.integers(1, 9)),
                                bandwidth=float(rng.choice([0.5, 1.0, 2.0, 4.0])),
                                rate=(float(rng.random() * 100 + 1) if rng.random() < known
                                      else None))
            for i in range(n)]


@pytest.mark.parametrize("n", [2, 3, 5, 14])
def test_the_solver_allocates_as_the_references(n):
    rng = np.random.default_rng(n)
    for trial in range(6 if n < 14 else 2):
        seed = int(rng.integers(1 << 30))
        ours = profiles(thetero, np.random.default_rng(seed), n)
        ref = profiles(jhetero, np.random.default_rng(seed), n)
        thetero.predict_unknown_rates(ours)
        jhetero.predict_unknown_rates(ref)
        assert [p.rate for p in ours] == [p.rate for p in ref]
        comm = float(rng.choice([0.0, 0.01, 0.1]))
        got = thetero.ILPSolver(min_model_blocks_per_owner=2).solve(ours, 24, 64, comm)
        want = jhetero.ILPSolver(min_model_blocks_per_owner=2).solve(ref, 24, 64, comm)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (n, trial)
    with pytest.raises(ValueError):
        thetero.ILPSolver().solve(profiles(thetero, rng, 1), 4, 4)


def test_the_heterogeneous_optimizer_plans_as_the_references(tmp_path):
    cores = tmp_path / "cores.txt"
    bw = tmp_path / "bw.txt"
    cores.write_text("# host cores\ne0 2\ne1 8\ne2 4\n")
    bw.write_text("e0 1.0\ne1 4.0\ne2 0.5\n")
    assert {k: dataclasses.asdict(v) for k, v in
            thetero.load_profiles(str(cores), str(bw)).items()} == \
        {k: dataclasses.asdict(v) for k, v in
         jhetero.load_profiles(str(cores), str(bw)).items()}
    counts = {"e0": 20, "e1": 22, "e2": 22}
    for comm in (None, 0.0, 0.01):
        opt_t = thetero.HeterogeneousOptimizer(
            profiles=thetero.load_profiles(str(cores), str(bw)), comm_cost_per_block=comm,
            solver=thetero.ILPSolver(min_model_blocks_per_owner=2))
        opt_j = jhetero.HeterogeneousOptimizer(
            profiles=jhetero.load_profiles(str(cores), str(bw)), comm_cost_per_block=comm,
            solver=jhetero.ILPSolver(min_model_blocks_per_owner=2))
        for step in range(3):   # the EMA of the rates carries across rounds
            wmap = {"j/w0": "e0", "j/w1": "e1"}
            ours, ref = both(0.5 + step, 0.2, counts, n=6,
                             extra={"worker_to_executor": wmap})
            assert canon(opt_t.optimize(ours, 3)) == canon(opt_j.optimize(ref, 3))
            assert opt_t._ema_rates == opt_j._ema_rates


def test_the_metric_manager_stores_and_clears_as_the_references():
    stores = (MetricManager(), JaxMetricManager())
    mods = (tcol, jcol)
    for m in stores:
        m.on_metric(None)        # not collecting yet: dropped
        m.start_collection()
    for m, C in zip(stores, mods):
        for job in ("a", "b"):
            for i in range(5):
                m.on_metric(C.BatchMetrics(job_id=job, worker_id=f"{job}/w{i % 2}",
                                           batch_idx=i, num_examples=10,
                                           batch_time_sec=0.1 * (i + 1)))
            m.on_metric(C.ServerMetrics(job_id=job, executor_id=f"x-{job}", num_blocks=4))
        m.on_metric({"custom": 1.0})
    for q in (lambda m: [x.to_dict() for x in m.worker_batch_metrics(job_id="a")],
              lambda m: [x.to_dict() for x in m.worker_batch_metrics(worker_id="b/w1")],
              lambda m: [x.to_dict() for x in m.server_metrics()],
              lambda m: [x.to_dict() for x in m.server_metrics(job_id="b")]):
        got, want = q(stores[0]), q(stores[1])
        for g in (got if isinstance(got, list) else []):
            g.pop("_type", None)
        for w in (want if isinstance(want, list) else []):
            w.pop("_type", None)
        assert got == want
    for m in stores:
        m.clear(job_id="a")
    assert len(stores[0].worker_batch_metrics()) == len(stores[1].worker_batch_metrics()) == 5
    assert tcol.BatchMetrics(num_examples=30, batch_time_sec=0.5).data_processing_rate == \
        jcol.BatchMetrics(num_examples=30, batch_time_sec=0.5).data_processing_rate


def test_the_collector_flushes_custom_metrics_as_the_references():
    got, want = [], []
    for C, sink in ((tcol, got), (jcol, want)):
        c = C.MetricCollector(sink=sink.append, job_id="j", worker_id="w")
        c.add(C.EpochMetrics(job_id="j", epoch_idx=1, loss=0.5))
        c.add_custom_metric("k", 1.5)
        c.add_custom_metric("k", 2.0)
        assert len(c.flush()) == 2
        assert c.flush() == []
    assert got[1] == want[1] == {"k": 3.5, "job_id": "j", "worker_id": "w"}
    assert {k: v for k, v in got[0].to_dict().items() if k != "_type"} == \
        {k: v for k, v in want[0].to_dict().items() if k != "_type"}


def orchestrated_run(pkg):
    """AddVector training on a table of 2 of 4 executors, the orchestrator's
    ``run_once`` after epoch 2 with AddOneServer (total capacity 3)."""
    if pkg == "port":
        from harmony_tpu_torch.apps.addvector import AddVectorTrainer, make_marks
        from harmony_tpu_torch.config.params import TrainerParams
        from harmony_tpu_torch.dolphin.data import TrainingDataProvider
        from harmony_tpu_torch.dolphin.trainer import TrainerContext
        from harmony_tpu_torch.dolphin.worker import WorkerTasklet
        from harmony_tpu_torch.parallel.mesh import DevicePool
        from harmony_tpu_torch.runtime.master import ETMaster

        master = ETMaster(DevicePool.virtual("cpu", 4))
        P, C, M, mesh = T, tcol, MetricManager, ()
    else:
        from harmony_tpu.apps.addvector import AddVectorTrainer, make_marks
        from harmony_tpu.config.params import TrainerParams
        from harmony_tpu.dolphin import TrainerContext, TrainingDataProvider, WorkerTasklet
        from harmony_tpu.parallel import DevicePool
        from harmony_tpu.runtime import ETMaster

        master = ETMaster(DevicePool(jax.devices()[:4]))
        P, C, M = J, jcol, JaxMetricManager
    exs = master.add_executors(2)
    trainer = AddVectorTrainer(num_keys=16, vector_dim=2, delta=1.0)
    made = master.create_table(trainer.model_table_config(), [e.id for e in exs])
    handle = master.table_handle(made.spec.table_id) if pkg == "port" else made
    metrics = M()
    metrics.start_collection()
    orch = P.OptimizationOrchestrator(master, handle, P.AddOneServerOptimizer(max_times=1),
                                      metrics, available_fn=lambda: 3)
    plans = []
    plan_of = orch.optimizer.optimize

    def recorded(p, avail):
        plan = plan_of(p, avail)
        # executor ids carry a counter (process-wide in the reference): by position
        pos = {e: f"executor #{i}" for i, e in enumerate(p.block_counts)}
        adds, dels, steps, empty = canon(plan)
        plans.append((adds, [pos[e] for e in dels],
                      [(t, pos.get(s, s), pos.get(d, d), n) for t, s, d, n in steps], empty))
        return plan

    orch.optimizer.optimize = recorded
    n, epochs, nb = 128, 6, 4
    ctx = TrainerContext(params=TrainerParams(num_epochs=epochs, num_mini_batches=nb),
                         model_table=handle.table)
    args = (["orch", ctx, trainer, TrainingDataProvider(list(make_marks(n)), nb)]
            + ([] if pkg == "port" else [handle.table.mesh]))
    worker = WorkerTasklet(*args, collector=C.MetricCollector(sink=metrics.on_metric),
                           epoch_callback=lambda e: orch.run_once() if e == 2 else None)
    worker.run()
    assert len(orch.reconfig_log) == 1 and orch.reconfig_log[0].success
    return (plans, len(handle.owning_executors()),
            np.asarray(handle.table.pull_array()), trainer.expected_value(n * epochs),
            len(metrics.worker_batch_metrics()))


def test_the_orchestrator_run_once_moves_the_table_as_the_references():
    got, want = orchestrated_run("port"), orchestrated_run("ref")
    assert got[0] == want[0]
    assert got[1] == want[1] == 3
    np.testing.assert_array_equal(got[2], np.full((16, 2), got[3]))
    np.testing.assert_array_equal(got[2], want[2])
    # the round at epoch 2's callback cleared the metrics flushed before it
    # (epochs 0 and 1); epoch 2's are flushed after the callback
    assert got[4] == want[4] == 4 * 4


def test_the_periodic_loop_and_the_fluctuator():
    import time

    from harmony_tpu.optimizer.orchestrator import ResourceFluctuator as JaxFluct
    from harmony_tpu_torch.config.params import TableConfig
    from harmony_tpu_torch.optimizer.orchestrator import ResourceFluctuator
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    master = ETMaster(DevicePool.virtual("cpu", 2))
    exs = master.add_executors(1)
    master.create_table(TableConfig(table_id="o", capacity=8, value_shape=(), num_blocks=8),
                        [e.id for e in exs])
    orch = T.OptimizationOrchestrator(master, master.table_handle("o"),
                                      T.EmptyPlanOptimizer(), MetricManager(),
                                      period_sec=0.05)
    orch.start()
    with pytest.raises(RuntimeError):
        orch.start()
    time.sleep(0.2)
    orch.stop()
    assert orch.reconfig_log == [] and not orch.errors
    clock = [0.0]
    f, g = (cls(base=2, num_extra=3, period_sec=10, clock=lambda: clock[0])
            for cls in (ResourceFluctuator, JaxFluct))
    for t in (0.0, 5.0, 10.0, 15.0, 20.0, 31.0):
        clock[0] = t
        assert f() == g()
    with pytest.raises(ValueError):
        ResourceFluctuator(base=-1, num_extra=0, period_sec=1)


def test_the_jobservers_metric_sources_report_as_the_references():
    """One job (Wide&Deep, 2 epochs of 4 batches) under a JobServer of 2
    executors in each package: the workers' BatchMetrics (a batch each, the
    same epoch/batch indices, examples and losses within 1e-5) and the
    entity's ServerMetrics (an owning executor an epoch plus the closing
    window: block counts, and the job's pulls, pushes and pulled bytes split
    by largest remainder) are the reference's."""
    from harmony_tpu.config.params import JobConfig as JaxJobConfig
    from harmony_tpu.config.params import TrainerParams as JaxTrainerParams
    from harmony_tpu.jobserver import JobServer as JaxJobServer
    from harmony_tpu.parallel import DevicePool as JaxDevicePool
    from harmony_tpu_torch.config.params import JobConfig, TrainerParams
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    def config(pkg, J, P):
        return J(job_id="m", app_type="dolphin", trainer=f"{pkg}.apps.widedeep:WideDeepTrainer",
                 params=P(num_epochs=2, num_mini_batches=4, app_params={
                     "vocab_size": 512, "num_slots": 4, "emb_dim": 4, "hidden": 8,
                     "step_size": 0.5}),
                 num_workers=1, user={"data_fn": f"{pkg}.apps.widedeep:make_synthetic",
                                      "data_args": {"n": 512, "vocab_size": 512,
                                                    "num_slots": 4}})

    def records(server, cfg):
        server.start()
        try:
            server.submit(cfg).result(timeout=300)
            batches = sorted(server.metrics.worker_batch_metrics(job_id="m"),
                             key=lambda m: (m.epoch_idx, m.batch_idx))
            owners = sorted({m.executor_id for m in server.metrics.server_metrics(job_id="m")},
                            key=lambda e: int(e.rsplit("-", 1)[1]))
            servers = sorted(((m.window_idx, owners.index(m.executor_id), m.num_blocks,
                               m.pull_count, m.push_count, m.pull_bytes)
                              for m in server.metrics.server_metrics(job_id="m")))
        finally:
            server.shutdown()
        return batches, servers

    got, got_s = records(JobServer(2, device_pool=DevicePool.virtual("cpu", 2)),
                         config("harmony_tpu_torch", JobConfig, TrainerParams))
    want, want_s = records(JaxJobServer(num_executors=2,
                                        device_pool=JaxDevicePool(jax.devices()[:2])),
                           config("harmony_tpu", JaxJobConfig, JaxTrainerParams))
    assert [(m.epoch_idx, m.batch_idx, m.num_examples, m.worker_id) for m in got] == \
        [(m.epoch_idx, m.batch_idx, m.num_examples, m.worker_id) for m in want]
    np.testing.assert_allclose([m.loss for m in got], [m.loss for m in want], rtol=0, atol=1e-5)
    assert all(m.batch_time_sec > 0 and m.comp_time_sec >= 0 for m in got)
    assert got_s == want_s and len(got_s) == 2 * 3
