"""harmony_tpu_torch's JobServer, schedulers, device pool, CLI presets and bench.

The concurrent trio (MLR, NMF and LDA submitted together, at a small size) runs
under the port's JobServer and under the reference's
``JobServer(num_executors=1, device_pool=DevicePool(jax.devices("cpu")[:1]))``,
and their per-batch primary metrics ("loss", LDA's "log_likelihood") are
compared. Tolerance: |port - reference| <= 1e-4 * max(1, |value|). The jobs
share nothing, so running them concurrently does not change what each
computes; each job's f32 sums run in another order in the two frameworks
(MLR's and NMF's products, the loss means), and LDA's draws are jax's bits, so
its assignments and counts are identical and only its logs may round apart.
"""
import json
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from harmony_tpu.config.params import JobConfig as JaxJobConfig
from harmony_tpu.config.params import TrainerParams as JaxTrainerParams
from harmony_tpu.jobserver.server import JobServer as JaxJobServer
from harmony_tpu.parallel.mesh import DevicePool as JaxDevicePool
from harmony_tpu_torch import bench, cli
from harmony_tpu_torch.apps import mlr, nmf
from harmony_tpu_torch.config.params import JobConfig, TableConfig, TrainerParams
from harmony_tpu_torch.jobserver.scheduler import (
    CarveScheduler,
    FifoExclusiveScheduler,
    ProcessCarveScheduler,
    ShareAllScheduler,
    make_scheduler,
)
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.parallel.mesh import DevicePool, Slot
from harmony_tpu_torch.runtime.master import ETMaster


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU = torch.device("cpu")
TIMEOUT = 120

# app -> (trainer params, data generator args), small
TRIO = {
    "mlr": ({"num_classes": 8, "num_features": 64, "features_per_partition": 16,
             "step_size": 0.5},
            {"n": 128, "num_features": 64, "num_classes": 8}),
    "nmf": ({"num_rows": 32, "num_cols": 48, "rank": 8, "step_size": 0.01},
            {"num_rows": 32, "num_cols": 48, "rank": 8}),
    "lda": ({"vocab_size": 64, "num_topics": 8, "num_docs": 32, "max_doc_len": 16},
            {"num_docs": 32, "vocab_size": 64, "num_topics": 8, "doc_len": 16}),
}
TRAINERS = {"mlr": "MLRTrainer", "nmf": "NMFTrainer", "lda": "LDATrainer"}


def _config(app, job_id=None, package="harmony_tpu_torch", epochs=2, batches=2,
            cls=JobConfig, params=TrainerParams, trainer=None, **app_extra):
    app_params, data_args = TRIO[app]
    return cls(job_id=job_id or app, app_type="dolphin",
               trainer=trainer or f"{package}.apps.{app}:{TRAINERS[app]}",
               params=params(num_epochs=epochs, num_mini_batches=batches,
                             app_params={**app_params, **app_extra}),
               num_workers=1,
               user={"data_fn": f"{package}.apps.{app}:make_synthetic",
                     "data_args": data_args})


def _server(scheduler=None):
    server = JobServer(1, scheduler=scheduler, device_pool=DevicePool([CPU]))
    server.start()
    return server


# -- the trio against the reference --------------------------------------------


def test_concurrent_trio_matches_the_reference_jobserver():
    ref = JaxJobServer(num_executors=1, device_pool=JaxDevicePool(jax.devices("cpu")[:1]))
    ref.start()
    try:
        futures = [ref.submit(_config(app, package="harmony_tpu", cls=JaxJobConfig,
                                      params=JaxTrainerParams)) for app in TRIO]
        for f in futures:
            f.result(timeout=TIMEOUT)
        want = {app: [m.loss for m in sorted(ref.metrics.worker_batch_metrics(job_id=app),
                                             key=lambda m: (m.epoch_idx, m.batch_idx))]
                for app in TRIO}
    finally:
        ref.shutdown(timeout=TIMEOUT)

    server = _server()
    try:
        results = {app: f.result(timeout=TIMEOUT)
                   for app, f in [(app, server.submit(_config(app))) for app in TRIO]}
    finally:
        server.shutdown(timeout=TIMEOUT)
    spans = [r["span"] for r in results.values()]
    assert max(s[0] for s in spans) < min(s[1] for s in spans)   # all three overlapped
    for app, r in results.items():
        (worker,) = r["workers"].values()
        got = worker["batch_losses"]
        assert len(got) == len(want[app]) == 4, app
        assert np.all(np.abs(np.subtract(got, want[app]))
                      <= 1e-4 * np.maximum(1.0, np.abs(want[app]))), (app, got, want[app])
    assert server.master.table_ids() == []   # model and local tables dropped


def _batch_losses(result):
    (worker,) = result["workers"].values()
    return worker["batch_losses"]


def test_concurrent_jobs_keep_to_their_own_tables():
    """Stress: eight NMF and LDA jobs at once, each with a model and a local
    table, the interpreter switching threads every 10 us. Every job's
    per-batch metrics equal its app's solo run bit for bit (tiny shapes: each
    sum runs in one order), so no step read or wrote another job's tables or
    lost an update; every table is dropped at the end."""
    server = _server()
    interval = sys.getswitchinterval()
    try:
        solo = {app: _batch_losses(server.submit(_config(app, f"solo-{app}"))
                                   .result(timeout=TIMEOUT)) for app in ("nmf", "lda")}
        sys.setswitchinterval(1e-5)
        futures = {f"{app}-{i}": (app, server.submit(_config(app, f"{app}-{i}")))
                   for i in range(4) for app in ("nmf", "lda")}
        got = {job_id: (app, _batch_losses(f.result(timeout=TIMEOUT)))
               for job_id, (app, f) in futures.items()}
    finally:
        sys.setswitchinterval(interval)
        server.shutdown(timeout=TIMEOUT)
    for job_id, (app, losses) in got.items():
        assert losses == solo[app], job_id
    assert server.master.table_ids() == []


# -- schedulers ----------------------------------------------------------------

_GATES = {}


class _Gated:
    """A trainer that waits at the gate named ``gate`` as its training starts,
    after its global init (which runs in a CPU TaskUnit: on a CPU executor
    the server meters those, one job's at a time while jobs contend)."""

    def __init__(self, gate, **kw):
        super().__init__(**kw)
        self.gate = gate

    def on_training_start(self, ctx, epoch):
        _GATES[self.gate].wait(timeout=30)
        super().on_training_start(ctx, epoch)


class GatedMLR(_Gated, mlr.MLRTrainer):
    pass


class GatedNMF(_Gated, nmf.NMFTrainer):
    pass


def _gated(app, gate, job_id):
    cls = {"mlr": "GatedMLR", "nmf": "GatedNMF"}[app]
    return _config(app, job_id, trainer=f"{__name__}:{cls}", gate=gate)


def test_share_all_runs_every_job_at_once():
    """Three jobs wait at one barrier of three in their global init: they pass
    only if all three run at the same time."""
    _GATES["share"] = threading.Barrier(3, timeout=30)
    server = _server()
    try:
        futures = [server.submit(_gated("mlr", "share", f"j{i}")) for i in range(3)]
        results = [f.result(timeout=TIMEOUT) for f in futures]
    finally:
        server.shutdown(timeout=TIMEOUT)
    assert [r["job_id"] for r in results] == ["j0", "j1", "j2"]
    assert not _GATES["share"].broken


def test_fifo_runs_one_job_at_a_time_in_order():
    server = _server("fifo")
    try:
        futures = [server.submit(_config("mlr", f"j{i}", epochs=1)) for i in range(3)]
        spans = [f.result(timeout=TIMEOUT)["span"] for f in futures]
    finally:
        server.shutdown(timeout=TIMEOUT)
    for earlier, later in zip(spans, spans[1:]):
        assert later[0] >= earlier[1]


def test_a_running_job_id_is_refused_and_its_tables_live_until_it_ends():
    _GATES["dup"] = threading.Event()
    server = _server()
    try:
        first = server.submit(_gated("nmf", "dup", "g"))
        with pytest.raises(ValueError, match="duplicate job id g"):
            server.submit(_gated("nmf", "dup", "g"))
        _GATES["dup"].set()
        first.result(timeout=TIMEOUT)
        assert server.master.table_ids() == []      # model and local table dropped
        assert server.submit(_config("nmf", "g")).result(timeout=TIMEOUT)["job_id"] == "g"
    finally:
        server.shutdown(timeout=TIMEOUT)


def test_a_job_holds_its_model_and_local_table_while_it_runs():
    _GATES["tables"] = threading.Event()
    server = _server()
    try:
        future = server.submit(_gated("nmf", "tables", "t"))
        for _ in range(300):
            if len(server.master.table_ids()) == 2:
                break
            threading.Event().wait(0.01)
        assert sorted(server.master.table_ids()) == ["t:nmf-local", "t:nmf-model"]
        _GATES["tables"].set()
        future.result(timeout=TIMEOUT)
        assert server.master.table_ids() == []
    finally:
        server.shutdown(timeout=TIMEOUT)


@pytest.mark.parametrize("broken,error", [
    ({"user": {}}, "data_fn"),                      # fails in setup
    ({"app_type": "bogus"}, "app_type"),           # fails building the entity
])
def test_a_failing_job_resolves_its_future_and_the_queue_moves_on(broken, error):
    server = _server("fifo")
    try:
        bad = server.submit(_config("mlr", "bad").replace(**broken))
        ok = server.submit(_config("mlr", "ok", epochs=1))
        with pytest.raises(Exception, match=error):
            bad.result(timeout=TIMEOUT)
        assert ok.result(timeout=TIMEOUT)["job_id"] == "ok"
        assert server.master.table_ids() == []
    finally:
        server.shutdown(timeout=TIMEOUT)


def test_server_lifecycle_and_scheduler_names():
    server = JobServer(1, device_pool=DevicePool([CPU]))
    with pytest.raises(RuntimeError, match="not accepting"):
        server.submit(_config("mlr"))
    server.start()
    with pytest.raises(RuntimeError, match="already started"):
        server.start()
    server.shutdown()
    assert server.state == "CLOSED"
    with pytest.raises(RuntimeError, match="not accepting"):
        server.submit(_config("mlr"))
    assert isinstance(make_scheduler("share_all"), ShareAllScheduler)
    assert isinstance(make_scheduler("fifo"), FifoExclusiveScheduler)
    # the carve schedulers came with the pod; the reference's names, nothing more
    assert type(make_scheduler("carve")) is CarveScheduler
    assert type(make_scheduler("pod_carve")) is ProcessCarveScheduler
    with pytest.raises(KeyError, match="unknown scheduler"):
        make_scheduler("pod_carve:1")


CARVE_SCRIPTS = {
    "carve": (dict(), ["a", "b", "c", "-a", "d", "-b", "-c", "-d"]),
    "carve-capped": (dict(max_share=2), ["a", "b", "c", "-b", "d", "-a", "-c"]),
    "pod_carve": (dict(), ["a", "b", "-a", "c", "d", "-b", "-c"]),
    "pod_carve-1": (dict(max_procs=1), ["a", "b", "c", "-a", "-b", "d", "-c", "-d"]),
}


@pytest.mark.parametrize("name", sorted(CARVE_SCRIPTS))
def test_carve_schedulers_slice_as_the_references(name):
    """The same arrivals and finishes through the reference's carve
    schedulers and the port's: the same launches, slices and queue."""
    from harmony_tpu.config.params import JobConfig as JaxJobConfig
    from harmony_tpu.jobserver import scheduler as ref

    kwargs, script = CARVE_SCRIPTS[name]
    execs = [f"executor-{i}" for i in range(6)]
    runs = []
    for mod, cfg in ((ref, JaxJobConfig), (None, JobConfig)):
        cls = {"carve": CarveScheduler, "pod_carve": ProcessCarveScheduler}[name.split("-")[0]]
        if mod is not None:
            cls = getattr(mod, cls.__name__)
        sched, launched = cls(**kwargs), []
        sched.bind(list(execs), lambda c, ex: launched.append((c.job_id, list(ex))))
        if name.startswith("pod_carve"):
            sched.set_process_map({e: i // 2 for i, e in enumerate(execs)})  # 3 processes
        for step in script:
            if step.startswith("-"):
                sched.on_job_finish(step[1:])
            else:
                sched.on_job_arrival(cfg(job_id=step, app_type="dolphin"))
        runs.append((launched, {j: sched.slice_of(j) for j in "abcd"},
                     sorted(c.job_id for c in sched.queued_jobs()), sched.idle_executors()))
    assert runs[0] == runs[1]
    assert runs[1][0], "nothing launched"


def test_the_card_is_the_default_pool():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default pool holds it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        JobServer(1)
    with pytest.raises(RuntimeError, match="--device cpu"):
        DevicePool()


def test_device_pool_leases():
    pool = DevicePool([CPU])
    slot = Slot(0, CPU)                          # leases are slots of devices
    assert pool.lease("a", 1) == [slot] and len(pool) == 1
    with pytest.raises(RuntimeError, match="need 1 devices, only 0 free"):
        pool.lease("b", 1)
    assert pool.lease_all("c") == [slot]         # shared leases coexist
    assert pool.overlapping_jobs("a") == ["c"] and pool.lease_of("c") == [slot]
    pool.release("a")
    assert pool.lease("b", 1) == [slot] and pool.lease_of("a") == []
    assert pool.devices == [CPU]
    with pytest.raises(ValueError, match="distinct"):
        DevicePool([CPU, "cpu"])


def test_master_places_tables_on_its_executors_device():
    master = ETMaster(DevicePool([CPU]))
    with pytest.raises(RuntimeError, match="cannot allocate 2 executors"):
        master.add_executors(2)
    assert master.executor_ids() == []           # all or nothing
    (ex,) = master.add_executors(1)
    table = master.create_table(TableConfig(table_id="t", capacity=4), [ex.id])
    assert table.device == CPU and master.table_ids() == ["t"]
    with pytest.raises(ValueError, match="exists"):
        master.create_table(TableConfig(table_id="t", capacity=4), [ex.id])
    master.drop_table("t")
    master.drop_table("t")
    assert master.table_ids() == []


# -- entry points ----------------------------------------------------------------


@pytest.mark.parametrize("app", ["mlr", "nmf", "lda"])
def test_cli_presets_run_on_the_cpu(app, capsys):
    assert cli.main(["run", app, "--device", "cpu", "--epochs", "2", "--batches", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (worker,) = out["result"]["workers"].values()
    assert len(worker["batch_losses"]) == 4 and all(np.isfinite(worker["batch_losses"]))
    assert cli.PRESETS[app]["trainer"].startswith("harmony_tpu_torch.apps.")


def test_bench_at_a_tiny_scale_on_the_cpu(capsys):
    assert bench.main(["--device", "cpu", "--scale", "0", "--baseline-scale", "0",
                       "--epochs", "1"]) == 0
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline", "cpu_rate", "mode",
            "accel_job_walls_s"} <= set(line)
    assert line["value"] > 0 and line["cpu_rate"] > 0 and line["unit"] == "samples/sec"
    assert sorted(line["accel_job_walls_s"]) == ["bench-lda", "bench-mlr", "bench-nmf"]
    assert "per-job: " in captured.err


@pytest.mark.parametrize("scale", [1.0, 0.125, 0.0])
def test_bench_configs_are_the_references(scale):
    """The port's trio is the repository bench's, field for field, at the
    measured scale, the baseline's and the floor every dataset is clamped to;
    only the package of the trainers and data functions differs."""
    import bench as reference

    ref_configs, ref_totals = reference.job_configs(scale)
    configs, totals = bench.job_configs(scale)
    assert totals == ref_totals
    assert (bench.EPOCHS, bench.BATCHES, bench.METRIC) == (
        reference.EPOCHS, reference.BATCHES, reference.METRIC)
    assert [c.job_id for c in configs] == [c.job_id for c in ref_configs]
    for mine, ref in zip(configs, ref_configs):
        assert (mine.app_type, mine.num_workers) == (ref.app_type, ref.num_workers)
        for field in ("num_epochs", "num_mini_batches", "comm_probe_period", "app_params"):
            assert getattr(mine.params, field) == getattr(ref.params, field), field
        assert mine.user["data_args"] == ref.user["data_args"]
        for path, ref_path in ((mine.trainer, ref.trainer),
                               (mine.user["data_fn"], ref.user["data_fn"])):
            assert path == ref_path.replace("harmony_tpu.", "harmony_tpu_torch.", 1)


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run goes to it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["run", "mlr"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main([])
