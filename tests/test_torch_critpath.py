"""The port's step-phase budget and critical path
(``harmony_tpu_torch/metrics/{phases,critpath}.py``), the manager's queries
and ``obs critpath`` / ``obs top`` against the reference's on the CPU.

* The pure math: ``split_device_phases``, ``classify``, ``dominant_phase``,
  ``epoch_critical_path`` and ``analyze`` give the reference's results,
  exactly, on seeded inputs.
* The store under a fake clock: ``time.monotonic`` is replaced alike in both
  modules and the same feeds (sibling workers, elastic attempts, a shrink
  that overfills its wall) give snapshots within 1e-12, and the registry's
  ``harmony_phase_budget_seconds`` the same bytes.
* The port's worker feeds a budget that keeps the invariant (phases and
  residual sum to the wall) in both step modes; the ledger join carries the
  fractions and a class; the straggler report and fault counters are the
  reference's on the same records.
* The renderers, and ``obs top`` / ``obs critpath`` against a live
  JobServer: the reference's lines from the same STATUS. The same for the
  scrape cycle's ``obs doctor`` and ``obs incidents`` (seeded diagnoses and
  incident chains, then a live JobServer after one scrape cycle), and ``obs
  metrics`` against an exporter: the reference CLI's lines.

No assertion reads the wall clock.
"""
import json

import numpy as np
import pytest
import torch

from harmony_tpu import cli as jcli
from harmony_tpu.metrics import critpath as jcrit
from harmony_tpu.metrics import manager as jman
from harmony_tpu.metrics import phases as jphases
from harmony_tpu.metrics import registry as jreg
from harmony_tpu.metrics.collector import BatchMetrics as JBatch
from harmony_tpu_torch import cli as tcli
from harmony_tpu_torch.apps import mlr
from harmony_tpu_torch.config.params import TrainerParams
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.trainer import TrainerContext
from harmony_tpu_torch.dolphin.worker import WorkerTasklet
from harmony_tpu_torch.metrics import accounting as tacct
from harmony_tpu_torch.metrics import critpath as tcrit
from harmony_tpu_torch.metrics import manager as tman
from harmony_tpu_torch.metrics import phases as tphases
from harmony_tpu_torch.metrics import registry as treg
from harmony_tpu_torch.metrics.collector import BatchMetrics as TBatch
from harmony_tpu_torch.table.table import DenseTable, TableSpec

TOL = 1e-12
CLASSES = ("input-bound", "comm-bound", "dispatch-bound", "compute-bound", "balanced")


class FakeTime:
    def __init__(self, t: float = 5000.0) -> None:
        self.t = t

    def monotonic(self) -> float:
        return self.t


@pytest.fixture()
def fresh():
    def reset():
        treg.set_registry(treg.MetricRegistry())
        jreg.set_registry(jreg.MetricRegistry())
        tphases.reset_budget()
        jphases.reset_budget()
        tacct.reset_ledger()

    reset()
    yield
    reset()


@pytest.fixture()
def clock(monkeypatch):
    fake = FakeTime()
    monkeypatch.setattr(tphases, "time", fake)
    monkeypatch.setattr(jphases, "time", fake)
    return fake


def assert_close(got, want, path="row"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


# -- the pure math ---------------------------------------------------------------


def _split_cases(seed, n=40):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        kw = {"dispatch_sec": float(rng.choice([0.0, rng.random(), -0.1]))}
        mode = int(rng.integers(4))
        if mode == 1:
            kw["measured"] = tuple(float(v) for v in rng.normal(0.01, 0.02, 3))
        elif mode == 2:
            kw["probe_split"] = tuple(float(v) for v in rng.normal(0.01, 0.03, 2))
        elif mode == 3:
            kw["probe_split"] = tuple(float(v) for v in rng.random(2) * 0.2)
            kw["flops_per_step"] = float(rng.integers(1, 10**10))
            kw["peak_flops"] = float(rng.choice([0.0, 1e10, 1e12]))
            kw["devices"] = int(rng.integers(0, 4))
        yield float(rng.choice([0.0, rng.random() * 3])), int(rng.integers(-1, 12)), kw


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_device_phases_is_the_references_exactly(seed):
    for work, steps, kw in _split_cases(seed):
        assert tphases.split_device_phases(work, steps, **kw) == \
            jphases.split_device_phases(work, steps, **kw), (work, steps, kw)


def _fractions(rng):
    names = (*tphases.PHASES, tphases.RESIDUAL)
    v = rng.dirichlet(np.full(len(names), 0.4))
    keep = rng.random(len(names)) < 0.8
    return {p: float(x) for p, x, k in zip(names, v, keep) if k}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classify_and_the_dominant_phase_are_the_references(seed):
    rng = np.random.default_rng(seed)
    fixed = [{"input_wait": 0.4, "pull_comm": 0.5}, {"pull_comm": 0.3, "push_comm": 0.1},
             {"host_dispatch": 0.3}, {"compute": 0.6}, {}, {"residual": 1.0}]
    for fr in fixed + [_fractions(rng) for _ in range(60)]:
        assert tcrit.classify(fr) == jcrit.classify(fr) in CLASSES
        assert tcrit.comm_fraction(fr) == jcrit.comm_fraction(fr)
        for res in (True, False):
            assert tcrit.dominant_phase(fr, res) == jcrit.dominant_phase(fr, res)


def _budget_feeds(seed):
    """(job, attempt, worker, epoch, wall, phases, clock step) feeds: sibling
    workers, an elastic restart under a new attempt, negative and overfull
    phases."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(50):
        job = ["a", "b"][int(rng.integers(2))]
        attempt = job if i < 30 or job == "a" else f"{job}@a1"
        ph = {p: float(v) for p, v in zip(tphases.PHASES[:5], rng.normal(0.2, 0.25, 5))}
        if rng.random() < 0.2:
            ph = {"compute": float(rng.random()), "bogus": 0.1}
        out.append((job, attempt, f"w{int(rng.integers(3))}", int(rng.integers(6)),
                    float(rng.random() * 2), ph, float(rng.exponential(1.5))))
    return out


def _replay(store, clock, feeds):
    for job, attempt, worker, epoch, wall, ph, step in feeds:
        clock.t += step
        store.observe_epoch(job, attempt, worker, epoch, wall, ph)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_budget_store_under_a_fake_clock_matches_the_reference(fresh, clock, seed):
    feeds = _budget_feeds(seed)
    t0 = clock.t
    mine, ref = tphases.PhaseBudgetStore(), jphases.PhaseBudgetStore()
    _replay(mine, clock, feeds)
    end = clock.t
    clock.t = t0
    _replay(ref, clock, feeds)
    stragglers = {"a": {"ratio": 1.7}}
    for window in (None, 2.0, 10.0, 1e6):
        for later in (0.0, 4.0):
            clock.t = end + later
            got, want = mine.snapshot(window), ref.snapshot(window)
            assert_close(got, want)
            assert_close(mine.snapshot_memoized(window), want)
            assert tcrit.analyze(got, stragglers) == jcrit.analyze(want, stragglers)
            for row in got.values():
                assert tcrit.epoch_critical_path(row, 3) == \
                    jcrit.epoch_critical_path(row, 3)
                if row["wall_sec"] > 0:
                    assert abs(sum(row["fractions"].values()) - 1.0) <= 7 * 5e-7
    # a memoized read holds until a feed lands or its 0.2 s lapse
    first = mine.snapshot_memoized(60.0)
    assert mine.snapshot_memoized(60.0) is first
    clock.t += 0.3
    assert mine.snapshot_memoized(60.0) is not first
    mine.clear()
    assert mine.snapshot() == {}


@pytest.mark.parametrize("env", [("", ""), ("7", ""), ("", "9"), ("bad", "4")])
def test_the_budget_window_reads_its_knobs_as_the_reference(monkeypatch, env):
    monkeypatch.setenv(tphases.ENV_PHASE_WINDOW, env[0])
    monkeypatch.setenv(tacct.ENV_WINDOW, env[1])
    assert tphases.phase_window_seconds() == jphases.phase_window_seconds()


def test_the_budget_gauge_exposes_the_references_bytes(fresh, clock):
    feeds = _budget_feeds(9)
    t0 = clock.t
    _replay(tphases.budget(), clock, feeds)
    end = clock.t
    clock.t = t0
    _replay(jphases.budget(), clock, feeds)
    assert clock.t == end and tphases.peek_budget() is tphases.budget()
    text = treg.get_registry().expose()
    assert text == jreg.get_registry().expose()
    assert 'phase="residual"' in text and treg.lint_exposition(text) == []
    tphases.reset_budget()
    assert tphases.peek_budget() is None


# -- the manager -------------------------------------------------------------------


def _records(seed):
    rng = np.random.default_rng(seed)
    for i in range(40):
        job = ["j", "k", "solo"][int(rng.integers(3))]
        worker = "solo/w0" if job == "solo" else f"{job}/w{int(rng.integers(3))}"
        yield dict(job_id=job, worker_id=worker, epoch_idx=i // 8, batch_idx=i % 8,
                   num_examples=int(rng.integers(1, 64)),
                   batch_time_sec=float(rng.exponential(0.02)))


@pytest.mark.parametrize("seed", [0, 1])
def test_the_straggler_report_and_throughput_are_the_references(seed):
    mine, ref = tman.MetricManager(), jman.MetricManager()
    for m in (mine, ref):
        m.start_collection()
    for rec in _records(seed):
        mine.on_metric(TBatch(**rec))
        ref.on_metric(JBatch(**rec))
    assert mine.straggler_report() == ref.straggler_report()
    assert mine.straggler_report("j") == ref.straggler_report("j")
    assert mine.aggregate_throughput() == ref.aggregate_throughput()
    assert mine.aggregate_throughput("k") == ref.aggregate_throughput("k")
    assert mine.straggler_report()["solo"]["ratio"] == 1.0


def test_fault_counters_are_the_faults_modules():
    from harmony_tpu_torch import faults

    assert tman.MetricManager().fault_counters() == faults.all_counters()


def _worker(job_id, fused, epochs=3):
    trainer = mlr.MLRTrainer(num_classes=8, num_features=64, features_per_partition=32)
    table = DenseTable(TableSpec(trainer.model_table_config(num_blocks=8)), "cpu")
    x, y = mlr.make_synthetic(64, 64, 8)
    return WorkerTasklet(job_id, TrainerContext(
        params=TrainerParams(num_epochs=epochs, num_mini_batches=2, fused_step=fused),
        model_table=table), trainer, TrainingDataProvider([x, y], 2))


def _assert_invariant(row):
    wall = row["wall_sec"]
    assert abs(sum(row["phases"].values()) - wall) <= 7 * 5e-7 + 5e-7
    assert all(v >= 0.0 for v in row["phases"].values())
    assert all(0.0 <= f <= 1.0 for f in row["fractions"].values())
    for wrow in row["per_worker"].values():
        assert abs(sum(wrow["phases"].values()) - wrow["wall_sec"]) <= 7 * 5e-7 + 5e-7


@pytest.mark.parametrize("fused", [True, False])
def test_the_workers_feeds_keep_the_budget_invariant(fresh, fused):
    w = _worker(f"budget-{fused}", fused)
    result = w.run()
    row = tphases.peek_budget().snapshot(window_sec=300.0)[f"budget-{fused}"]
    _assert_invariant(row)
    assert row["epochs"] == 3 and list(row["per_worker"]) == ["worker-0"]
    assert row["phases"]["compute"] > 0.0
    assert row["wall_sec"] == pytest.approx(sum(result["epoch_seconds"]), abs=1e-5)
    mgr = tman.MetricManager()
    ledger = mgr.tenant_ledger()[f"budget-{fused}"]
    assert ledger["phase_class"] in CLASSES and set(ledger["phases"]) == set(row["phases"])
    assert ledger["straggler_ratio"] is None   # no BatchMetrics without a collector
    assert ledger["device_seconds"] <= row["wall_sec"] + 1e-6
    pb = mgr.phase_budget()[f"budget-{fused}"]
    assert pb["classification"] == ledger["phase_class"]
    assert [c["epoch"] for c in pb["critical_path"]] == [0, 1, 2]


# -- rendering -----------------------------------------------------------------------


def _budget_rows():
    names = (*tphases.PHASES, tphases.RESIDUAL)
    return {
        "j": {"attempt": "j@a1", "classification": "comm-bound", "wall_sec": 2.0,
              "epochs": 2, "phases": {p: 0.0 for p in names},
              "fractions": {**{p: 0.0 for p in names}, "pull_comm": 0.6, "compute": 0.4},
              "per_worker": {"w0": {}},
              "critical_path": [{"epoch": e, "worker": "w0", "phase": "pull_comm",
                                 "wall_sec": 1.0} for e in range(8)],
              "straggler_ratio": 1.0},
        "k": {"attempt": "k", "classification": "balanced", "wall_sec": 9.5, "epochs": 1,
              "phases": {"compute": 1.234, "residual": 8.266},
              "fractions": {"compute": 0.13, "residual": 0.87}, "per_worker": {},
              "critical_path": [], "straggler_ratio": None},
    }


@pytest.mark.parametrize("with_tenants", [False, True])
def test_obs_critpath_renders_the_references_lines(with_tenants):
    budget = _budget_rows()
    tenants = {"j": {"async": {"enabled": True, "staleness_bound": 2, "max_lag": 1,
                               "overlapped_comm_sec": 0.5, "exposed_wait_sec": 0.125}},
               "k": {"async": {"enabled": False}}} if with_tenants else None
    assert tcli._render_critpath(budget, tenants) == jcli._render_critpath(budget, tenants)
    assert tcli._render_critpath({}) == jcli._render_critpath({})


def test_obs_top_and_critpath_against_a_live_jobserver(fresh, monkeypatch, capsys):
    """``cli obs top`` and ``obs critpath`` (and ``--json``) against a
    JobServer's TCP port after a small job: the reference's renderers on the
    same STATUS (the ledger's clock held still, so both reads agree)."""
    from harmony_tpu_torch.jobserver.client import CommandSender
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    server = JobServer(1, device_pool=DevicePool([torch.device("cpu")]))
    server.start()
    try:
        port = server.serve_tcp(0)
        config = tcli.build_config("mlr", tcli.build_parser().parse_args(
            ["run", "mlr", "--job-id", "obs-j", "--epochs", "2", "--batches", "2",
             "--set", "num_features=16", "--set", "features_per_partition=8",
             "--set", "num_classes=4", "--data", "n=64", "--data", "num_features=16",
             "--data", "num_classes=4"]))
        server.submit(config).result(timeout=120)
        monkeypatch.setattr(tacct, "time", FakeTime(tacct.time.monotonic()))
        status = CommandSender(port, timeout=30).send_status_command()
        assert status["tenants"]["obs-j"]["steps_total"] == 4
        capsys.readouterr()
        assert tcli.main(["obs", "top", "--port", str(port)]) == 0
        top = capsys.readouterr().out.splitlines()
        assert top == (jcli._render_overload(status["overload"])
                       + jcli._render_tenant_top(status["tenants"]))
        assert tcli.main(["obs", "critpath", "--port", str(port)]) == 0
        assert capsys.readouterr().out.splitlines() == jcli._render_critpath(
            status["phase_budget"], status["tenants"])
        assert tcli.main(["obs", "top", "--json", "--port", str(port)]) == 0
        assert json.loads(capsys.readouterr().out) == status["tenants"]
        assert tcli.main(["obs", "critpath", "--json", "--port", str(port)]) == 0
        assert json.loads(capsys.readouterr().out) == status["phase_budget"]
        for what, item in (("flight", "6.4"), ("plan", "5.2")):
            assert tcli.main(["obs", what, "--port", str(port)]) == 2
            assert f"ROADMAP A item {item}" in capsys.readouterr().err
    finally:
        server.shutdown(timeout=120)


def _diagnoses(seed, n=6):
    rng = np.random.default_rng(seed)
    rules = ("straggler", "slo_breach", "infra_suspect", "control_overload")
    out = []
    for i in range(n):
        job = None if i % 3 == 2 else f"job{int(rng.integers(3))}"
        out.append({"rule": rules[int(rng.integers(len(rules)))], "job": job,
                    "target": None if job else "pod:1", "ts": 1_700_000_000.0 + 7 * i,
                    "confidence": float(rng.uniform(0.3, 1.0)),
                    "summary": f"summary {i} of seed {seed}"})
    return out


def _history(seed, gaps):
    rng = np.random.default_rng(seed)
    return {"series": int(rng.integers(1, 99)), "points": int(rng.integers(99, 999)),
            "window_sec": 900.0, "resolution_sec": 5.0, "targets": ["leader", "pod:1"],
            "gap_marks": gaps, "restarts": 1, "scraper": {"cycles": 12}}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("empty", [False, True])
def test_obs_doctor_renders_the_references_lines(seed, empty):
    diags = [] if empty else _diagnoses(seed)
    for gaps in (0, 3):
        assert tcli._render_doctor(diags, _history(seed, gaps)) == \
            jcli._render_doctor(diags, _history(seed, gaps))
    assert tcli._render_doctor([], {}) == jcli._render_doctor([], {})


def _incidents(seed):
    rng = np.random.default_rng(seed)
    roles = ("trigger", "diagnosis", "action", "resolution")
    incs = []
    for i in range(3):
        t0 = 1_700_000_000.0 + 30 * i
        chain = [{"role": roles[min(k, 3)] if rng.random() < 0.8 else "trigger",
                  "kind": "slo", "src": "joblog", "ts": t0 + float(rng.uniform(0, 9)) * k,
                  "summary": f"edge {k}"} for k in range(int(rng.integers(1, 6)))]
        resolved = i < 2
        incs.append({"incident_id": f"job{i}:slo:{int(t0 * 1000)}", "subject": f"job{i}",
                     "status": "resolved" if resolved else "open",
                     "verdict": "recovered" if resolved else None,
                     "mttd_sec": 0.0, "mitigate_sec": 2.5 if i else None,
                     "mttr_sec": 9.125 if resolved else None, "chain": chain})
    return {"open": 1, "mitigating": 0, "resolved": 2, "adopted": seed, "window_sec": 120.0,
            "mttr_mean_sec": 9.125, "incidents": incs}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_obs_incidents_renders_the_references_lines(seed):
    inc = _incidents(seed)
    assert tcli._render_incidents(inc) == jcli._render_incidents(inc)
    quiet = {**inc, "incidents": []}
    assert tcli._render_incidents(quiet) == jcli._render_incidents(quiet)
    assert tcli._render_incidents({}) == jcli._render_incidents({})


def test_obs_doctor_incidents_and_metrics_against_a_live_jobserver(fresh, monkeypatch, capsys):
    """After a small job and one scrape cycle (driven, the period held long):
    ``obs doctor`` and ``obs incidents`` (and ``--json``) against the
    JobServer's port print the reference's renderings of the same STATUS;
    ``obs metrics`` against the server's exporter lists the job's tenant
    samples, and against a fixed registry prints the reference CLI's lines."""
    from harmony_tpu_torch.jobserver import joblog as tjoblog
    from harmony_tpu_torch.jobserver.client import CommandSender
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.metrics import exporter as texp
    from harmony_tpu_torch.parallel.mesh import DevicePool

    monkeypatch.setenv("HARMONY_METRICS_PORT", "0")
    monkeypatch.setenv("HARMONY_OBS_SCRAPE_PERIOD", "3600")
    server = JobServer(1, device_pool=DevicePool([torch.device("cpu")]))
    server.start()
    fixed = []
    try:
        port = server.serve_tcp(0)
        config = tcli.build_config("mlr", tcli.build_parser().parse_args(
            ["run", "mlr", "--job-id", "obs-d", "--epochs", "2", "--batches", "2",
             "--set", "num_features=16", "--set", "features_per_partition=8",
             "--set", "num_classes=4", "--data", "n=64", "--data", "num_features=16",
             "--data", "num_classes=4"]))
        server.submit(config).result(timeout=120)
        tjoblog.record_event("obs-d", "slo", attainment=0.25, target=1e9)
        server._history_scraper.poll_once()
        status = CommandSender(port, timeout=30).send_status_command()
        assert status["metrics_port"] == server.metrics_exporter.port
        assert status["history"]["scraper"]["cycles"] == 1
        assert "leader" in status["history"]["targets"]
        assert any(i["subject"] == "obs-d" for i in status["incidents"]["incidents"])
        capsys.readouterr()
        assert tcli.main(["obs", "doctor", "--port", str(port)]) == 0
        assert capsys.readouterr().out.splitlines() == jcli._render_doctor(
            status["diagnoses"], status["history"])
        assert tcli.main(["obs", "incidents", "--port", str(port)]) == 0
        out = capsys.readouterr().out
        assert out.splitlines() == jcli._render_incidents(status["incidents"])
        assert "subject=obs-d" in out
        assert tcli.main(["obs", "doctor", "--json", "--port", str(port)]) == 0
        assert json.loads(capsys.readouterr().out) == {"diagnoses": status["diagnoses"],
                                                       "history": status["history"]}
        assert tcli.main(["obs", "incidents", "--json", "--port", str(port)]) == 0
        assert json.loads(capsys.readouterr().out) == status["incidents"]
        url = f"http://127.0.0.1:{server.metrics_exporter.port}"
        assert tcli.main(["obs", "metrics", "--url", url]) == 0
        assert 'job=obs-d' in capsys.readouterr().out
        monkeypatch.setenv("HARMONY_METRICS_URL", url)
        assert tcli.main(["obs", "metrics"]) == 0
        assert "harmony_tenant_" in capsys.readouterr().out
        monkeypatch.delenv("HARMONY_METRICS_URL")
        assert tcli.main(["obs", "metrics"]) == 2
        assert "HARMONY_METRICS_URL" in capsys.readouterr().err
        # the same registry's bytes through both packages' CLIs
        reg = treg.MetricRegistry()
        reg.counter("harmony_x_total", "x", ("op",)).labels(op="a").inc(3)
        reg.histogram("harmony_y_seconds", "y", buckets=(0.1, 1.0)).observe(0.5)
        fixed.append(texp.MetricsExporter(0, registry=reg, host="127.0.0.1").start())
        assert tcli.main(["obs", "metrics", "--url", fixed[0].url]) == 0
        mine = capsys.readouterr().out
        assert jcli.main(["obs", "metrics", "--url", fixed[0].url]) == 0
        assert mine == capsys.readouterr().out and "harmony_x_total [counter]" in mine
    finally:
        for exp in fixed:
            exp.stop()
        server.shutdown(timeout=120)
        tjoblog.clear_events("obs-d")
    assert server.metrics_exporter is None
