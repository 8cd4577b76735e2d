"""The port's tenant ledger (``harmony_tpu_torch/metrics/accounting.py``) and
its worker feeds against the reference's (``harmony_tpu/metrics/
accounting.py``, ``harmony_tpu/dolphin/worker.py``) on the CPU.

* The store under a fake clock: ``time.monotonic`` is replaced alike in both
  modules, the same seeded sequence of feeds goes into a ``LedgerStore`` of
  each, and every snapshot (several windows, with and without a peak) agrees
  within 1e-12; the registry's callback gauges expose the same bytes.
* The SLO check: the same breach, recovery and re-arm fire the same joblog
  events from both packages' workers.
* A job on both workers: the same small MLR job leaves ledger rows with the
  same steps, examples, table bytes and table bindings, and the same fields;
  the port's ``mfu`` and FLOPs are None (nothing compiles a program to count).
* ``obs top``'s renderer gives the reference's lines for the same rows.

No assertion reads the wall clock.
"""
import jax
import numpy as np
import pytest
import torch

from harmony_tpu import cli as jcli
from harmony_tpu.apps import mlr as jmlr
from harmony_tpu.config.params import TrainerParams as JTrainerParams
from harmony_tpu.dolphin import TrainerContext as JTrainerContext
from harmony_tpu.dolphin import TrainingDataProvider as JData
from harmony_tpu.dolphin import WorkerTasklet as JWorker
from harmony_tpu.jobserver import joblog as jjoblog
from harmony_tpu.metrics import accounting as jacct
from harmony_tpu.metrics import phases as jphases
from harmony_tpu.metrics import registry as jreg
from harmony_tpu.parallel import build_mesh
from harmony_tpu.table import DenseTable as JDenseTable
from harmony_tpu.table import TableSpec as JTableSpec
from harmony_tpu_torch import cli as tcli
from harmony_tpu_torch.apps import mlr as tmlr
from harmony_tpu_torch.config.params import TrainerParams
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.trainer import TrainerContext
from harmony_tpu_torch.dolphin.worker import WorkerTasklet
from harmony_tpu_torch.jobserver import joblog as tjoblog
from harmony_tpu_torch.metrics import accounting as tacct
from harmony_tpu_torch.metrics import phases as tphases
from harmony_tpu_torch.metrics import registry as treg
from harmony_tpu_torch.table.table import DenseTable, TableSpec

TOL = 1e-12


class FakeTime:
    """``time.monotonic`` under the test's control."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def monotonic(self) -> float:
        return self.t


@pytest.fixture()
def fresh_obs():
    """Fresh registries, ledgers, budgets and joblog events in both
    packages: the accounting plane keeps process-wide state on all four."""
    def reset():
        treg.set_registry(treg.MetricRegistry())
        jreg.set_registry(jreg.MetricRegistry())
        for mod in (tacct, jacct):
            mod.reset_ledger()
        for mod in (tphases, jphases):
            mod.reset_budget()
        tjoblog.clear_events()
        jjoblog.clear_events()

    reset()
    yield
    reset()


@pytest.fixture()
def clock(monkeypatch):
    fake = FakeTime()
    monkeypatch.setattr(tacct, "time", fake)
    monkeypatch.setattr(jacct, "time", fake)
    return fake


def assert_close(got, want, path="row"):
    """Equal structures; numbers within TOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)) and abs(got - want) <= TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _feeds(seed):
    """A seeded sequence of (method, args, kwargs, clock step) feeds."""
    rng = np.random.default_rng(seed)
    jobs = ["j0", "j1", "j2"]
    out = [("bind_table", ("t-j0", "j0", "j0"), {}, 0.0),
           ("bind_table", ("t-j1", "j1", "j1@a1"), {}, 0.0),
           ("set_slo_target", ("j1", "j1@a1", 50.0), {}, 0.0)]
    for _ in range(60):
        job = jobs[int(rng.integers(3))]
        kind = int(rng.integers(10))
        step = float(rng.exponential(2.0))
        if kind < 4:
            flops = None if rng.random() < 0.5 else float(rng.integers(1, 10**9))
            out.append(("observe_steps", (job, job, f"w{int(rng.integers(2))}"),
                        dict(steps=int(rng.integers(1, 9)), device_sec=float(rng.random()),
                             examples=int(rng.integers(1, 500)), flops_per_step=flops,
                             input_wait_sec=float(rng.random() * 0.1),
                             devices=int(rng.integers(1, 5))), step))
        elif kind == 4:
            out.append(("record_input_wait", (job, job, float(rng.random())), {}, step))
        elif kind == 5:
            out.append(("set_resident", (job, job, ["table", "input"][int(rng.integers(2))],
                                         int(rng.integers(0, 10**6))), {}, step))
        elif kind == 6:
            out.append(("record_table_bytes", (f"t-{job}", ["move", "chkp_write"][
                int(rng.integers(2))], int(rng.integers(-5, 10**5))), {}, step))
        elif kind == 7:
            out.append(("record_job_bytes", (job, "chkp_read", int(rng.integers(0, 10**5))),
                        {}, step))
        elif kind == 8:
            out.append(("set_async_state", (job, job),
                        dict(available=bool(rng.integers(2)), enabled=bool(rng.integers(2)),
                             bound=int(rng.integers(3)), max_lag=int(rng.integers(3)),
                             exposed_wait_sec=float(rng.random()),
                             overlapped_comm_sec=float(rng.random())), step))
        else:
            out.append(("record_slo_event", (job,), {}, step))
    out.append(("set_serving_state", ("j2",),
                dict(enabled=True, qps=123.456789, p50_ms=1.25, p99_ms=None,
                     slo_p99_ms=5.0, batch_occupancy=0.5, cache_hit_rate=None), 0.5))
    out.append(("set_slo_target", ("j0", "j0", None), {}, 0.0))
    return out


def _replay(store, clock, feeds):
    for name, args, kw, step in feeds:
        clock.t += step
        getattr(store, name)(*args, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_store_under_a_fake_clock_matches_the_reference(fresh_obs, clock, monkeypatch,
                                                           seed):
    feeds = _feeds(seed)
    t0 = clock.t
    mine, ref = tacct.LedgerStore(), jacct.LedgerStore()
    _replay(mine, clock, feeds)
    end = clock.t
    clock.t = t0
    _replay(ref, clock, feeds)
    assert clock.t == end
    for peak in (None, 1e12):
        monkeypatch.setattr(tacct, "_peak_flops", lambda peak=peak: peak)
        monkeypatch.setattr(jacct, "_peak_flops", lambda peak=peak: peak)
        for window in (None, 1.0, 5.0, 30.0, 1e6):
            for later in (0.0, 3.0):
                clock.t = end + later
                assert_close(mine.snapshot(window), ref.snapshot(window))
    mine.clear()
    assert mine.snapshot() == {}


@pytest.mark.parametrize("env", ["", "abc", "0.25", "600", "-3"])
def test_the_window_and_slo_knobs_read_alike(monkeypatch, env):
    monkeypatch.setenv(tacct.ENV_WINDOW, env)
    monkeypatch.setenv(tacct.ENV_SLO, env)
    assert tacct.window_seconds() == jacct.window_seconds()
    assert tacct.slo_target_from_env() == jacct.slo_target_from_env()


def test_the_ledgers_callback_gauges_expose_the_references_bytes(fresh_obs, clock):
    feeds = _feeds(7)
    t0 = clock.t
    _replay(tacct.ledger(), clock, feeds)
    end = clock.t
    clock.t = t0
    _replay(jacct.ledger(), clock, feeds)
    assert tacct.peek_ledger() is tacct.ledger()
    text = treg.get_registry().expose()
    assert text == jreg.get_registry().expose()
    assert treg.lint_exposition(text) == []
    assert "harmony_tenant_device_seconds_total{" in text and clock.t == end
    tacct.reset_ledger()
    assert tacct.peek_ledger() is None


def _port_worker(job_id, epochs=1, target=0.0, batches=2, **modes):
    trainer = tmlr.MLRTrainer(num_classes=4, num_features=8, features_per_partition=4)
    table = DenseTable(TableSpec(trainer.model_table_config(num_blocks=8)), "cpu")
    x, y = tmlr.make_synthetic(16, 8, 4)
    return WorkerTasklet(job_id, TrainerContext(
        params=TrainerParams(num_epochs=epochs, num_mini_batches=batches,
                             target_samples_per_sec=target, **modes),
        model_table=table), trainer, TrainingDataProvider([x, y], batches))


def _ref_worker(job_id, epochs=1, target=0.0, batches=2, **modes):
    mesh = build_mesh(jax.devices()[:1])
    trainer = jmlr.MLRTrainer(num_classes=4, num_features=8, features_per_partition=4)
    table = JDenseTable(JTableSpec(trainer.model_table_config(num_blocks=8)), mesh)
    x, y = jmlr.make_synthetic(16, 8, 4)
    return JWorker(job_id, JTrainerContext(
        params=JTrainerParams(num_epochs=epochs, num_mini_batches=batches,
                              target_samples_per_sec=target, **modes),
        model_table=table), trainer, JData([x, y], batches), mesh)


def _slo_events(joblog, job):
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in joblog.job_events(job) if e["kind"] == "slo"]


def test_a_breach_its_recovery_and_its_rearm_fire_the_references_events(fresh_obs):
    workers = []
    for make, joblog in ((_port_worker, tjoblog), (_ref_worker, jjoblog)):
        w = make("re-j", target=1e15)
        w.run()
        joblog.clear_events("re-j")
        w._slo_below, w._slo_fired = 0, False
        for epoch in range(3):
            w._check_slo(epoch, epoch_examples=1, epoch_sec=1.0)
        w._check_slo(3, epoch_examples=10 ** 18, epoch_sec=1.0)   # recovers
        for epoch in range(4, 7):
            w._check_slo(epoch, epoch_examples=1, epoch_sec=1.0)
        workers.append(_slo_events(joblog, "re-j"))
    assert len(workers[0]) == 2 and workers[0] == workers[1]
    assert [e["epoch"] for e in workers[0]] == [2, 6]
    assert (tacct.ledger().snapshot()["re-j"]["slo"]["events"]
            == jacct.ledger().snapshot()["re-j"]["slo"]["events"] == 2)


def test_a_sustained_breach_fires_one_event_in_both(fresh_obs):
    got = []
    for make, joblog, acct in ((_port_worker, tjoblog, tacct), (_ref_worker, jjoblog, jacct)):
        make("slo-j", epochs=5, target=1e15).run()
        events = _slo_events(joblog, "slo-j")
        assert len(events) == 1 and events[0]["attainment"] < 0.9
        got.append({k: events[0][k] for k in ("kind", "attempt", "epoch", "target_sps",
                                               "window_epochs")})
        row = acct.ledger().snapshot()["slo-j"]
        assert row["slo"]["events"] == 1 and row["slo"]["target_sps"] == 1e15
    assert got[0] == got[1] == {"kind": "slo", "attempt": "slo-j", "epoch": 2,
                                "target_sps": 1e15, "window_epochs": 3}


def test_the_env_target_overrides_the_jobs_in_both(fresh_obs, monkeypatch):
    monkeypatch.setenv(tacct.ENV_SLO, "12345.0")
    assert _port_worker("env-j")._slo_target == _ref_worker("env-j")._slo_target == 12345.0


@pytest.mark.parametrize("epochs,batches,modes", [
    (2, 2, {}), (3, 4, {}), (2, 2, {"fused_step": False}),
    (2, 2, {"async_step": True, "staleness_bound": 0})])
def test_a_job_on_both_workers_leaves_the_same_ledger_row(fresh_obs, epochs, batches, modes):
    _port_worker("feed-j", epochs=epochs, batches=batches, **modes).run()
    _ref_worker("feed-j", epochs=epochs, batches=batches, **modes).run()
    mine, ref = tacct.ledger(), jacct.ledger()
    (row,), (want,) = mine.snapshot().values(), ref.snapshot().values()
    assert set(row) == set(want)
    for k in ("job", "attempt", "workers", "devices", "steps", "examples", "steps_total",
              "examples_total", "window_sec", "bytes", "slo"):
        assert row[k] == want[k], k
    # the async lever's state: available (a dense all-pull table), on as asked
    for k in ("available", "enabled", "staleness_bound", "max_lag"):
        assert row["async"][k] == want["async"][k], k
    assert row["async"]["enabled"] == bool(modes.get("async_step"))
    assert row["steps"] == epochs * batches and row["examples"] == epochs * 16
    assert row["resident"]["table"] == want["resident"]["table"] == 4 * 8 * 4
    table_id = tmlr.MLRTrainer(num_classes=4, num_features=8,
                               features_per_partition=4).model_table_config().table_id
    assert mine._tables == ref._tables == {table_id: "feed-j"}
    # no FLOP count in the port: mfu and flops are unknown, never 0
    assert row["mfu"] is None and row["flops_per_step"] is None and row["model_flops"] is None
    assert want["mfu"] is None   # the reference's CPU has no peak
    assert row["device_seconds"] > 0 and row["samples_per_sec"] > 0
    text = treg.get_registry().expose()
    assert treg.lint_exposition(text) == []
    assert 'harmony_tenant_samples_per_sec{attempt="feed-j"' in text
    assert "harmony_tenant_mfu{" not in text


ROWS = {
    "nulls-j": {
        "job": "nulls-j", "attempt": "nulls-j@a2", "workers": 1,
        "device_seconds": 1.5, "samples_per_sec": None, "mfu": None, "resident_bytes": None,
        "hbm_share": None, "input_wait_frac": None,
        "slo": {"target_sps": None, "attainment": None, "events": 0},
        "straggler_ratio": None,
    },
    "s": {"job": "s", "attempt": "s", "workers": 2, "device_seconds": 1.0,
          "samples_per_sec": 12345.6, "mfu": 0.41, "resident_bytes": 2048, "hbm_share": 1.0,
          "input_wait_frac": 0.25,
          "slo": {"target_sps": 100.0, "attainment": 0.1, "events": 2},
          "straggler_ratio": 1.5,
          "serving": {"enabled": True, "qps": 12.5, "p50_ms": 1.0, "p99_ms": None,
                      "slo_p99_ms": 5.0, "batch_occupancy": 0.75, "cache_hit_rate": 0.5}},
    "big": {"job": "big", "attempt": "big", "workers": 8, "device_seconds": 3600.0,
            "samples_per_sec": 3.0, "mfu": 0.0, "resident_bytes": 3 << 40, "hbm_share": 0.0,
            "input_wait_frac": 0.0, "slo": {"target_sps": 1.0, "attainment": 3.0,
                                             "events": 0},
            "straggler_ratio": 1.0,
            "serving": {"enabled": False}},
}


@pytest.mark.parametrize("keys", [(), ("nulls-j",), ("s",), ("nulls-j", "s", "big")])
def test_obs_top_renders_the_references_lines(keys):
    rows = {k: ROWS[k] for k in keys}
    assert tcli._render_tenant_top(rows) == jcli._render_tenant_top(rows)
    if "nulls-j" in rows:
        (line,) = [ln for ln in tcli._render_tenant_top(rows) if ln.startswith("nulls-j")]
        assert line.split()[4:] == ["-"] * 7


@pytest.mark.parametrize("overload", [
    {}, {"ladder": "normal", "level": 0},
    {"ladder": "shed", "level": 2, "reason": "queue", "queue_fill": 0.93,
     "queue_lag_ms": 412.7, "sheds": {"submit": 3, "status": 1}}])
def test_obs_tops_overload_line_is_the_references(overload):
    assert tcli._render_overload(overload) == jcli._render_overload(overload)


def test_obs_top_renders_a_fed_ledger_as_the_reference(fresh_obs, clock):
    feeds = _feeds(11)
    t0 = clock.t
    _replay(tacct.ledger(), clock, feeds)
    clock.t = t0
    _replay(jacct.ledger(), clock, feeds)
    assert tcli._render_tenant_top(tacct.ledger().snapshot()) == \
        jcli._render_tenant_top(jacct.ledger().snapshot())


@pytest.mark.parametrize("route", ["for_job", "bound", "unbound"])
@pytest.mark.parametrize("ratio", [1.0, 0.5])
def test_checkpoint_bytes_are_charged_as_the_reference_charges_them(fresh_obs, tmp_path,
                                                                   route, ratio):
    """One table checkpointed and restored through each package's manager:
    a per-job manager charges its job, another the job bound to the table,
    an unbound table nobody; the ledger's bytes and the read counts agree."""
    from harmony_tpu.checkpoint import CheckpointManager as JManager
    from harmony_tpu.checkpoint import manager as jchk
    from harmony_tpu.config.params import TableConfig as JTableConfig
    from harmony_tpu.parallel import DevicePool as JPool
    from harmony_tpu.runtime import ETMaster as JMaster
    from harmony_tpu_torch.checkpoint import CheckpointManager
    from harmony_tpu_torch.checkpoint import manager as tchk
    from harmony_tpu_torch.config.params import TableConfig
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster, TableHandle

    vals = np.random.default_rng(3).normal(size=(64, 3)).astype(np.float32)
    rows, reads = [], []
    for pkg in ("port", "ref"):
        root = str(tmp_path / pkg)
        if pkg == "port":
            master = ETMaster(DevicePool([torch.device("cpu")]))
            ex = [e.id for e in master.add_executors(1)]
            cfg = TableConfig(table_id="ck-t", capacity=64, value_shape=(3,), num_blocks=8)
            handle = TableHandle(master, master.create_table(cfg, ex), ex)
            acct, chk, make = tacct, tchk, CheckpointManager
        else:
            master = JMaster(JPool(jax.devices()[:1]))
            ex = [e.id for e in master.add_executors(1)]
            cfg = JTableConfig(table_id="ck-t", capacity=64, value_shape=(3,), num_blocks=8)
            handle = master.create_table(cfg, ex)
            acct, chk, make = jacct, jchk, JManager
        handle.table.multi_update(list(range(64)), vals)
        mgr = (make.for_job(root, "ck-j") if route == "for_job"
               else make(root + "/temp", root + "/commit"))
        if route == "bound":
            acct.ledger().bind_table("ck-t", "ck-j", "ck-j")
        chk.reset_read_stats()
        cid = mgr.checkpoint(handle, sampling_ratio=ratio, commit=True)
        handle.drop()
        restored = mgr.restore(master, cid, ex)
        restored.drop()
        rows.append(acct.ledger().snapshot().get("ck-j", {}).get("bytes"))
        reads.append(dict(chk.read_stats))
    assert rows[0] == rows[1]
    assert reads[0] == reads[1] and reads[0]["blocks_read"] == 8
    if route == "unbound":
        assert rows[0] is None
    else:
        assert rows[0]["chkp_write"] == rows[0]["chkp_read"] == reads[0]["bytes_read"] > 0
