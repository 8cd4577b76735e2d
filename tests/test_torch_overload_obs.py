"""The overload ladder's and the serving endpoint's observers
(``harmony_tpu_torch/jobserver/overload.py``,
``harmony_tpu_torch/serving/service.py``) against the reference's on the
CPU.

* One seeded sequence of ``note_queue``/``note_cycle``/``step`` calls under
  a driven clock into a monitor of each package gives the reference's
  ``kind="overload"`` events under ``__control__`` (the doctor's
  ``control_overload`` input) and its ``harmony_overload_transitions_total``
  and ``harmony_overload_shed_total`` counts.
* One seeded sequence of live lookups, with scripted latencies and a driven
  flush clock, into an endpoint of each package gives the reference's
  ``harmony_serving_requests_total{mode}`` and ``harmony_serving_shed_total``
  counts, its ledger serving state (``set_serving_state``) and its
  ``serving_slo`` events.

No assertion reads the wall clock.
"""
import socket

import jax
import numpy as np
import pytest
import torch

from harmony_tpu.config.params import TableConfig as JaxTableConfig
from harmony_tpu.jobserver import joblog as jjoblog
from harmony_tpu.jobserver.overload import OverloadMonitor as JaxOverloadMonitor
from harmony_tpu.jobserver.policy import ActionGate as JaxActionGate
from harmony_tpu.metrics import accounting as jacct
from harmony_tpu.metrics import registry as jreg
from harmony_tpu.parallel import build_mesh
from harmony_tpu.serving import ServingEndpoint as JaxEndpoint
from harmony_tpu.serving import service as jservice
from harmony_tpu.table.table import DenseTable as JaxDenseTable
from harmony_tpu.table.table import TableSpec as JaxTableSpec
from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.jobserver import joblog as tjoblog
from harmony_tpu_torch.jobserver.overload import OverloadMonitor
from harmony_tpu_torch.jobserver.policy import ActionGate
from harmony_tpu_torch.metrics import accounting as tacct
from harmony_tpu_torch.metrics import registry as treg
from harmony_tpu_torch.serving import ServingEndpoint
from harmony_tpu_torch.serving import service as tservice
from harmony_tpu_torch.table.table import DenseTable, TableSpec

CAPACITY, WIDTH, BLOCKS = 64, 4, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh():
    def reset():
        treg.set_registry(treg.MetricRegistry())
        jreg.set_registry(jreg.MetricRegistry())
        tjoblog.clear_events()
        jjoblog.clear_events()
        tacct.reset_ledger()
        jacct.reset_ledger()

    reset()
    yield
    reset()


def _families(reg, prefix):
    fams = treg.parse_exposition(reg.expose())
    return {k: v for k, v in fams.items() if k.startswith(prefix)}


def _events(joblog, job):
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in joblog.job_events(job, limit=1 << 20)]


# -- the overload ladder -------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_ladders_transitions_give_the_references_events_and_counters(seed):
    mons = [OverloadMonitor(gate=ActionGate(cooldown_sec=3.0, confirm=2, stale_after=600.0),
                            enabled=True),
            JaxOverloadMonitor(gate=JaxActionGate(cooldown_sec=3.0, confirm=2,
                                                  stale_after=600.0), enabled=True)]
    rng = np.random.default_rng(seed)
    levels = [[], []]
    for t in range(150):
        phase = (t // 25) % 3          # calm, storm (queue or cycle overrun), drain
        depth = int(rng.integers(50, 64)) if phase == 1 and t % 2 else int(rng.integers(0, 8))
        lag = float(rng.uniform(0.0, 0.2))
        cycles = [("scrape", float(rng.uniform(0, 0.3)), 0.25),
                  ("diagnose", float(rng.uniform(0, 0.1)), 0.25),
                  ("correlate", float(rng.uniform(0.3, 0.5) if phase == 1 else 0.01), 0.25)]
        keys = [f"t{i}" for i in range(int(rng.integers(4, 20)))]
        for mon, out in zip(mons, levels):
            mon.note_queue(depth, 64, lag_sec=lag)
            for kind, elapsed, budget in cycles:
                mon.note_cycle(kind, elapsed, budget)
            out.append(mon.step(now=float(t)))
            mon.plan_subset(keys, plan="tenants")
            mon.admit_submit(depth, 64, inflight=2)
    assert levels[0] == levels[1] and set(levels[0]) == {0, 1, 2}
    got, want = _events(tjoblog, "__control__"), _events(jjoblog, "__control__")
    assert got == want and {e["direction"] for e in got} == {"down", "up"}
    assert all(e["kind"] == "overload" for e in got)
    assert _families(treg.get_registry(), "harmony_overload_") == \
        _families(jreg.get_registry(), "harmony_overload_")
    sheds = _families(treg.get_registry(), "harmony_overload_")["harmony_overload_shed_total"]
    assert {lab["action"] for _, lab, _ in sheds["samples"]} >= {"busy_reject",
                                                                  "tenants_skip"}


# -- the serving endpoint ------------------------------------------------------------


class ServeClock:
    """``time`` for a service module: ``perf_counter`` gives each lookup the
    scripted latency (its two reads are t0 and t0 + lat), ``monotonic`` the
    driven flush clock."""

    def __init__(self):
        self.mono = 1000.0
        self.lat_s = 0.0
        self._calls = 0

    def monotonic(self):
        return self.mono

    def perf_counter(self):
        self._calls += 1
        return 0.0 if self._calls % 2 else self.lat_s


@pytest.fixture()
def tables():
    kw = dict(table_id="obs-t", capacity=CAPACITY, value_shape=(WIDTH,), num_blocks=BLOCKS)
    keys = np.arange(CAPACITY, dtype=np.int32)
    vals = np.random.default_rng(3).standard_normal((CAPACITY, WIDTH)).astype(np.float32)
    ref = JaxDenseTable(JaxTableSpec(JaxTableConfig(**kw)), build_mesh(jax.devices()[:1]))
    ref.multi_put(keys, vals)
    mine = DenseTable(TableSpec(TableConfig(**kw)), "cpu")
    mine.multi_put(keys, vals)
    return mine, ref


class _Shedding:
    def shedding(self):
        return True

    def retry_after_ms(self):
        return 100

    def count_shed(self, action):
        pass


@pytest.mark.parametrize("cache_mb", [0, 4])
def test_lookups_give_the_references_counters_ledger_state_and_slo_events(
        monkeypatch, tables, cache_mb):
    clocks = (ServeClock(), ServeClock())
    monkeypatch.setattr(tservice, "time", clocks[0])
    monkeypatch.setattr(jservice, "time", clocks[1])
    eps = [ServingEndpoint(table_fn=lambda j: tables[0], window_ms=0.0, cache_mb=cache_mb),
           JaxEndpoint(table_fn=lambda j: tables[1], window_ms=0.0, cache_mb=cache_mb)]
    for ep in eps:
        ep.set_slo("sj", 5.0)
    rng = np.random.default_rng(11)
    n = 60
    for i in range(n):
        job = "sj" if i % 3 else "other"
        keys = rng.integers(0, CAPACITY, size=int(rng.integers(1, 9))).astype(np.int32)
        lat = float(rng.choice([0.001, 0.003, 0.012]))
        step = float(rng.choice([0.1, 0.3]))
        rows = []
        for ep, clk in zip(eps, clocks):
            clk.mono += step
            clk.lat_s = lat
            rows.append(ep.lookup(job, keys, mode="live")[0])
        assert np.array_equal(np.asarray(rows[0]), np.asarray(rows[1]))
    # a shed lookup counts in harmony_serving_shed_total
    for ep in eps:
        ep._overload = _Shedding()
        a, b = socket.socketpair()
        with a, b:
            a.settimeout(5.0)
            b.settimeout(5.0)
            ep._serve_lookup(a, {"op": "lookup", "r": 1, "job": "sj", "mode": "live",
                                 "data": [np.arange(2, dtype=np.int32)]})
            assert b.recv(1 << 16)
    fams = _families(treg.get_registry(), "harmony_serving_")
    assert fams == _families(jreg.get_registry(), "harmony_serving_")
    req = {lab["mode"]: v for _, lab, v in fams["harmony_serving_requests_total"]["samples"]}
    assert req == {"live": float(n)}
    assert [v for _, _, v in fams["harmony_serving_shed_total"]["samples"]] == [1.0]
    mine_rows, ref_rows = tacct.ledger().snapshot(), jacct.ledger().snapshot()
    for job in ("sj", "other"):
        assert mine_rows[job]["serving"] == ref_rows[job]["serving"]
        srv = mine_rows[job]["serving"]
        assert srv["enabled"] and srv["qps"] > 0 and srv["p99_ms"] is not None
    assert mine_rows["sj"]["serving"]["slo_p99_ms"] == 5.0
    if cache_mb:
        assert mine_rows["sj"]["serving"]["cache_hit_rate"] is not None
    for job in ("sj", "other"):
        assert _events(tjoblog, job) == _events(jjoblog, job)
    slo = _events(tjoblog, "sj")
    assert slo and all(e["kind"] == "serving_slo" and e["p99_ms"] > 5.0 for e in slo)
    assert _events(tjoblog, "other") == []     # its SLO is the 50 ms default
