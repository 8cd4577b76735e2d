"""The port's incident engine (``harmony_tpu_torch/metrics/incidents.py``)
against the reference's on the CPU, with the flight recorder absent on both
sides (the port has none; the reference's is reset).

One seeded stream of structured joblog events (triggers, diagnoses,
actions, resolutions, unclassified kinds; tenant and cluster subjects; pids
and fault sites as join keys) goes into each package's joblog under one
driven clock, and an engine of each package correlates it cycle by cycle:
the same lifecycle transitions (sinks and persisted ``kind="incident"``
events), the same open and resolved incidents with the same chains and
MTTD/MTTR, the same ``status()`` and the same ``harmony_incident_*``
families. ``adopt`` of the same replayed set gives the same open and
resolved sets. No assertion reads the wall clock.
"""
import numpy as np
import pytest
import torch

from harmony_tpu.jobserver import joblog as jjoblog
from harmony_tpu.metrics import incidents as jinc
from harmony_tpu.metrics import registry as jreg
from harmony_tpu.tracing import flight as jflight
from harmony_tpu_torch.jobserver import joblog as tjoblog
from harmony_tpu_torch.metrics import incidents as tinc
from harmony_tpu_torch.metrics import registry as treg

T0 = 1_700_000_000.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (nothing here needs more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakeTime:
    def __init__(self, t: float) -> None:
        self.t = t

    def time(self) -> float:
        return self.t

    def monotonic(self) -> float:
        return self.t


@pytest.fixture()
def clock(monkeypatch):
    """One driven clock for both packages' joblogs and engines; fresh rings,
    registries and singletons; no flight recorder on either side."""
    fake = FakeTime(T0)
    for mod in (tjoblog, jjoblog, tinc, jinc):
        monkeypatch.setattr(mod, "time", fake)

    def reset():
        tjoblog.clear_events()
        jjoblog.clear_events()
        treg.set_registry(treg.MetricRegistry())
        jreg.set_registry(jreg.MetricRegistry())
        tinc.set_incidents(None)
        jinc.set_incidents(None)
        jflight.reset_recorder()

    reset()
    yield fake
    reset()


def _engines(**kw):
    kw.setdefault("window_sec", 30.0)
    out = []
    for mod in (tinc, jinc):
        seen = []
        eng = mod.IncidentEngine(sinks=(seen.append,), **kw)
        eng.transitions = seen
        out.append(eng)
    return out


def _record(job, kind, **fields):
    tjoblog.record_event(job, kind, **fields)
    jjoblog.record_event(job, kind, **fields)


SUBJECTS = ("wd", "fm", "__ha__", "__control__", "__pod__")
KINDS = (("slo", {"attainment": 0.4}), ("serving_slo", {"p99_ms": 9.0, "slo_p99_ms": 5.0}),
         ("overload", {"level": 1, "ladder": "degraded", "direction": "down"}),
         ("process_restart", {"target": "pod:1", "pid": 4242}),
         ("follower_silenced", {"pid": 1}),
         ("diagnosis", {"rule": "straggler", "verdict": "straggler"}),
         ("policy", {"action": "grow", "executed": True}),
         ("leader_takeover", {"new_leader": "rep-b"}),
         ("elastic_shrink", {"attempt": 1, "site": "worker.step"}),
         ("elastic_regrow_fence", {"attempt": 2}),
         ("elastic_restore", {"recovery": "restored"}),
         ("follower_rehabilitated", {"pid": 1}),
         ("chkp_chain", {"chkp": "x"}), ("leader_epoch_note", {}))


def _stream(seed, n=160):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        dt = float(rng.choice([0.5, 2.0, 7.0, 45.0], p=[0.45, 0.35, 0.15, 0.05]))
        kind, fields = KINDS[int(rng.integers(len(KINDS)))]
        job = SUBJECTS[int(rng.integers(len(SUBJECTS)))]
        fields = dict(fields)
        if rng.random() < 0.2:
            fields["pid"] = int(rng.integers(1, 4))
        if rng.random() < 0.1:
            fields["site"] = "ckpt.write"
        out.append((dt, job, kind, fields, bool(rng.random() < 0.3)))
    return out


def _families(reg):
    fams = treg.parse_exposition(reg.expose())
    return {k: v for k, v in fams.items() if k.startswith("harmony_incident_")}


def _persisted(joblog):
    return [e for evs in joblog.job_events(limit=1 << 20).values() for e in evs
            if e["kind"] == "incident"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("persist", [False, True])
def test_the_same_stream_gives_the_references_incidents(clock, seed, persist):
    mine, ref = _engines(persist=persist, max_open=6)
    consumed = []
    for dt, job, kind, fields, cycle in _stream(seed):
        clock.t += dt
        _record(job, kind, **fields)
        if cycle:
            consumed.append((mine.correlate(now=clock.t), ref.correlate(now=clock.t)))
            assert mine.open_incidents() == ref.open_incidents()
    clock.t += 100.0
    consumed.append((mine.correlate(), ref.correlate()))
    assert all(a == b for a, b in consumed) and sum(a for a, _ in consumed) > 0
    assert mine.transitions == ref.transitions and mine.transitions
    assert mine.recent(limit=64) == ref.recent(limit=64)
    assert mine.status() == ref.status()
    assert _families(treg.get_registry()) == _families(jreg.get_registry())
    assert _persisted(tjoblog) == _persisted(jjoblog)
    assert bool(_persisted(tjoblog)) == persist
    resolved = mine.recent(limit=64)
    verdicts = {i["verdict"] for i in resolved}
    assert "quiesced" in verdicts and mine.status()["open"] == 0
    # joblog evidence only: detection is the trigger itself
    assert all(i["mttd_sec"] == 0.0 for i in resolved)
    assert all(i["mttr_sec"] is not None for i in resolved if i["verdict"] != "evicted")


def test_a_full_chain_resolves_recovered_with_its_clocks(clock):
    mine, ref = _engines()
    _record("wd", "slo", attainment=0.2)
    clock.t += 1.0
    _record("wd", "diagnosis", rule="straggler", verdict="straggler")
    clock.t += 2.0
    _record("wd", "policy", action="grow", executed=True)
    clock.t += 3.0
    _record("wd", "elastic_restore", recovery="restored")
    clock.t += 0.5
    for eng in (mine, ref):
        assert eng.correlate() == 4
    assert mine.recent() == ref.recent()
    (inc,) = mine.recent()
    assert [e["role"] for e in inc["chain"]] == ["trigger", "diagnosis", "action",
                                                 "resolution"]
    assert (inc["status"], inc["verdict"]) == ("resolved", "recovered")
    assert (inc["mttd_sec"], inc["mitigate_sec"], inc["mttr_sec"]) == (0.0, 3.0, 6.0)
    assert _families(treg.get_registry()) == _families(jreg.get_registry())


def test_events_older_than_the_engine_are_history(clock):
    _record("wd", "slo", attainment=0.2)
    clock.t += 1.0
    mine, ref = _engines()
    assert mine.correlate() == ref.correlate() == 0
    assert mine.open_incidents() == ref.open_incidents() == []


def _replayed(clock, seed):
    """A predecessor's persisted transitions, newest per incident id (as
    ``ReplayState.incidents`` keeps them), plus a malformed row."""
    pred, _ = _engines(persist=True, max_open=4)
    for dt, job, kind, fields, cycle in _stream(seed, n=60):
        clock.t += dt
        _record(job, kind, **fields)
        if cycle:
            pred.correlate()
    pred.correlate()
    replayed = {}
    for e in _persisted(tjoblog):
        replayed[e["incident_id"]] = e
    replayed["broken"] = {"incident_id": "broken"}      # no opened_ts
    return replayed


@pytest.mark.parametrize("seed", [4, 5])
def test_adopting_the_same_replayed_set_gives_the_same_open_and_resolved(clock, seed):
    replayed = _replayed(clock, seed)
    statuses = {e.get("status") for e in replayed.values()}
    assert {"resolved"} < statuses
    clock.t += 5.0
    mine, ref = _engines()
    assert mine.adopt(replayed) == ref.adopt(replayed) > 0
    assert mine.open_incidents() == ref.open_incidents()
    assert mine.recent(limit=64) == ref.recent(limit=64)
    assert mine.status() == ref.status() and mine.status()["adopted"] > 0
    # adoption never re-persists, and post-takeover evidence joins the adopted
    assert mine.transitions == ref.transitions == []
    subject = mine.open_incidents()[0]["subject"]
    clock.t += 1.0
    _record("__ha__" if subject == "cluster" else subject, "elastic_restore",
            recovery="restored")
    assert mine.correlate() == ref.correlate() == 1
    assert mine.recent(limit=64) == ref.recent(limit=64)
    assert mine.transitions == ref.transitions


def test_the_knobs_and_the_singleton(clock, monkeypatch):
    for k, v in (("HARMONY_INCIDENT_WINDOW", "7"), ("HARMONY_INCIDENT_MAX_OPEN", "3"),
                 ("HARMONY_INCIDENT_PERSIST", "off")):
        monkeypatch.setenv(k, v)
    assert (tinc.correlation_window(), tinc.max_open_incidents(), tinc.persist_enabled()) == \
        (jinc.correlation_window(), jinc.max_open_incidents(), jinc.persist_enabled()) == \
        (7.0, 3, False)
    eng = tinc.IncidentEngine()
    assert (eng.window_sec, eng.max_open, eng.persist) == (7.0, 3, False)
    assert tinc.peek_incidents() is None
    assert tinc.set_incidents(eng) is eng and tinc.peek_incidents() is eng
