"""The port's doctor (``harmony_tpu_torch/metrics/doctor.py``) against the
reference's on the CPU.

Each of the twelve rules is a case of one parametrised test: the same
series go into a history store of each package and the same structured
events and straggler report feed a doctor of each, and ``diagnose(now=)``
must give the same ``Diagnosis.to_dict()`` list, with the case's rule in
it, and the same ``kind="diagnosis"`` joblog events. The catalog (names,
descriptions, order) is the reference's; the de-duplication window, the
tenant-scoped evaluation of the degraded mode and the process-wide
singleton behave alike. Inputs come from a seed; time is driven
(``now=``, ``ts=``).
"""
import numpy as np
import pytest
import torch

from harmony_tpu.jobserver import joblog as jjoblog
from harmony_tpu.metrics import doctor as jdoc
from harmony_tpu.metrics import history as jhist
from harmony_tpu_torch.jobserver import joblog as tjoblog
from harmony_tpu_torch.metrics import doctor as tdoc
from harmony_tpu_torch.metrics import history as thist

NOW = 1_700_000_100.0
WINDOW = 60.0
RULES = ("input_bound", "straggler", "mfu_collapse", "compile_storm", "infra_suspect",
         "comm_bound", "dispatch_bound", "leader_flap", "rebalance_ineffective",
         "control_overload", "serving_slo_breach", "slo_breach")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (nothing here needs more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_events():
    tjoblog.clear_events()
    jjoblog.clear_events()
    yield
    tjoblog.clear_events()
    jjoblog.clear_events()
    tdoc.set_doctor(None)
    jdoc.set_doctor(None)


class Case:
    """One rule's inputs: series samples, events and a straggler report."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.samples = []     # (name, labels, value, ts, kind, target)
        self.events = {}
        self.stragglers = {}

    def series(self, name, labels, values, kind="gauge", target=None, start=NOW - 50,
               step=5.0):
        for i, v in enumerate(values):
            self.samples.append((name, dict(labels), float(v), start + i * step, kind,
                                 target))

    def noisy(self, lo, hi, n):
        return [float(x) for x in self.rng.uniform(lo, hi, n)]

    def event(self, job, kind, ts, **fields):
        self.events.setdefault(job, []).append({"ts": ts, "kind": kind, **fields})


def _input_bound(c):
    c.series("tenant.input_wait_frac", {"job": "ib", "attempt": "ib"}, c.noisy(0.55, 0.9, 6))
    c.series("tenant.input_wait_frac", {"job": "ok", "attempt": "ok"}, c.noisy(0.0, 0.2, 6))


def _straggler(c):
    c.series("tenant.straggler_ratio", {"job": "st", "attempt": "st"}, c.noisy(2.5, 4.0, 5))
    c.stragglers["st"] = {"slowest": "st/w1", "ratio": 3.1,
                          "workers": {"st/w0": 0.01, "st/w1": 0.031}}


def _mfu_collapse(c):
    c.series("harmony_table_layout_changes_total", {"target": "leader"}, [0, 0, 1, 2],
             kind="counter", target="leader", start=NOW - 55)
    c.series("tenant.mfu", {"job": "mf", "attempt": "mf"},
             c.noisy(0.4, 0.5, 4) + c.noisy(0.05, 0.1, 4), start=NOW - 45)


def _compile_storm(c):
    c.series("harmony_compile_seconds_sum", {"target": "pod:1"},
             np.cumsum(c.noisy(2.0, 4.0, 6)), kind="counter", target="pod:1")
    c.series("harmony_progcache_events_total", {"target": "pod:1", "result": "miss"},
             np.cumsum(c.noisy(1.0, 3.0, 6)), kind="counter", target="pod:1")


def _infra_suspect(c):
    c.series("harmony_retry_events_total", {"target": "pod:2", "op": "chkp.read",
                                            "outcome": "retry"},
             [0, 2, 5, 9], kind="counter", target="pod:2")
    c.series("harmony_retry_events_total", {"target": "pod:2", "op": "obs.scrape",
                                            "outcome": "retry"},
             [0, 10, 20, 40], kind="counter", target="pod:2")
    c.series("harmony_fault_fires_total", {"target": "pod:2", "site": "worker.step",
                                           "action": "delay"},
             [1, 2, 4], kind="counter", target="pod:2")


def _comm_bound(c):
    c.series("tenant.phase.pull_comm", {"job": "cb", "attempt": "cb"}, c.noisy(0.25, 0.35, 6))
    c.series("tenant.phase.push_comm", {"job": "cb", "attempt": "cb"}, c.noisy(0.2, 0.25, 6))


def _dispatch_bound(c):
    c.series("tenant.phase.host_dispatch", {"job": "db", "attempt": "db"},
             c.noisy(0.35, 0.6, 5))


def _leader_flap(c):
    c.event("__ha__", "leader_takeover", NOW - 40, new_leader="rep-b", epoch=2)
    c.event("__ha__", "leader_takeover", NOW - 10, new_leader="rep-a", epoch=3)


def _rebalance_ineffective(c):
    c.series("tenant.slo_attainment", {"job": "rb", "attempt": "rb"},
             c.noisy(0.5, 0.52, 10), start=NOW - 55)
    c.event("rb", "policy", NOW - 30, executed=True, action="grow", executors=["e1"])


def _control_overload(c):
    c.event("__control__", "overload", NOW - 30, ladder="degraded", level=1,
            direction="down", reason="cycle_overrun=scrape", sheds={"scrape_skip": 3})
    c.event("__control__", "overload", NOW - 20, ladder="normal", level=0,
            direction="up", reason="recovered", sheds={"scrape_skip": 5})


def _serving_slo_breach(c):
    c.series("tenant.serving.p99_ms", {"job": "sv", "attempt": "sv"}, c.noisy(8.0, 20.0, 5))
    c.series("tenant.serving.slo_p99_ms", {"job": "sv", "attempt": "sv"}, [5.0] * 5)


def _slo_breach(c):
    _straggler(c)
    c.event("st", "slo", NOW - 15, attainment=0.12, target=9000.0, epoch=3)
    c.event("lone", "slo", NOW - 5, attainment=0.5, target=10.0, epoch=1)


CASES = {"input_bound": _input_bound, "straggler": _straggler,
         "mfu_collapse": _mfu_collapse, "compile_storm": _compile_storm,
         "infra_suspect": _infra_suspect, "comm_bound": _comm_bound,
         "dispatch_bound": _dispatch_bound, "leader_flap": _leader_flap,
         "rebalance_ineffective": _rebalance_ineffective,
         "control_overload": _control_overload,
         "serving_slo_breach": _serving_slo_breach, "slo_breach": _slo_breach}


def _doctors(case, window=WINDOW):
    out = []
    for hist, doc in ((thist, tdoc), (jhist, jdoc)):
        store = hist.HistoryStore(window_sec=600, resolution_sec=1)
        for name, labels, value, ts, kind, target in case.samples:
            store.ingest(name, labels, value, ts=ts, kind=kind, target=target)
        out.append(doc.Doctor(store, window=window, events_fn=lambda: case.events,
                              stragglers_fn=lambda: case.stragglers))
    return out


def _dicts(diags):
    return [d.to_dict() for d in diags]


def _diag_events(joblog):
    return {j: [{k: v for k, v in e.items() if k != "ts"} for e in evs]
            for j, evs in joblog.job_events().items()}


def test_the_catalog_is_the_references():
    assert tuple(r.name for r in tdoc.all_rules()) == RULES
    assert [(r.name, r.description) for r in tdoc.all_rules()] == \
        [(r.name, r.description) for r in jdoc.all_rules()]
    for k in ("INPUT_WAIT_FRAC", "STRAGGLER_RATIO", "MFU_DROP_FRAC", "COMPILE_RATE",
              "MISS_RATE", "INFRA_BURST", "MIN_POINTS", "LEADER_FLAP_COUNT",
              "POLICY_GAIN_FACTOR", "OVERLOAD_EVENT_COUNT", "SERVING_BREACH_RATIO"):
        assert getattr(tdoc, k) == getattr(jdoc, k)


@pytest.mark.parametrize("rule", RULES)
def test_each_rule_gives_the_references_diagnoses(rule):
    case = Case(RULES.index(rule))
    CASES[rule](case)
    mine, ref = _doctors(case)
    got, want = _dicts(mine.diagnose(now=NOW)), _dicts(ref.diagnose(now=NOW))
    assert got == want
    assert rule in [d["rule"] for d in got]
    assert mine.recent() == ref.recent() == got
    assert _diag_events(tjoblog) == _diag_events(jjoblog)
    if rule == "slo_breach":
        (st,) = [d for d in got if d["rule"] == "slo_breach" and d["job"] == "st"]
        assert st["evidence"]["cause_rule"] == "straggler"
        (lone,) = [d for d in got if d["rule"] == "slo_breach" and d["job"] == "lone"]
        assert lone["evidence"]["cause_rule"] is None


def _all_cases(seed=100):
    case = Case(seed)
    for fn in CASES.values():
        fn(case)
    return case


def test_every_rule_at_once_then_the_window_dedups():
    case = _all_cases()
    mine, ref = _doctors(case)
    first = _dicts(mine.diagnose(now=NOW))
    assert first == _dicts(ref.diagnose(now=NOW))
    assert {d["rule"] for d in first} == set(RULES)
    # once per (rule, subject) per window: a rescan inside it emits nothing
    assert mine.diagnose(now=NOW + 5) == [] and ref.diagnose(now=NOW + 5) == []
    later_m, later_r = mine.diagnose(now=NOW + WINDOW + 1), ref.diagnose(now=NOW + WINDOW + 1)
    assert _dicts(later_m) == _dicts(later_r)
    assert mine.recent(limit=8) == ref.recent(limit=8)


@pytest.mark.parametrize("jobs", [set(), {"ib"}, {"st", "sv", "nobody"}])
def test_a_tenant_subset_evaluates_as_the_references(jobs):
    case = _all_cases(7)
    mine, ref = _doctors(case)
    got = _dicts(mine.diagnose(now=NOW, jobs=jobs))
    assert got == _dicts(ref.diagnose(now=NOW, jobs=jobs))
    # cluster-scoped rules always evaluate; tenants outside the subset do not
    assert {"leader_flap", "control_overload"} <= {d["rule"] for d in got}
    assert {d["job"] for d in got if d["job"]} <= jobs


def test_a_broken_rule_or_source_silences_nothing_else(monkeypatch):
    case = _all_cases(3)
    mine, ref = _doctors(case)
    for doc, m in ((tdoc, mine), (jdoc, ref)):
        monkeypatch.setattr(doc._RULES["straggler"], "fn",
                            lambda ctx: (_ for _ in ()).throw(RuntimeError("boom")))
        m._stragglers_fn = lambda: (_ for _ in ()).throw(RuntimeError("down"))
    got = _dicts(mine.diagnose(now=NOW))
    assert got == _dicts(ref.diagnose(now=NOW))
    assert "straggler" not in {d["rule"] for d in got} and len(got) >= 10


def test_the_process_wide_doctor_is_set_and_peeked():
    store = thist.HistoryStore(window_sec=60, resolution_sec=1)
    d = tdoc.Doctor(store)
    assert tdoc.peek_doctor() is None
    assert tdoc.set_doctor(d) is d and tdoc.peek_doctor() is d
    assert d.window == store.window_sec
    tdoc.set_doctor(None)
    assert tdoc.peek_doctor() is None
