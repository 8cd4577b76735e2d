"""The port's telemetry history, scraper and exporter
(``harmony_tpu_torch/metrics/{history,exporter}.py``) against the
reference's on the CPU.

* The store: one seeded stream of gauge and counter samples (resets and
  missed-scrape gaps among them) into a store of each package gives the same
  ``range``/``rate``/``increase``/``latest`` answers, the same reset and gap
  marks, the same ``stats()`` and the same snapshot; ingesting expositions
  (a pid change, a counter reset) gives the same restart reports.
* The scraper: ``poll_once(now=)`` over in-process targets and the tenant
  ledger rows, and over a live exporter of each package, gives the same
  series. A dead target marks a gap and counts
  ``harmony_obs_scrape_total{result="error"}``; an over-long body fails the
  poll; a broken target provider does not.
* The exporter: ``/metrics`` is byte-identical to ``expose()``, ``/healthz``
  answers, and ``HARMONY_METRICS_PORT`` unset, ``0`` and a taken port behave
  as the reference's.

Time is driven (``ts=``/``now=``); every socket binds port 0 on the loopback
interface with a timeout, and a fixture stops every exporter.
"""
import functools
import http.server
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from harmony_tpu.jobserver import joblog as jjoblog
from harmony_tpu.metrics import exporter as jexp
from harmony_tpu.metrics import history as jhist
from harmony_tpu.metrics import registry as jreg
from harmony_tpu_torch.jobserver import joblog as tjoblog
from harmony_tpu_torch.metrics import exporter as texp
from harmony_tpu_torch.metrics import history as thist
from harmony_tpu_torch.metrics import registry as treg

TIMEOUT = 10.0
T0 = 1_700_000_000.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (nothing here needs more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def fresh():
    """Fresh registries and event rings in both packages."""
    def reset():
        treg.set_registry(treg.MetricRegistry())
        jreg.set_registry(jreg.MetricRegistry())
        tjoblog.clear_events()
        jjoblog.clear_events()

    reset()
    yield
    reset()


class Exporters:
    """Started exporters, stopped at the end of the test."""

    def __init__(self):
        self.started = []

    def add(self, exp):
        self.started.append(exp)
        return exp

    def stop(self):
        for exp in self.started:
            exp.stop()


@pytest.fixture()
def exporters():
    ex = Exporters()
    yield ex
    ex.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


# -- the store ----------------------------------------------------------------------


def _stream(seed, n=240):
    """A seeded sample stream: (op, args) over a few gauge and counter series
    of two targets, with counter resets and missed-scrape gaps."""
    rng = np.random.default_rng(seed)
    counters = {("c_total", "a"): 0.0, ("c_total", "b"): 0.0, ("d_total", "a"): 0.0}
    ops = []
    t = T0
    for _ in range(n):
        t += float(rng.choice([0.3, 0.7, 1.0, 2.5]))
        r = rng.random()
        if r < 0.08:
            ops.append(("gap", (str(rng.choice(["a", "b"])), t)))
        elif r < 0.5:
            key = list(counters)[int(rng.integers(len(counters)))]
            if rng.random() < 0.06:
                counters[key] = float(rng.integers(0, 3))   # a reset
            else:
                counters[key] += float(rng.integers(0, 20))
            ops.append(("ingest", (key[0], {"target": key[1], "op": "x"}, counters[key], t,
                                   "counter", key[1])))
        else:
            job = str(rng.choice(["j0", "j1", "j2"]))
            ops.append(("ingest", ("tenant.samples_per_sec", {"job": job, "attempt": job},
                                   float(rng.standard_normal() * 10 + 100), t, "gauge",
                                   None)))
    return ops, t


def _fill(store, ops):
    resets = []
    for op, args in ops:
        if op == "gap":
            store.mark_gap(args[0], ts=args[1])
        else:
            name, labels, value, ts, kind, target = args
            resets.append(store.ingest(name, labels, value, ts=ts, kind=kind, target=target))
    return resets


def _norm(rows):
    return sorted(rows, key=lambda r: sorted(r[0].items()))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window,resolution", [(60.0, 1.0), (900.0, 5.0)])
def test_the_same_samples_give_the_references_queries_marks_and_stats(seed, window,
                                                                      resolution):
    ops, t_end = _stream(seed)
    mine = thist.HistoryStore(window_sec=window, resolution_sec=resolution)
    ref = jhist.HistoryStore(window_sec=window, resolution_sec=resolution)
    assert _fill(mine, ops) == _fill(ref, ops)
    for name, labels in (("tenant.samples_per_sec", None),
                         ("tenant.samples_per_sec", {"job": "j1"}),
                         ("c_total", None), ("c_total", {"target": "b"}), ("d_total", None)):
        assert _norm(mine.range(name, labels)) == _norm(ref.range(name, labels))
        assert _norm(mine.range(name, labels, since=t_end - 30, until=t_end - 5)) == \
            _norm(ref.range(name, labels, since=t_end - 30, until=t_end - 5))
        assert _norm(mine.latest(name, labels)) == _norm(ref.latest(name, labels))
        for w in (10.0, 45.0, None):
            assert _norm(mine.rate(name, labels, window=w, until=t_end)) == \
                _norm(ref.rate(name, labels, window=w, until=t_end))
            assert _norm(mine.increase(name, labels, window=w, until=t_end)) == \
                _norm(ref.increase(name, labels, window=w, until=t_end))
    for target in (None, "a", "b"):
        assert mine.resets(target) == ref.resets(target)
        assert mine.gaps(target) == ref.gaps(target)
    assert mine.series_names() == ref.series_names()
    assert mine.stats() == ref.stats()
    assert mine.snapshot() == ref.snapshot()
    assert mine.snapshot(names=["c_total"], since=t_end - 20) == \
        ref.snapshot(names=["c_total"], since=t_end - 20)
    assert mine.stats()["gap_marks"] > 0 and mine.resets() > 0


def test_the_series_cap_evicts_and_drops_as_the_references(monkeypatch):
    monkeypatch.setattr(thist, "_MAX_SERIES", 3)
    monkeypatch.setattr(jhist, "_MAX_SERIES", 3)
    stores = [thist.HistoryStore(window_sec=10, resolution_sec=1),
              jhist.HistoryStore(window_sec=10, resolution_sec=1)]
    for s in stores:
        s.ingest("g", {"job": "dead"}, 1.0, ts=T0 - 100)
        for i in range(5):
            s.ingest("g", {"k": str(i)}, 1.0, ts=T0 + i)
    assert stores[0].stats() == stores[1].stats()
    assert stores[0].stats()["dropped_series"] == 2
    assert stores[0].stats()["evicted_series"] == 1


def _exposition(reg_mod, pid, c_value, with_late=False):
    reg = reg_mod.MetricRegistry()
    reg.counter("harmony_x_total", "x", ("op",)).labels(op="a").inc(c_value)
    reg.gauge("harmony_g", "g").set(c_value / 2)
    reg.counter("harmony_obs_scrape_total", "s", ("target", "result")).labels(
        target="pod:1", result="ok").inc(3)
    h = reg.histogram("harmony_h_seconds", "h", buckets=(0.1, 1.0))
    h.observe(0.5)
    if with_late:
        reg.counter("harmony_late_total", "late").inc(2)
    text = reg.expose()
    return text.replace(f'pid="{reg_mod.os.getpid()}"', f'pid="{pid}"')


def test_expositions_give_the_references_restart_reports_and_series():
    mine = thist.HistoryStore(window_sec=300, resolution_sec=1)
    ref = jhist.HistoryStore(window_sec=300, resolution_sec=1)
    seq = [("t1", "100", 5, False), ("t1", "100", 9, False), ("t1", "200", 1, False),
           ("t1", "200", 4, True), ("t2", "300", 7, False), ("t1", "200", 2, True)]
    for i, (target, pid, v, late) in enumerate(seq):
        a = mine.ingest_exposition(target, _exposition(treg, pid, v, late), ts=T0 + 2 * i)
        b = ref.ingest_exposition(target, _exposition(jreg, pid, v, late), ts=T0 + 2 * i)
        assert a == b
    assert mine.series_names() == ref.series_names()
    assert "harmony_h_seconds_bucket" not in mine.series_names()
    for name in mine.series_names():
        assert _norm(mine.range(name)) == _norm(ref.range(name))
    # the exposition's own target label survives as exported_target
    ((labels, _pts),) = mine.range("harmony_obs_scrape_total", {"target": "t2"})
    assert labels["exported_target"] == "pod:1"
    assert mine.target_pid("t1") == ref.target_pid("t1") == "200"
    assert mine.stats() == ref.stats() and mine.stats()["restarts"] >= 2


# -- the scraper --------------------------------------------------------------------


def _ledger_rows():
    return {
        "wd": {"attempt": "wd", "samples_per_sec": 1234.5, "mfu": None,
               "input_wait_frac": 0.25, "device_seconds": 3.5, "straggler_ratio": 3.2,
               "workers": 2, "phases": {"input_wait": 0.1, "compute": 0.7, "pull_comm": None},
               "slo": {"attainment": 0.4}, "serving": None},
        "srv": {"attempt": "srv@a1", "samples_per_sec": None, "mfu": None,
                "input_wait_frac": None, "device_seconds": 0.0, "straggler_ratio": None,
                "workers": 1, "phases": None, "slo": {"attainment": None},
                "serving": {"enabled": True, "qps": 50.0, "p50_ms": 1.5, "p99_ms": 9.0,
                            "slo_p99_ms": 5.0, "batch_occupancy": None,
                            "cache_hit_rate": 0.5}},
    }


def _scrapers(targets_of, ledger=True, period=3600.0):
    """A scraper of each package; ``targets_of(pkg)`` gives its targets."""
    out = []
    for pkg, hist in (("torch", thist), ("jax", jhist)):
        store = hist.HistoryStore(window_sec=600, resolution_sec=1)
        events = []
        out.append(hist.HistoryScraper(
            store, targets_fn=lambda p=pkg: targets_of(p),
            ledger_fn=_ledger_rows if ledger else None, period=period,
            on_restart=lambda t, info, ev=events: ev.append((t, info))))
        out[-1].restarts = events
    return out


def _same_stores(a, b):
    assert a.series_names() == b.series_names()
    for name in a.series_names():
        assert _norm(a.range(name)) == _norm(b.range(name)), name
    assert a.stats() == b.stats()


def _report(rep):
    return {k: v for k, v in rep.items()}


def test_poll_over_in_process_targets_gives_the_references_series(fresh):
    texts = {n: [_exposition(m, "77", v, late) for v, late in ((3, False), (8, True), (1, True))]
             for n, m in (("torch", treg), ("jax", jreg))}
    step = {"i": 0}

    def targets_of(pkg):
        i = step["i"]
        return {"leader": lambda: texts[pkg][i], "side": lambda: texts[pkg][min(i + 1, 2)]}

    mine, ref = _scrapers(targets_of)
    for i in range(3):
        step["i"] = i
        a = mine.poll_once(now=T0 + 5 * i)
        b = ref.poll_once(now=T0 + 5 * i)
        assert _report(a) == _report(b)
    _same_stores(mine.store, ref.store)
    assert mine.restarts == ref.restarts and mine.restarts
    # ledger rows: None stays unknown (no tenant.mfu), serving folds
    names = mine.store.series_names()
    assert "tenant.mfu" not in names and "tenant.samples_per_sec" in names
    assert "tenant.phase.pull_comm" not in names and "tenant.phase.compute" in names
    assert "tenant.serving.p99_ms" in names and "tenant.serving.batch_occupancy" not in names
    ((labels, pts),) = mine.store.range("tenant.slo_attainment")
    assert labels == {"job": "wd", "attempt": "wd"} and [v for _, v in pts] == [0.4] * 3
    assert {k: v for k, v in mine.stats().items() if k != "last_cycle_ms"} == \
        {k: v for k, v in ref.stats().items() if k != "last_cycle_ms"}


def test_a_dead_target_marks_a_gap_and_counts_an_error(fresh):
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    dead = f"http://127.0.0.1:{listener.getsockname()[1]}/metrics"
    listener.close()     # nothing listens there now
    texts = {"torch": _exposition(treg, "5", 2), "jax": _exposition(jreg, "5", 2)}
    mine, ref = _scrapers(lambda pkg: {"leader": lambda: texts[pkg], "dead": dead},
                          ledger=False)
    for s in (mine, ref):
        s.client = type(s.client)(timeout=2.0)
    a = mine.poll_once(now=T0)
    b = ref.poll_once(now=T0)
    assert a["targets"]["dead"] == b["targets"]["dead"] == "gap"
    assert a["targets"]["leader"] == b["targets"]["leader"]
    assert mine.store.gaps("dead") == ref.store.gaps("dead") == [T0]
    for reg in (treg.get_registry(), jreg.get_registry()):
        fam = treg.parse_exposition(reg.expose())["harmony_obs_scrape_total"]
        got = {(lab["target"], lab["result"]): v for _, lab, v in fam["samples"]}
        assert got == {("leader", "ok"): 1.0, ("dead", "error"): 1.0}
    assert set(mine.stats()["last_errors"]) == set(ref.stats()["last_errors"]) == {"dead"}
    _same_stores(mine.store, ref.store)


class _BigBody(http.server.BaseHTTPRequestHandler):
    body = b"# TYPE harmony_x counter\n" + b"#" * 8192 + b"\n"

    def log_message(self, *a):
        pass

    def do_GET(self):
        self.send_response(200)
        self.send_header("Content-Length", str(len(self.body)))
        self.end_headers()
        self.wfile.write(self.body)


@pytest.fixture()
def big_body_server():
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _BigBody)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}/metrics"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=TIMEOUT)


def test_an_over_long_body_fails_the_poll(fresh, monkeypatch, big_body_server):
    for mod in (thist, jhist):
        monkeypatch.setattr(mod, "_read_bounded",
                            functools.partial(mod._read_bounded, cap=4096))
    mine, ref = _scrapers(lambda pkg: {"big": big_body_server}, ledger=False)
    a = mine.poll_once(now=T0)
    b = ref.poll_once(now=T0)
    assert a["targets"]["big"] == b["targets"]["big"] == "gap"
    assert mine.stats()["last_errors"]["big"] == ref.stats()["last_errors"]["big"]
    assert "RetryError" in mine.stats()["last_errors"]["big"]


class _Endless:
    def read(self, n):
        return b"x" * n


def test_the_bounded_read_refuses_as_the_references():
    for mod in (thist, jhist):
        with pytest.raises(ValueError, match="exceeds 1000 bytes"):
            mod._read_bounded(_Endless(), deadline=float("inf"), cap=1000)
        with pytest.raises(TimeoutError):
            mod._read_bounded(_Endless(), deadline=0.0, cap=1000)


def test_a_broken_target_provider_does_not_kill_the_poll(fresh):
    def broken():
        raise RuntimeError("provider down")

    reports = []
    for hist in (thist, jhist):
        s = hist.HistoryScraper(hist.HistoryStore(window_sec=60, resolution_sec=1),
                                targets_fn=broken, ledger_fn=_ledger_rows, period=3600)
        reports.append(s.poll_once(now=T0))
        assert s.stats()["cycles"] == 1
        assert "tenant.samples_per_sec" in s.store.series_names()
    assert reports[0] == reports[1]
    assert reports[0]["targets_error"] == "RuntimeError: provider down"


def _same_ops(reg_mod):
    reg = reg_mod.MetricRegistry()
    reg.counter("harmony_table_layout_changes_total", "layout").inc(2)
    reg.counter("harmony_retry_events_total", "retries", ("op", "outcome")).labels(
        op="chkp.read", outcome="retry").inc(4)
    reg.gauge("harmony_tenant_samples_per_sec", "sps", ("job",)).labels(job="wd").set(12.5)
    reg.histogram("harmony_step_seconds", "steps", buckets=(0.01, 0.1)).observe(0.05)
    return reg


def test_poll_over_a_live_exporter_of_each_package_gives_the_same_series(fresh, exporters):
    regs = {"torch": _same_ops(treg), "jax": _same_ops(jreg)}
    urls = {"torch": exporters.add(texp.MetricsExporter(
                0, registry=regs["torch"], host="127.0.0.1").start()).url + "/metrics",
            "jax": exporters.add(jexp.MetricsExporter(
                0, registry=regs["jax"], host="127.0.0.1").start()).url + "/metrics"}
    mine, ref = _scrapers(lambda pkg: {"pod:1": urls[pkg]}, ledger=False)
    for i in range(3):
        for reg in regs.values():
            reg.counter("harmony_table_layout_changes_total", "layout").inc()
        a = mine.poll_once(now=T0 + 5 * i)
        b = ref.poll_once(now=T0 + 5 * i)
        assert a == b and a["targets"]["pod:1"]["samples"] > 0
    _same_stores(mine.store, ref.store)
    ((_labels, inc),) = mine.store.increase("harmony_table_layout_changes_total",
                                            window=60, until=T0 + 10)
    assert inc == 2.0


def test_the_scraper_thread_polls_and_stops():
    store = thist.HistoryStore(window_sec=60, resolution_sec=1)
    polled = threading.Event()
    scraper = thist.HistoryScraper(store, targets_fn=lambda: {}, period=0.05,
                                   on_cycle=polled.set)
    scraper.start()
    try:
        assert polled.wait(TIMEOUT)
    finally:
        scraper.stop()
    assert scraper._thread is None
    polled.clear()
    scraper.start()      # a stopped scraper polls again when restarted
    try:
        assert polled.wait(TIMEOUT)
    finally:
        scraper.stop()


@pytest.mark.parametrize("raw", [
    "", "svc=10.0.0.5:9464, 10.0.0.6:9464", "a=http://h:1,b=nohost,c=https://x:2/",
])
def test_extra_targets_parse_as_the_references(monkeypatch, raw):
    monkeypatch.setenv("HARMONY_OBS_SCRAPE_TARGETS", raw)
    assert thist.extra_targets() == jhist.extra_targets()


@pytest.mark.parametrize("env", [
    {}, {"HARMONY_OBS_SCRAPE_PERIOD": "0.25", "HARMONY_OBS_RESOLUTION": "0.25"},
    {"HARMONY_OBS_SCRAPE_PERIOD": "0.001", "HARMONY_OBS_HISTORY_WINDOW": "bad"},
])
def test_the_knobs_read_as_the_references(monkeypatch, env):
    for k in ("HARMONY_OBS_SCRAPE_PERIOD", "HARMONY_OBS_HISTORY_WINDOW",
              "HARMONY_OBS_RESOLUTION"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for fn in ("scrape_period", "history_window", "resolution"):
        assert getattr(thist, fn)() == getattr(jhist, fn)()


# -- the exporter -------------------------------------------------------------------


def test_metrics_is_byte_identical_to_expose_and_healthz_answers(fresh, exporters):
    reg = _same_ops(treg)
    exp = exporters.add(texp.MetricsExporter(0, registry=reg, host="127.0.0.1").start())
    status, ctype, body = _get(exp.url + "/metrics")
    assert status == 200 and ctype == texp.CONTENT_TYPE == jexp.CONTENT_TYPE
    assert body == reg.expose().encode()
    assert treg.lint_exposition(body.decode()) == []
    assert _get(exp.url + "/metrics?x=1")[2] == reg.expose().encode()
    assert _get(exp.url + "/healthz")[:3:2] == (200, b"ok\n")
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(exp.url + "/nope")
    assert e.value.code == 404
    # no registry given: the live process registry
    live = exporters.add(texp.MetricsExporter(0, host="127.0.0.1").start())
    treg.get_registry().counter("harmony_live_total", "live").inc()
    assert b"harmony_live_total" in _get(live.url + "/metrics")[2]


def test_the_two_packages_serve_the_same_bytes_for_the_same_operations(fresh, exporters):
    bodies = []
    for reg_mod, exp_mod in ((treg, texp), (jreg, jexp)):
        exp = exporters.add(exp_mod.MetricsExporter(0, registry=_same_ops(reg_mod),
                                                    host="127.0.0.1").start())
        bodies.append(_get(exp.url + "/metrics")[2])
    assert bodies[0] == bodies[1]


def test_the_port_knob_behaves_as_the_references(monkeypatch, exporters):
    for mod in (texp, jexp):
        monkeypatch.delenv("HARMONY_METRICS_PORT", raising=False)
        assert mod.exporter_from_env() is None
        monkeypatch.setenv("HARMONY_METRICS_PORT", "not-a-port")
        assert mod.exporter_from_env() is None
        monkeypatch.setenv("HARMONY_METRICS_PORT", "0")
        exp = exporters.add(mod.exporter_from_env())
        assert exp.port > 0 and _get(exp.url + "/healthz")[2] == b"ok\n"
        # a fixed port already taken falls back to an ephemeral one
        taken = socket.socket()
        try:
            taken.bind(("0.0.0.0", 0))
            taken.listen(1)
            monkeypatch.setenv("HARMONY_METRICS_PORT", str(taken.getsockname()[1]))
            exp2 = exporters.add(mod.exporter_from_env())
            assert exp2.port not in (0, taken.getsockname()[1])
            assert _get(exp2.url + "/healthz")[0] == 200
        finally:
            taken.close()
        monkeypatch.setenv("HARMONY_METRICS_PORT", "99999999")   # out of range
        exp3 = exporters.add(mod.exporter_from_env())
        assert exp3.port > 0
