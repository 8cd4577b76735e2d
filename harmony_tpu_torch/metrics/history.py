"""Bounded in-memory telemetry history — the sensor layer under the doctor.

A copy of ``harmony_tpu/metrics/history.py`` (pure Python; the port keeps
its own), with the reference's series names. Gauges, STATUS and ``obs top``
are point-in-time snapshots; this module is the time axis:

  * :class:`HistoryStore` — per-series ring buffers with windowed
    downsampling (one point per ``HARMONY_OBS_RESOLUTION`` bucket,
    bounded by ``HARMONY_OBS_HISTORY_WINDOW``), counter-rate derivation
    that detects resets (a reset is itself a signal: the process behind
    the series restarted), explicit missed-scrape **gap markers** (rates
    never interpolate across a gap), and a label-filtered query API
    (:meth:`HistoryStore.range` / :meth:`rate` / :meth:`latest`);
  * :class:`ScrapeClient` — the hardened scrape helper: bounded
    connect/read timeouts, bounded retry through
    :func:`harmony_tpu_torch.faults.retry.call_with_retry` under a
    :class:`~harmony_tpu_torch.config.params.RetryPolicy`, and per-target
    ``harmony_obs_scrape_total{target,result}`` counters — a dead
    follower must never wedge or skew the scraper loop;
  * :class:`HistoryScraper` — a JobServer-side thread polling every
    known process's ``/metrics`` endpoint (the in-process registry for
    the server itself, pod followers' exporters discovered from their
    heartbeats, plus any ``HARMONY_OBS_SCRAPE_TARGETS`` extras) through
    :func:`~harmony_tpu_torch.metrics.registry.parse_exposition`, and
    folding the tenant-ledger rows in locally (``tenant.*``,
    ``tenant.phase.*``, ``tenant.slo_attainment``, ``tenant.serving.*``).
    A None field stays unknown, never 0: the port's ``mfu`` is None (no
    FLOP count yet), so no ``tenant.mfu`` series appears. The scraper
    reads host numbers only: no device sync, no launch.

The store is what :mod:`harmony_tpu_torch.metrics.doctor` diagnoses over.

Knobs: ``HARMONY_OBS_SCRAPE_PERIOD`` (seconds between polls, default 5),
``HARMONY_OBS_HISTORY_WINDOW`` (seconds retained, default 900),
``HARMONY_OBS_RESOLUTION`` (downsampling bucket, default 5),
``HARMONY_OBS_SCRAPE_TARGETS`` (extra ``name=host:port`` endpoints,
comma-separated).
"""
from __future__ import annotations

import os
import threading
import time
import urllib.request
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from harmony_tpu_torch.metrics.registry import parse_exposition

ENV_SCRAPE_PERIOD = "HARMONY_OBS_SCRAPE_PERIOD"
ENV_WINDOW = "HARMONY_OBS_HISTORY_WINDOW"
ENV_RESOLUTION = "HARMONY_OBS_RESOLUTION"
ENV_EXTRA_TARGETS = "HARMONY_OBS_SCRAPE_TARGETS"

#: hard ceiling on distinct series — a runaway label (e.g. a per-batch
#: id leaking into a labelset) must saturate, not eat the heap; drops
#: are counted and surfaced via :meth:`HistoryStore.stats`
_MAX_SERIES = 4096
#: reset/gap marks kept per series/target (old marks age out of the
#: window anyway; the bound is for pathological flapping)
_MAX_MARKS = 64
#: exposition-body ceiling per scrape — a misdirected target (a log
#: tail, a streaming endpoint) must fail the poll, not eat the heap
_MAX_SCRAPE_BYTES = 8 * 1024 * 1024
_READ_CHUNK = 65536


def _env_float(name: str, default: float, floor: float) -> float:
    try:
        return max(floor, float(os.environ.get(name, "") or default))
    except ValueError:
        return default


def scrape_period() -> float:
    """Seconds between scraper polls (``HARMONY_OBS_SCRAPE_PERIOD``)."""
    return _env_float(ENV_SCRAPE_PERIOD, 5.0, 0.05)


def history_window() -> float:
    """Seconds of history retained (``HARMONY_OBS_HISTORY_WINDOW``)."""
    return _env_float(ENV_WINDOW, 900.0, 1.0)


def resolution() -> float:
    """Downsampling bucket width (``HARMONY_OBS_RESOLUTION``)."""
    return _env_float(ENV_RESOLUTION, 5.0, 0.01)


def extra_targets() -> Dict[str, str]:
    """``HARMONY_OBS_SCRAPE_TARGETS``: extra exposition endpoints the
    heartbeat plumbing cannot discover (standalone services,
    sidecars) as ``name=host:port`` pairs, comma-separated. Bare
    ``host:port`` entries get a generated name. Malformed entries are
    dropped, never fatal."""
    raw = os.environ.get(ENV_EXTRA_TARGETS, "").strip()
    out: Dict[str, str] = {}
    if not raw:
        return out
    for i, part in enumerate(p.strip() for p in raw.split(",")):
        if not part:
            continue
        if "=" in part:
            name, addr = part.split("=", 1)
        else:
            name, addr = f"extra:{i}", part
        addr = addr.strip()
        for scheme in ("http://", "https://"):
            # operators naturally paste full endpoints; a double-scheme
            # URL would fail every scrape forever with a baffling error
            if addr.startswith(scheme):
                addr = addr[len(scheme):]
        if ":" not in addr:
            continue
        out[name.strip()] = f"http://{addr}/metrics"
    return out


class _Series:
    """One (name, labelset) ring. All mutation under the store lock."""

    __slots__ = ("name", "labels", "kind", "target", "points",
                 "last_raw", "resets", "first_ts")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 kind: str, target: Optional[str],
                 capacity: int, first_ts: float) -> None:
        self.name = name
        self.labels = labels
        self.kind = kind
        self.target = target
        #: (bucket_ts, value) — one point per resolution bucket
        self.points: "deque[Tuple[float, float]]" = deque(maxlen=capacity)
        self.last_raw: Optional[float] = None
        #: timestamps where a counter reset was observed — rate() never
        #: derives across one
        self.resets: "deque[float]" = deque(maxlen=_MAX_MARKS)
        #: when this series was FIRST ingested (not window-clipped):
        #: increase() uses it to tell a counter born mid-observation
        #: (its first value is all new events) from one that predates
        #: observation (its first value is historical baggage)
        self.first_ts = first_ts


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _matches(series_labels: Tuple[Tuple[str, str], ...],
             want: Optional[Dict[str, str]]) -> bool:
    if not want:
        return True
    have = dict(series_labels)
    return all(have.get(str(k)) == str(v) for k, v in want.items())


class HistoryStore:
    """Bounded in-memory time-series store; see the module docstring."""

    def __init__(self, window_sec: Optional[float] = None,
                 resolution_sec: Optional[float] = None) -> None:
        self._lock = threading.Lock()
        self.window_sec = float(window_sec if window_sec is not None
                                else history_window())
        self.resolution_sec = float(
            resolution_sec if resolution_sec is not None else resolution())
        # the ring must hold a full window at one point per bucket (+1
        # so the oldest in-window point survives the newest's arrival)
        self._capacity = max(2, int(self.window_sec
                                    / self.resolution_sec) + 1)
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                           _Series] = {}
        #: target -> missed-scrape timestamps (no interpolation across)
        self._gaps: Dict[str, "deque[float]"] = {}
        #: target -> {"pid": str|None, "start_time": float|None}
        self._target_meta: Dict[str, Dict[str, Any]] = {}
        self._dropped_series = 0
        self._evicted_series = 0
        self._restarts = 0
        self._ingested = 0
        self._last_prune = 0.0

    # -- ingest ----------------------------------------------------------

    def _bucket(self, ts: float) -> float:
        return ts - (ts % self.resolution_sec)

    def ingest(self, name: str, labels: Dict[str, str], value: float,
               ts: Optional[float] = None, kind: str = "gauge",
               target: Optional[str] = None) -> bool:
        """Fold one sample in. Returns True when this sample is a
        counter RESET (value fell below the series' last raw value) —
        the caller decides whether that aggregates into a
        process-restart signal."""
        ts = time.time() if ts is None else float(ts)
        key = (name, _label_key(labels))
        reset = False
        with self._lock:
            if ts - self._last_prune > max(1.0, self.window_sec / 4.0):
                self._prune_locked(ts)
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= _MAX_SERIES:
                    # cap pressure: evict window-expired series first —
                    # tenant churn must not permanently blind the store
                    # to NEW tenants while dead ones hold the cap
                    self._prune_locked(ts)
                if len(self._series) >= _MAX_SERIES:
                    self._dropped_series += 1
                    return False
                s = self._series[key] = _Series(
                    name, key[1], kind, target, self._capacity, ts)
            v = float(value)
            if (kind == "counter" and s.last_raw is not None
                    and v < s.last_raw - 1e-9):
                reset = True
                # stored at bucket resolution: rate()/increase() compare
                # marks against bucket-floored point timestamps, and a
                # raw mark could land strictly between two floors and
                # never match an interval
                s.resets.append(self._bucket(ts))
            s.last_raw = v
            bucket = self._bucket(ts)
            if s.points and s.points[-1][0] == bucket:
                # same resolution bucket: last wins (counters are
                # monotone between resets, so last is also max)
                s.points[-1] = (bucket, v)
            else:
                s.points.append((bucket, v))
            self._ingested += 1
        return reset

    def _prune_locked(self, now: float) -> None:
        """Evict series whose newest point aged out of the window
        (caller holds the lock). Churning tenants create series forever;
        without eviction the cap saturates and new tenants silently get
        no history while dead ones hold it."""
        cutoff = now - self.window_sec
        dead = [k for k, s in self._series.items()
                if not s.points or s.points[-1][0] < cutoff]
        for k in dead:
            del self._series[k]
        self._evicted_series += len(dead)
        # per-target bookkeeping follows its series out: follower churn
        # mints a new "pod:<pid>" name per replacement, and meta/gap
        # entries for names that stopped scraping would grow forever
        # (and drown the live targets in stats()["targets"])
        live = {s.target for s in self._series.values()
                if s.target is not None}
        for t in [t for t in self._target_meta if t not in live]:
            del self._target_meta[t]
        for t in [t for t in self._gaps if t not in live]:
            del self._gaps[t]
        self._last_prune = now

    def ingest_exposition(self, target: str,
                          families: "Dict[str, Dict[str, Any]] | str",
                          ts: Optional[float] = None) -> Dict[str, Any]:
        """Fold one scraped exposition (parsed families, or raw text)
        into the store under ``target``. Histogram ``_bucket`` samples
        are skipped (the per-le fan-out would eat the series budget);
        ``_sum``/``_count`` are kept as counters so rates still derive.
        The constant ``pid`` label is LIFTED off every labelset into
        per-target metadata — an exporter restart stamps a new pid, and
        keeping it in the key would fork every series instead of
        tripping reset detection on the existing ones.

        Returns ``{"samples", "resets", "restart", "pid"}`` —
        ``restart`` is True when this scrape is the first evidence of a
        process restart behind ``target`` (pid changed, the process
        start-time moved, or any counter reset), reported ONCE per
        restart no matter how many series reset."""
        ts = time.time() if ts is None else float(ts)
        if isinstance(families, str):
            families = parse_exposition(families)
        samples = 0
        resets = 0
        pid: Optional[str] = None
        start_time: Optional[float] = None
        for fname, fam in families.items():
            ftype = fam.get("type")
            if ftype not in ("counter", "gauge", "histogram"):
                continue
            for sname, labels, value in fam.get("samples", ()):
                if ftype == "histogram" and sname.endswith("_bucket"):
                    continue
                kind = ("counter" if ftype == "counter"
                        or sname.endswith(("_sum", "_count")) else "gauge")
                lab = {k: v for k, v in labels.items() if k != "pid"}
                if pid is None and "pid" in labels:
                    pid = labels["pid"]
                if "target" in lab:
                    # the exposition's OWN target label (e.g. the
                    # leader's harmony_obs_scrape_total{target=...})
                    # must survive under another key — clobbering it
                    # collapsed per-target counters into one series
                    # whose interleaved values tripped reset detection
                    # every cycle
                    lab["exported_target"] = lab.pop("target")
                lab["target"] = target
                if fname == "harmony_process_start_time_seconds":
                    start_time = float(value)
                if self.ingest(sname, lab, value, ts=ts, kind=kind,
                               target=target):
                    resets += 1
                samples += 1
        restart = False
        with self._lock:
            meta = self._target_meta.setdefault(
                target, {"pid": None, "start_time": None,
                         "first_ts": ts})
            pid_changed = (pid is not None and meta["pid"] is not None
                           and pid != meta["pid"])
            start_moved = (start_time is not None
                           and meta["start_time"] is not None
                           and start_time > meta["start_time"] + 1.0)
            if pid_changed or start_moved or resets:
                restart = True
                self._restarts += 1
                # a restarted process's counters all restart from zero:
                # clear the stale baseline of every series of this
                # target NOT updated by this scrape, so a counter that
                # only REAPPEARS lazily a few scrapes later (first
                # post-restart retry, say) cannot trip reset detection
                # again — one restart, ONE event
                bucket = self._bucket(ts)
                for s2 in self._series.values():
                    if (s2.target == target
                            and (not s2.points
                                 or s2.points[-1][0] < bucket)):
                        s2.last_raw = None
            if pid is not None:
                meta["pid"] = pid
            if start_time is not None:
                meta["start_time"] = start_time
        return {"samples": samples, "resets": resets,
                "restart": restart, "pid": pid}

    def mark_gap(self, target: str, ts: Optional[float] = None) -> None:
        """Record a missed scrape of ``target``: rate() refuses to
        derive across the mark (no interpolation across gaps — a dead
        follower's flat-line must read as *unknown*, not zero slope).
        Marks are stored at bucket resolution, same clock as the points
        they are compared against."""
        ts = time.time() if ts is None else float(ts)
        with self._lock:
            ring = self._gaps.setdefault(target, deque(maxlen=_MAX_MARKS))
            ring.append(self._bucket(ts))

    # -- queries ---------------------------------------------------------

    def _select(self, name: str,
                labels: Optional[Dict[str, str]]) -> List[_Series]:
        return [s for (n, _k), s in self._series.items()
                if n == name and _matches(s.labels, labels)]

    def range(self, name: str, labels: Optional[Dict[str, str]] = None,
              since: Optional[float] = None,
              until: Optional[float] = None,
              ) -> List[Tuple[Dict[str, str], List[Tuple[float, float]]]]:
        """Matching series' points, label-filtered (``labels`` is a
        subset match), clipped to [since, until]."""
        with self._lock:
            out = []
            for s in self._select(name, labels):
                pts = [(t, v) for (t, v) in s.points
                       if (since is None or t >= since)
                       and (until is None or t <= until)]
                if pts:
                    out.append((dict(s.labels), pts))
        return out

    def latest(self, name: str, labels: Optional[Dict[str, str]] = None,
               ) -> List[Tuple[Dict[str, str], float, float]]:
        """Newest (labels, ts, value) per matching series."""
        with self._lock:
            out = []
            for s in self._select(name, labels):
                if s.points:
                    t, v = s.points[-1]
                    out.append((dict(s.labels), t, v))
        return out

    def rate(self, name: str, labels: Optional[Dict[str, str]] = None,
             window: Optional[float] = None,
             until: Optional[float] = None,
             ) -> List[Tuple[Dict[str, str], Optional[float]]]:
        """Windowed per-second rate per matching counter series, derived
        pairwise over consecutive points — an interval containing a
        counter reset or a missed-scrape gap mark contributes NOTHING
        (never a negative rate, never a value interpolated across a dead
        stretch). None when fewer than two usable points. ``until``
        anchors the window's right edge (default: the wall clock) so a
        driven-time caller — the doctor's ``diagnose(now=)`` — sees ONE
        consistent window across every query primitive."""
        w = window if window is not None else self.window_sec
        now = time.time() if until is None else float(until)
        cutoff = now - w
        with self._lock:
            out = []
            for s in self._select(name, labels):
                pts = [(t, v) for (t, v) in s.points if t >= cutoff]
                gaps = [g for g in self._gaps.get(s.target or "", ())
                        if g >= cutoff]
                resets = [r for r in s.resets if r >= cutoff]
                dv = 0.0
                dt = 0.0
                for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
                    if v1 < v0:
                        continue  # reset interval: no negative rates
                    if any(t0 < m <= t1 for m in resets):
                        continue
                    if any(t0 < m <= t1 for m in gaps):
                        continue  # no interpolation across a gap
                    dv += v1 - v0
                    dt += t1 - t0
                out.append((dict(s.labels),
                            (dv / dt) if dt > 0 else None))
        return out

    def increase(self, name: str,
                 labels: Optional[Dict[str, str]] = None,
                 window: Optional[float] = None,
                 until: Optional[float] = None,
                 ) -> List[Tuple[Dict[str, str], float]]:
        """Windowed counter INCREASE per matching series — the burst
        detector's primitive. Pairwise like :meth:`rate` (reset/gap
        intervals contribute nothing), with one addition: a series that
        was BORN mid-observation (its first-ever sample arrived after
        its target's first scrape — e.g. the first fault-fire creating
        its counter) counts its initial value too, because every one of
        those events happened while we were watching. A series that
        predates observation does not — its first sample is historical
        baggage, not a burst. ``until`` anchors the right edge like
        :meth:`rate`'s."""
        w = window if window is not None else self.window_sec
        now = time.time() if until is None else float(until)
        cutoff = now - w
        with self._lock:
            out = []
            for s in self._select(name, labels):
                pts = [(t, v) for (t, v) in s.points if t >= cutoff]
                if not pts:
                    continue
                gaps = [g for g in self._gaps.get(s.target or "", ())
                        if g >= cutoff]
                resets = [r for r in s.resets if r >= cutoff]
                inc = 0.0
                for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
                    if v1 < v0:
                        continue
                    if any(t0 < m <= t1 for m in resets):
                        continue
                    if any(t0 < m <= t1 for m in gaps):
                        continue
                    inc += v1 - v0
                meta = (self._target_meta.get(s.target)
                        if s.target else None)
                target_first = (meta or {}).get("first_ts")
                if (target_first is not None
                        and s.first_ts > target_first
                        and s.first_ts >= cutoff):
                    inc += pts[0][1]
                out.append((dict(s.labels), inc))
        return out

    def target_pid(self, target: str) -> Optional[str]:
        """The OS pid last seen behind ``target`` (lifted off the
        ``pid`` exposition label) — the doctor's pid attribution."""
        with self._lock:
            meta = self._target_meta.get(target)
            return meta.get("pid") if meta else None

    def resets(self, target: Optional[str] = None) -> int:
        with self._lock:
            return sum(len(s.resets) for s in self._series.values()
                       if target is None or s.target == target)

    def gaps(self, target: Optional[str] = None) -> List[float]:
        with self._lock:
            if target is not None:
                return list(self._gaps.get(target, ()))
            return sorted(t for ring in self._gaps.values() for t in ring)

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted({n for (n, _k) in self._series})

    def stats(self) -> Dict[str, Any]:
        """Store shape for STATUS / ``obs doctor`` headers — counts,
        not data (the data surface is :meth:`snapshot`)."""
        with self._lock:
            return {
                "series": len(self._series),
                "points": sum(len(s.points)
                              for s in self._series.values()),
                "ingested_total": self._ingested,
                "window_sec": self.window_sec,
                "resolution_sec": self.resolution_sec,
                "gap_marks": sum(len(r) for r in self._gaps.values()),
                "restarts": self._restarts,
                "dropped_series": self._dropped_series,
                "evicted_series": self._evicted_series,
                "targets": sorted(self._target_meta),
            }

    def snapshot(self, names: Optional[Sequence[str]] = None,
                 since: Optional[float] = None) -> Dict[str, Any]:
        """JSON-ready dump of (a subset of) the store — the dashboard /
        flight-recorder face. Bounded by the rings themselves."""
        with self._lock:
            want = set(names) if names is not None else None
            out: Dict[str, Any] = {}
            for (n, _k), s in self._series.items():
                if want is not None and n not in want:
                    continue
                pts = [[t, v] for (t, v) in s.points
                       if since is None or t >= since]
                if pts:
                    out.setdefault(n, []).append(
                        {"labels": dict(s.labels), "kind": s.kind,
                         "points": pts})
        return out

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._gaps.clear()
            self._target_meta.clear()


# -- hardened scrape client (satellite: scrape-client hardening) -----------


class ScrapeClient:
    """Shared scrape helper with bounded timeouts and bounded retry.

    One slow or dead target must cost at most ``timeout × attempts`` and
    must never wedge the scraper loop: connect/read share one bounded
    timeout, failures retry through :func:`harmony_tpu_torch.faults.retry.
    call_with_retry` under a small :class:`RetryPolicy`, and every
    outcome counts into ``harmony_obs_scrape_total{target,result}`` so a
    flapping endpoint is visible as data, not log noise."""

    def __init__(self, timeout: float = 3.0, policy=None) -> None:
        from harmony_tpu_torch.config.params import RetryPolicy

        self.timeout = float(timeout)
        self.policy = policy or RetryPolicy(
            max_attempts=2, base_delay_sec=0.05, max_delay_sec=0.5)

    @staticmethod
    def _count(target: str, result: str) -> None:
        try:
            from harmony_tpu_torch.metrics.registry import get_registry

            get_registry().counter(
                "harmony_obs_scrape_total",
                "History-scraper polls per target (result: ok = "
                "exposition ingested, error = the poll failed — wire, "
                "retry exhaustion, or unusable exposition — and a gap "
                "was marked)",
                ("target", "result"),
            ).labels(target=target, result=result).inc()
        except Exception:
            pass  # observability must never fail the scrape path

    def fetch(self, target: str, url: str) -> str:
        """One target's exposition text, or raise (RetryError after the
        bounded attempts). Counting happens in the scraper loop once the
        exposition proves USABLE — a 200 carrying an HTML error page
        must not count ``ok`` (the documented contract: ok = exposition
        ingested)."""
        from harmony_tpu_torch.faults.retry import call_with_retry

        deadline = time.monotonic() + self.timeout * (
            self.policy.max_attempts + 1)

        def attempt() -> str:
            with urllib.request.urlopen(url, timeout=self.timeout) as r:
                return _read_bounded(r, deadline).decode()

        return call_with_retry(
            attempt, self.policy, op="obs.scrape",
            retryable=(OSError, TimeoutError, ValueError),
            deadline=deadline)


def _read_bounded(resp, deadline: float,
                  cap: int = _MAX_SCRAPE_BYTES) -> bytes:
    """Read a response body under BOTH a size cap and a wall deadline.
    The urllib timeout is per-socket-op: a trickling sender (one byte
    every couple of seconds) completes every recv inside the timeout
    and ``read()`` would block the scraper thread forever — 'never a
    wedged loop' means the WALL clock is bounded, not each recv."""
    chunks: List[bytes] = []
    total = 0
    while True:
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"scrape body still streaming at the {total}-byte mark "
                "past the deadline")
        chunk = resp.read(_READ_CHUNK)
        if not chunk:
            return b"".join(chunks)
        total += len(chunk)
        if total > cap:
            raise ValueError(
                f"scrape body exceeds {cap} bytes — not an exposition")
        chunks.append(chunk)


# -- scraper loop ----------------------------------------------------------

#: tenant-ledger fields folded into first-class ``tenant.*`` series
#: (labels job/attempt). None values are *unknown* and are not ingested
#: — the ledger's explicit-None contract carries into history.
_TENANT_FIELDS = (
    ("tenant.samples_per_sec", "samples_per_sec"),
    ("tenant.mfu", "mfu"),
    ("tenant.input_wait_frac", "input_wait_frac"),
    ("tenant.device_seconds", "device_seconds"),
    ("tenant.straggler_ratio", "straggler_ratio"),
    ("tenant.workers", "workers"),
)


class HistoryScraper:
    """Polls every known target each ``HARMONY_OBS_SCRAPE_PERIOD`` and
    folds results (plus the local tenant-ledger snapshot) into a
    :class:`HistoryStore`.

    ``targets_fn`` returns ``{name: spec}`` where spec is a URL string
    (scraped over HTTP through the hardened client) or a zero-arg
    callable returning exposition text (the leader's own registry —
    ``registry.expose`` — pays no HTTP). ``on_restart(target, info)``
    fires once per detected process restart (default: a structured
    ``kind="process_restart"`` joblog event); ``on_cycle()`` runs after
    every poll (the doctor's evaluation hook)."""

    def __init__(self, store: HistoryStore,
                 targets_fn: Callable[[], Dict[str, Any]],
                 ledger_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 period: Optional[float] = None,
                 client: Optional[ScrapeClient] = None,
                 on_restart: Optional[Callable[..., None]] = None,
                 on_cycle: Optional[Callable[[], None]] = None) -> None:
        self.store = store
        self._targets_fn = targets_fn
        self._ledger_fn = ledger_fn
        self.period = float(period if period is not None
                            else scrape_period())
        self.client = client or ScrapeClient()
        self._on_restart = on_restart or _record_restart_event
        self._on_cycle = on_cycle
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._last_errors: Dict[str, str] = {}
        self._cycles = 0
        #: wall time of the newest poll cycle — the overload detector's
        #: scrape-overrun signal (jobserver/overload.py)
        self._last_cycle_ms = 0.0
        #: lazily-created, REUSED scrape pool — the loop runs forever
        #: at scrape-period cadence; a fresh pool per cycle would churn
        #: OS threads inside the control plane
        self._pool = None

    # -- one poll --------------------------------------------------------

    def poll_once(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One full cycle over every target + the local ledger; public
        so tests can drive time themselves. Per-
        target failures mark a gap and continue — a dead follower never
        wedges the loop or skews the other targets' series."""
        ts = time.time() if now is None else float(now)
        t_start = time.monotonic()
        report: Dict[str, Any] = {"targets": {}, "ts": ts}
        try:
            targets = dict(self._targets_fn() or {})
        except Exception as e:  # a broken provider must not kill the loop
            targets = {}
            report["targets_error"] = f"{type(e).__name__}: {e}"

        def scrape_one(name: str, spec: Any) -> Dict[str, Any]:
            # pure fetch+ingest (the store locks internally); all
            # scraper-state mutation stays on the caller's thread
            text = (spec() if callable(spec)
                    else self.client.fetch(name, str(spec)))
            return self.store.ingest_exposition(name, text, ts=ts)

        # one slow target must cost ITSELF its bounded timeout without
        # serially delaying every other target past the scrape period —
        # targets scrape concurrently; each is individually deadline-
        # capped (ScrapeClient), so the pool drains by then too
        items = sorted(targets.items())
        if len(items) <= 1:
            futures = [(n, None, spec) for n, spec in items]
        else:
            pool = self._get_pool()
            futures = [(n, pool.submit(scrape_one, n, spec), spec)
                       for n, spec in items]
        for name, fut, spec in futures:
            try:
                # ok counts only once the exposition proved USABLE
                # (ingested); a wire failure, an unparseable body, and
                # a broken callable are all one `error` + one gap mark
                info = (scrape_one(name, spec) if fut is None
                        else fut.result())
                ScrapeClient._count(name, "ok")
            except Exception as e:
                ScrapeClient._count(name, "error")
                self.store.mark_gap(name, ts=ts)
                with self._lock:
                    self._last_errors[name] = f"{type(e).__name__}: {e}"
                report["targets"][name] = "gap"
                continue
            with self._lock:
                self._last_errors.pop(name, None)
            report["targets"][name] = info
            if info.get("restart"):
                try:
                    self._on_restart(name, info)
                except Exception:
                    pass  # restart bookkeeping must not stall the poll
        if self._ledger_fn is not None:
            try:
                rows = self._ledger_fn() or {}
            except Exception:
                rows = {}
            for job, row in rows.items():
                labels = {"job": str(job),
                          "attempt": str(row.get("attempt", job))}
                for series, field in _TENANT_FIELDS:
                    v = row.get(field)
                    if v is None:
                        continue  # unknown is unknown, not 0
                    self.store.ingest(series, labels, float(v), ts=ts)
                # step-phase budget fold (metrics/phases.py): the
                # ledger join carries each tenant's windowed phase
                # FRACTIONS — first-class tenant.phase.* series, the
                # comm_bound/dispatch_bound rules' raw material. An
                # absent budget (no worker fed yet) stays unknown.
                for p, v in (row.get("phases") or {}).items():
                    if v is None:
                        continue
                    self.store.ingest(f"tenant.phase.{p}", labels,
                                      float(v), ts=ts)
                slo = row.get("slo") or {}
                if slo.get("attainment") is not None:
                    self.store.ingest("tenant.slo_attainment", labels,
                                      float(slo["attainment"]), ts=ts)
                # serving fold (serving/service.py): the endpoint's
                # windowed latency/traffic summary becomes first-class
                # tenant.serving.* series — the serving_slo_breach
                # rule's raw material. Absent until the serving plane
                # reports this tenant; None fields stay unknown.
                srv = row.get("serving") or {}
                if srv.get("enabled"):
                    for f in ("qps", "p50_ms", "p99_ms", "slo_p99_ms",
                              "batch_occupancy", "cache_hit_rate"):
                        if srv.get(f) is not None:
                            self.store.ingest(f"tenant.serving.{f}",
                                              labels, float(srv[f]),
                                              ts=ts)
        with self._lock:
            self._cycles += 1
            self._last_cycle_ms = (time.monotonic() - t_start) * 1000.0
            # vanished targets (a replaced follower's old pid) must not
            # pin their last error forever — errors clear on a later
            # success of the SAME name, which a gone name never has
            for name in [n for n in self._last_errors if n not in targets]:
                del self._last_errors[name]
        if self._on_cycle is not None:
            try:
                self._on_cycle()
            except Exception:
                pass  # a doctor bug must not stop the sensor loop
        return report

    def _get_pool(self):
        with self._lock:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=8, thread_name_prefix="obs-scrape")
            return self._pool

    # -- thread lifecycle ------------------------------------------------

    def _loop(self) -> None:
        while not self._stop_ev.wait(self.period):
            try:
                self.poll_once()
            except Exception:
                continue  # the sensor loop must never die

    def start(self) -> "HistoryScraper":
        if self._thread is None:
            # a restarted scraper must actually poll: stop() left the
            # event set, and a loop spawned against it would exit on
            # its first wait without ever scraping
            self._stop_ev.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="obs-history-scraper")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_ev.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"period_sec": self.period, "cycles": self._cycles,
                    "last_cycle_ms": round(self._last_cycle_ms, 3),
                    "last_errors": dict(self._last_errors)}


def _record_restart_event(target: str, info: Dict[str, Any]) -> None:
    """Default restart hook: one structured ``kind="process_restart"``
    joblog event keyed by the target (it rides STATUS ``job_events``
    like every recovery event). Lazy, guarded import — the metrics
    package must not hard-depend on the jobserver."""
    try:
        from harmony_tpu_torch.jobserver.joblog import record_event

        record_event(target, "process_restart", target=target,
                     pid=info.get("pid"),
                     counter_resets=int(info.get("resets", 0)))
    except Exception:
        pass
