"""Incident correlation engine: fault → diagnosis → action → resolution.

A copy of ``harmony_tpu/metrics/incidents.py`` (pure Python; the port keeps
its own). The sensors (history + doctor), the explanation (critpath) and
the recovery paths each speak in their own joblog event kind; this module
folds them into **incidents**: one object per correlated episode, with an
``open → mitigating → resolved`` lifecycle, a causal ``chain`` of typed
edges (trigger evidence → diagnosis → action → resolution verdict), and
first-class MTTD / time-to-mitigate / MTTR accounting exported through the
metric registry as ``harmony_incident_*``.

Correlation rules:

* **Roles.** Every consumed event kind is classified as a *trigger*
  (``slo``, ``serving_slo``, ``overload``, ``process_restart``,
  ``follower_silenced``, plus the flight-ring fault evidence
  ``fault_trip`` / ``follower_death`` / ``follower_job_failed``), a
  *diagnosis* (``diagnosis``), an *action* (``policy``,
  ``leader_takeover``, the elastic fence/shrink/regrow/give-up family), or
  a *resolution* (``elastic_restore``, ``follower_rehabilitated``).
  Unclassified kinds are ignored; ``kind="incident"`` is always skipped
  (self-feedback).
* **Joins.** An event joins the newest open incident sharing a join
  key — same subject (tenant/job id; ``__ha__``/``__control__``/
  ``__pod__`` all map to ``cluster``), or same ``pid``, or same fault
  ``site``, or same ``trace_id`` — provided it lands within
  ``HARMONY_INCIDENT_WINDOW`` seconds of the incident's last evidence.
  Otherwise a trigger/diagnosis opens a new incident; bare
  actions/resolutions never open one.
* **Lifecycle.** First action edge moves ``open → mitigating``; a
  resolution edge moves to ``resolved`` (verdict ``recovered``). An
  incident with no new evidence for a full window quiesces to
  ``resolved`` (verdict ``quiesced``) so MTTR is always eventually
  defined. The open set is bounded by ``HARMONY_INCIDENT_MAX_OPEN``
  (oldest is force-resolved with verdict ``evicted``).
* **Clocks.** ``opened_ts`` is the trigger evidence's own timestamp;
  ``detected_ts`` is the first *joblog-side* evidence (a flight-ring
  fault trip is ground truth, not detection), so
  MTTD = detected_ts - opened_ts scores the stack's own sensing.
  MTTR = resolved_ts - opened_ts; time-to-mitigate likewise.

The port has no flight recorder yet (ROADMAP A item 6.4), so the evidence
is the joblog's alone: an incident's trigger is its first joblog event and
its MTTD is 0.

Incidents persist as ``kind="incident"`` joblog events (gated by
``HARMONY_INCIDENT_PERSIST``) so the HA tee lands them in the durable
log: a successor leader replays them (``ReplayState.incidents``) and
:meth:`IncidentEngine.adopt` keeps mid-flight incidents open across a
takeover. The process-wide singleton (:func:`set_incidents` /
:func:`peek_incidents`) mirrors the doctor's.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

from harmony_tpu_torch.metrics.registry import get_registry

ENV_WINDOW = "HARMONY_INCIDENT_WINDOW"
ENV_MAX_OPEN = "HARMONY_INCIDENT_MAX_OPEN"
ENV_PERSIST = "HARMONY_INCIDENT_PERSIST"

#: evidence that opens (or re-triggers) an incident
TRIGGER_KINDS = frozenset({
    "slo", "serving_slo", "overload", "process_restart",
    "follower_silenced", "fault_trip", "follower_death",
    "follower_job_failed",
})
DIAGNOSIS_KINDS = frozenset({"diagnosis"})
#: remediation the control plane took in answer
ACTION_KINDS = frozenset({
    "policy", "leader_takeover", "elastic_shrink", "elastic_regrow",
    "elastic_shrink_fence", "elastic_regrow_fence", "elastic_give_up",
})
#: evidence the episode ended well
RESOLUTION_KINDS = frozenset({"elastic_restore", "follower_rehabilitated"})

#: pseudo-job ids whose events are cluster-scoped, not tenant-scoped
_CLUSTER_JOBS = frozenset({"__ha__", "__control__", "__pod__",
                           "__incidents__"})
#: seconds-scale buckets for MTTD/MTTR (sub-second trips to multi-minute
#: recoveries)
_SECONDS_BUCKETS = (0.05, 0.25, 1.0, 5.0, 15.0, 60.0, 300.0)
#: resolved incidents retained for STATUS / `obs incidents`
_MAX_RESOLVED = 64
#: causal edges kept per incident (a flapping trigger must not grow
#: an unbounded chain)
_MAX_CHAIN = 32
#: fields copied off evidence events onto chain edges / join keys
_JOIN_FIELDS = ("pid", "site", "trace_id", "rule", "verdict", "action",
                "reason", "recovery", "level", "follower", "attempt")


def _env_float(name: str, default: float, floor: float) -> float:
    try:
        return max(floor, float(os.environ.get(name, "") or default))
    except ValueError:
        return default


def _env_int(name: str, default: int, floor: int) -> int:
    try:
        return max(floor, int(os.environ.get(name, "") or default))
    except ValueError:
        return default


def correlation_window() -> float:
    """Seconds of correlation window (``HARMONY_INCIDENT_WINDOW``)."""
    return _env_float(ENV_WINDOW, 120.0, 0.1)


def max_open_incidents() -> int:
    """Open-incident bound (``HARMONY_INCIDENT_MAX_OPEN``)."""
    return _env_int(ENV_MAX_OPEN, 64, 1)


def persist_enabled() -> bool:
    """Whether lifecycle transitions persist as ``kind="incident"``
    joblog events (``HARMONY_INCIDENT_PERSIST``, default on)."""
    return os.environ.get(ENV_PERSIST, "1").strip().lower() not in (
        "0", "false", "no", "off")


@dataclass
class Incident:
    """One correlated episode: trigger evidence, its causal chain, and
    lifecycle timestamps. ``chain`` holds typed edges
    ``{role, kind, ts, src, summary, ...join fields}``, oldest first."""

    incident_id: str
    subject: str
    trigger_kind: str
    opened_ts: float
    status: str = "open"
    detected_ts: Optional[float] = None
    mitigating_ts: Optional[float] = None
    resolved_ts: Optional[float] = None
    verdict: Optional[str] = None
    last_ts: float = 0.0
    site: Optional[str] = None
    pid: Optional[int] = None
    trace_id: Optional[str] = None
    chain: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def mttd(self) -> Optional[float]:
        """Seconds from trigger to first stack-side detection; None
        while (or if never) undetected by the joblog stream."""
        if self.detected_ts is None:
            return None
        return max(0.0, self.detected_ts - self.opened_ts)

    @property
    def time_to_mitigate(self) -> Optional[float]:
        if self.mitigating_ts is None:
            return None
        return max(0.0, self.mitigating_ts - self.opened_ts)

    @property
    def mttr(self) -> Optional[float]:
        """Seconds from trigger to resolution; None while open."""
        if self.resolved_ts is None:
            return None
        return max(0.0, self.resolved_ts - self.opened_ts)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "incident_id": self.incident_id,
            "subject": self.subject,
            "trigger_kind": self.trigger_kind,
            "status": self.status,
            "opened_ts": self.opened_ts,
            "detected_ts": self.detected_ts,
            "mitigating_ts": self.mitigating_ts,
            "resolved_ts": self.resolved_ts,
            "verdict": self.verdict,
            "last_ts": self.last_ts,
            "mttd_sec": self.mttd,
            "mitigate_sec": self.time_to_mitigate,
            "mttr_sec": self.mttr,
            "chain": list(self.chain),
        }
        for k in ("site", "pid", "trace_id"):
            if getattr(self, k) is not None:
                d[k] = getattr(self, k)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> Optional["Incident"]:
        """Rebuild from a persisted ``kind="incident"`` payload (HA
        replay). Returns None on a malformed entry — replay must never
        fail a takeover over one bad row."""
        try:
            inc = cls(
                incident_id=str(d["incident_id"]),
                subject=str(d.get("subject") or "cluster"),
                trigger_kind=str(d.get("trigger_kind") or "unknown"),
                opened_ts=float(d["opened_ts"]),
                status=str(d.get("status") or "open"),
            )
        except (KeyError, TypeError, ValueError):
            return None
        for k in ("detected_ts", "mitigating_ts", "resolved_ts"):
            v = d.get(k)
            if isinstance(v, (int, float)):
                setattr(inc, k, float(v))
        inc.verdict = d.get("verdict")
        inc.last_ts = float(d.get("last_ts") or inc.opened_ts)
        inc.site = d.get("site")
        inc.pid = d.get("pid") if isinstance(d.get("pid"), int) else None
        inc.trace_id = d.get("trace_id")
        ch = d.get("chain")
        if isinstance(ch, list):
            inc.chain = [dict(e) for e in ch
                         if isinstance(e, dict)][:_MAX_CHAIN]
        return inc


def _subject_of(job_id: Optional[str], ev: Dict[str, Any]) -> str:
    if job_id and job_id not in _CLUSTER_JOBS:
        return job_id
    for k in ("job", "ev_job"):
        v = ev.get(k)
        if isinstance(v, str) and v and v not in _CLUSTER_JOBS:
            return v
    return "cluster"


def _summarize(kind: str, ev: Dict[str, Any]) -> str:
    bits = [kind]
    for k in ("site", "rule", "verdict", "action", "reason", "recovery",
              "level", "follower"):
        v = ev.get(k)
        if v not in (None, ""):
            bits.append(f"{k}={v}")
    return " ".join(bits)[:160]


class IncidentEngine:
    """Folds the joblog stream into correlated :class:`Incident` objects.
    ``correlate(now=None)`` is the scrape-cycle entry point (``now`` is
    injectable so tests can fast-forward the quiescence clock); ``sinks``
    are best-effort callables invoked with the incident dict on every
    lifecycle transition."""

    def __init__(self, window_sec: Optional[float] = None,
                 max_open: Optional[int] = None,
                 persist: Optional[bool] = None,
                 sinks: Iterable[Callable[[Dict[str, Any]], None]] = ()
                 ) -> None:
        self.window_sec = (float(window_sec) if window_sec is not None
                           else correlation_window())
        self.max_open = (int(max_open) if max_open is not None
                         else max_open_incidents())
        self.persist = persist_enabled() if persist is None else bool(persist)
        self._sinks = list(sinks)
        self._lock = threading.Lock()
        self._open: Dict[str, Incident] = {}
        self._resolved: List[Incident] = []
        #: evidence watermark: events older than engine birth are
        #: history, not incidents (a successor leader must not re-open
        #: episodes the previous leader already lived through)
        self._since = time.time()
        self._seen: set = set()
        self._adopted = 0
        reg = get_registry()
        self._m_opened = reg.counter(
            "harmony_incident_opened_total",
            "incidents opened, by trigger event kind", ("kind",))
        self._m_resolved = reg.counter(
            "harmony_incident_resolved_total",
            "incidents resolved, by resolution verdict", ("verdict",))
        self._m_open = reg.gauge(
            "harmony_incident_open",
            "incidents currently open or mitigating")
        self._m_mttd = reg.histogram(
            "harmony_incident_mttd_seconds",
            "trigger-to-detection latency of resolved incidents",
            buckets=_SECONDS_BUCKETS)
        self._m_ttm = reg.histogram(
            "harmony_incident_mitigate_seconds",
            "trigger-to-first-mitigation latency of incidents",
            buckets=_SECONDS_BUCKETS)
        self._m_mttr = reg.histogram(
            "harmony_incident_mttr_seconds",
            "trigger-to-resolution latency of resolved incidents",
            buckets=_SECONDS_BUCKETS)

    # -- evidence harvest ------------------------------------------------

    def _harvest(self) -> List[tuple]:
        """New (subject, src, event) evidence since the last cycle,
        oldest first. The joblog rings are bounded, so the dedup set is
        too."""
        out: List[tuple] = []
        try:
            from harmony_tpu_torch.jobserver import joblog

            per_job = joblog.job_events(limit=64)
        except Exception:
            per_job = {}
        for job_id, evs in per_job.items():
            for ev in evs:
                kind = ev.get("kind")
                ts = ev.get("ts")
                if kind == "incident" or not isinstance(ts, (int, float)):
                    continue
                key = (job_id, round(float(ts), 6), kind)
                if ts < self._since or key in self._seen:
                    continue
                self._seen.add(key)
                out.append((_subject_of(job_id, ev), "joblog", ev))
        # the reference also harvests the flight recorder's ring here
        # (fault_trip, follower_death, follower_job_failed, as src "flight");
        # the port has no flight recorder until ROADMAP A item 6.4
        if len(self._seen) > 32768:  # rings are bounded; this is belt
            self._seen.clear()
        out.sort(key=lambda t: t[2].get("ts", 0.0))
        return out

    # -- correlation -----------------------------------------------------

    def _find_open(self, subject: str, ev: Dict[str, Any],
                   ts: float) -> Optional[Incident]:
        """Newest open incident this event joins: same subject, pid,
        site, or trace_id, within the correlation window."""
        best = None
        for inc in self._open.values():
            if ts - inc.last_ts > self.window_sec:
                continue
            joined = (inc.subject == subject
                      or (inc.pid is not None and ev.get("pid") == inc.pid)
                      or (inc.site is not None and ev.get("site") == inc.site)
                      or (inc.trace_id is not None
                          and ev.get("trace_id") == inc.trace_id))
            if joined and (best is None or inc.last_ts > best.last_ts):
                best = inc
        return best

    def _edge(self, inc: Incident, role: str, src: str,
              ev: Dict[str, Any], ts: float) -> None:
        kind = ev.get("kind", "?")
        edge: Dict[str, Any] = {"role": role, "kind": kind, "src": src,
                                "ts": ts, "summary": _summarize(kind, ev)}
        for k in _JOIN_FIELDS:
            v = ev.get(k)
            if v is not None and isinstance(v, (str, int, float, bool)):
                edge[k] = v
        if len(inc.chain) < _MAX_CHAIN:
            inc.chain.append(edge)
        inc.last_ts = max(inc.last_ts, ts)
        if inc.site is None and isinstance(ev.get("site"), str):
            inc.site = ev["site"]
        if inc.pid is None and isinstance(ev.get("pid"), int):
            inc.pid = ev["pid"]
        if inc.trace_id is None and isinstance(ev.get("trace_id"), str):
            inc.trace_id = ev["trace_id"]
        if (inc.detected_ts is None and src == "joblog"):
            inc.detected_ts = ts
            mttd = inc.mttd
            if mttd is not None:
                self._m_mttd.observe(mttd)

    def _open_incident(self, subject: str, src: str, ev: Dict[str, Any],
                       ts: float) -> Incident:
        kind = ev.get("kind", "?")
        if len(self._open) >= self.max_open:
            oldest = min(self._open.values(), key=lambda i: i.opened_ts)
            self._resolve(oldest, oldest.last_ts, "evicted")
        inc = Incident(
            incident_id=f"{subject}:{kind}:{int(ts * 1000)}",
            subject=subject, trigger_kind=kind, opened_ts=ts, last_ts=ts)
        self._open[inc.incident_id] = inc
        self._edge(inc, "trigger" if kind in TRIGGER_KINDS else "diagnosis",
                   src, ev, ts)
        self._m_opened.labels(kind=kind).inc()
        self._transition(inc)
        return inc

    def _resolve(self, inc: Incident, ts: float, verdict: str) -> None:
        inc.status = "resolved"
        inc.resolved_ts = ts
        inc.verdict = verdict
        self._open.pop(inc.incident_id, None)
        self._resolved.append(inc)
        del self._resolved[:-_MAX_RESOLVED]
        self._m_resolved.labels(verdict=verdict).inc()
        if verdict != "evicted" and inc.mttr is not None:
            self._m_mttr.observe(inc.mttr)
        self._transition(inc)

    def _transition(self, inc: Incident) -> None:
        """Persist + tee one lifecycle transition, both best-effort."""
        d = inc.to_dict()
        if self.persist:
            try:
                from harmony_tpu_torch.jobserver.joblog import record_event

                job = (inc.subject if inc.subject != "cluster"
                       else "__incidents__")
                record_event(job, "incident", **d)
            except Exception:
                pass
        for sink in self._sinks:
            try:
                sink(d)
            except Exception:
                pass

    def correlate(self, now: Optional[float] = None) -> int:
        """One correlation cycle: fold new evidence into incidents,
        then quiesce-resolve the stale. Returns evidence consumed."""
        now = time.time() if now is None else float(now)
        with self._lock:
            evidence = self._harvest()
            for subject, src, ev in evidence:
                kind = ev.get("kind")
                ts = float(ev.get("ts", now))
                if kind in TRIGGER_KINDS or kind in DIAGNOSIS_KINDS:
                    inc = self._find_open(subject, ev, ts)
                    if inc is None:
                        self._open_incident(subject, src, ev, ts)
                    else:
                        role = ("trigger" if kind in TRIGGER_KINDS
                                else "diagnosis")
                        self._edge(inc, role, src, ev, ts)
                elif kind in ACTION_KINDS or kind in RESOLUTION_KINDS:
                    inc = self._find_open(subject, ev, ts)
                    if inc is None:
                        continue  # bare remediation: nothing to join
                    if kind in ACTION_KINDS:
                        self._edge(inc, "action", src, ev, ts)
                        if inc.status == "open":
                            inc.status = "mitigating"
                            inc.mitigating_ts = ts
                            ttm = inc.time_to_mitigate
                            if ttm is not None:
                                self._m_ttm.observe(ttm)
                        self._transition(inc)
                    else:
                        self._edge(inc, "resolution", src, ev, ts)
                        self._resolve(inc, ts, "recovered")
            for inc in list(self._open.values()):
                if now - inc.last_ts > self.window_sec:
                    self._resolve(inc, inc.last_ts + self.window_sec,
                                  "quiesced")
            self._m_open.set(len(self._open))
            return len(evidence)

    # -- HA takeover -----------------------------------------------------

    def adopt(self, replayed: Dict[str, Dict[str, Any]]) -> int:
        """Seed replayed ``kind="incident"`` entries from a predecessor
        leader (newest per incident_id): non-resolved ones stay OPEN on
        this successor so post-takeover evidence still joins them.
        Never re-persists (the entries are already in the log). Returns
        incidents adopted into the open set."""
        adopted = 0
        with self._lock:
            for entry in replayed.values():
                inc = Incident.from_dict(entry)
                if inc is None or inc.incident_id in self._open:
                    continue
                if inc.status == "resolved":
                    if all(r.incident_id != inc.incident_id
                           for r in self._resolved):
                        self._resolved.append(inc)
                        del self._resolved[:-_MAX_RESOLVED]
                    continue
                # survive the takeover gap: the quiescence clock restarts
                # from adoption, not from pre-crash evidence
                inc.last_ts = max(inc.last_ts, time.time())
                self._open[inc.incident_id] = inc
                adopted += 1
            self._adopted += adopted
            self._m_open.set(len(self._open))
        return adopted

    # -- surfaces --------------------------------------------------------

    def open_incidents(self) -> List[Dict[str, Any]]:
        """Open/mitigating incidents, oldest first (crash-dump shape)."""
        with self._lock:
            return [i.to_dict() for i in
                    sorted(self._open.values(), key=lambda i: i.opened_ts)]

    def recent(self, limit: int = 16) -> List[Dict[str, Any]]:
        """Open + recently resolved incidents, oldest first."""
        with self._lock:
            allinc = sorted(self._open.values(),
                            key=lambda i: i.opened_ts) + self._resolved
            allinc.sort(key=lambda i: i.opened_ts)
            return [i.to_dict() for i in allinc[-max(1, int(limit)):]]

    def status(self) -> Dict[str, Any]:
        """STATUS section: counts + the newest incidents."""
        with self._lock:
            open_ = sorted(self._open.values(), key=lambda i: i.opened_ts)
            mitigating = sum(1 for i in open_ if i.status == "mitigating")
            resolved = list(self._resolved)
        mttrs = [i.mttr for i in resolved
                 if i.mttr is not None and i.verdict != "evicted"]
        return {
            "open": len(open_),
            "mitigating": mitigating,
            "resolved": len(resolved),
            "adopted": self._adopted,
            "window_sec": self.window_sec,
            "mttr_mean_sec": (round(sum(mttrs) / len(mttrs), 3)
                              if mttrs else None),
            "incidents": [i.to_dict() for i in
                          (open_ + resolved[-8:])[-8:]],
        }


# -- process-wide engine (flight-recorder peek) ----------------------------

_incidents_lock = threading.Lock()
_incidents: Optional[IncidentEngine] = None


def set_incidents(engine: Optional[IncidentEngine]
                  ) -> Optional[IncidentEngine]:
    """Publish the process's incident engine (the jobserver wires its
    own here) so crash-path consumers can snapshot open incidents."""
    global _incidents
    with _incidents_lock:
        _incidents = engine
    return engine


def peek_incidents() -> Optional[IncidentEngine]:
    """The process engine if one exists — never creates (the flight
    recorder must not instantiate incident state while dying)."""
    with _incidents_lock:
        return _incidents
