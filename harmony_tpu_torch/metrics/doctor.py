"""Automated root-cause doctor over the telemetry history.

A copy of ``harmony_tpu/metrics/doctor.py`` (pure Python; the port keeps its
own): the same rule catalog, thresholds and ``Diagnosis`` dicts. ``obs top``
can show a tenant being slow; the doctor says WHY. It is a rule-based
diagnosis engine over the
:class:`~harmony_tpu_torch.metrics.history.HistoryStore`: each rule is a
named predicate over time series + structured joblog events + fault
counters that emits a :class:`Diagnosis` — verdict, confidence, tenant/pid
attribution, and evidence (series excerpts + the correlated events) —
instead of a wall of gauges.

The twelve rules, in evaluation order: ``input_bound``, ``straggler``,
``mfu_collapse``, ``compile_storm``, ``infra_suspect``, ``comm_bound``,
``dispatch_bound``, ``leader_flap``, ``rebalance_ineffective``,
``control_overload``, ``serving_slo_breach``, ``slo_breach``. Three of them
wait for inputs the port does not produce yet (each rule's comment names
what): ``mfu_collapse`` (``mfu``), ``compile_storm`` (compile seconds and
program-cache misses) and ``rebalance_ineffective`` (``kind="policy"``
events).

Incremental evaluation: :meth:`Doctor.diagnose` takes ``jobs=`` — a
tenant subset to evaluate (the overload ladder's degraded mode,
jobserver/overload.py). Tenant-labeled series and per-job events
outside the subset are invisible to that evaluation; process- and
cluster-scoped rules still see everything.

Diagnoses land as structured ``kind="diagnosis"`` joblog events, ride
STATUS (``diagnoses``) and surface via ``cli obs doctor [--json]``. The
flight-recorder snapshot of diagnoses comes with the flight recorder.

De-duplication contract: ONE diagnosis per (rule, subject) per history
window — a sustained condition re-diagnoses only after the window the
first diagnosis covered has passed, so a scenario fires exactly once
per window instead of once per scrape.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from harmony_tpu_torch.metrics import critpath as _CP
from harmony_tpu_torch.metrics.history import HistoryStore

# -- tunable predicate thresholds (module constants, surfaced in the
# -- rule-catalog doc so operators know what trips each verdict) -----------

#: input_bound: median windowed input-wait fraction at/above this
INPUT_WAIT_FRAC = 0.5
#: straggler: median slowest/median worker step-time ratio at/above this
STRAGGLER_RATIO = 2.0
#: mfu_collapse: late-half mean MFU below this fraction of the early half
MFU_DROP_FRAC = 0.6
#: compile_storm: compile-seconds per wall second at/above this ...
COMPILE_RATE = 0.25
#: ... with a progcache miss rate at/above this (misses/sec)
MISS_RATE = 0.05
#: infra_suspect: fault-fire + retry events within the window on one
#: target at/above this
INFRA_BURST = 5
#: every sustained predicate needs at least this many points
MIN_POINTS = 2


@dataclasses.dataclass
class Diagnosis:
    """One structured verdict. JSON-serializable via :meth:`to_dict`
    (evidence values must already be plain data — series excerpts are
    ``[[ts, value], ...]`` lists, events are their joblog dicts)."""

    rule: str
    verdict: str
    confidence: float
    summary: str
    window: Tuple[float, float]
    job: Optional[str] = None
    pid: Optional[str] = None
    target: Optional[str] = None
    evidence: Dict[str, Any] = dataclasses.field(default_factory=dict)
    ts: float = 0.0

    @property
    def subject(self) -> str:
        """Attribution key for de-duplication: the tenant when the rule
        names one, else the process target, else the cluster."""
        return self.job or self.target or "cluster"

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["window"] = [self.window[0], self.window[1]]
        return d


class DoctorContext:
    """What one evaluation sees: the store, the structured joblog
    events, an optional straggler report, and the diagnoses earlier
    rules in this same evaluation produced (``found`` — the join input
    for ``slo_breach``)."""

    def __init__(self, store: HistoryStore, now: float, window: float,
                 events: Dict[str, List[Dict[str, Any]]],
                 stragglers: Dict[str, Dict[str, Any]]) -> None:
        self.store = store
        self.now = now
        self.window = window
        self.since = now - window
        self.events = events
        self.stragglers = stragglers
        self.found: List[Diagnosis] = []

    def excerpt(self, pts: List[Tuple[float, float]],
                keep: int = 8) -> List[List[float]]:
        """Bounded series excerpt for evidence payloads."""
        return [[round(t, 3), v] for (t, v) in pts[-keep:]]


class DoctorRule:
    def __init__(self, name: str, description: str,
                 fn: Callable[[DoctorContext], List[Diagnosis]]) -> None:
        self.name = name
        self.description = description
        self.fn = fn


#: name -> rule, in declaration order (slo_breach joins the others and
#: must evaluate last — declaration order IS evaluation order)
_RULES: Dict[str, DoctorRule] = {}


def doctor_rule(name: str, description: str):
    """Declare one rule. Names are literal on purpose, so the catalog
    can be read statically; declaration order is evaluation order."""

    def deco(fn):
        _RULES[name] = DoctorRule(name, description, fn)
        return fn

    return deco


def all_rules() -> List[DoctorRule]:
    return list(_RULES.values())


# -- shipped rules ---------------------------------------------------------


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0


@doctor_rule("input_bound",
             "tenant's windowed input-wait fraction sustained at or "
             f"above {INPUT_WAIT_FRAC} — the device sits idle waiting "
             "on the input pipeline")
def _input_bound(ctx: DoctorContext) -> List[Diagnosis]:
    out: List[Diagnosis] = []
    for labels, pts in ctx.store.range("tenant.input_wait_frac",
                                       since=ctx.since):
        vals = [v for _, v in pts]
        if len(vals) < MIN_POINTS:
            continue
        med = _median(vals)
        if med < INPUT_WAIT_FRAC:
            continue
        out.append(Diagnosis(
            rule="input_bound", verdict="input_bound",
            confidence=min(1.0, 0.5 + (med - INPUT_WAIT_FRAC)),
            summary=(f"tenant {labels.get('job')} is input-bound: "
                     f"median input-wait fraction {med:.2f} over "
                     f"{len(vals)} samples"),
            window=(pts[0][0], pts[-1][0]),
            job=labels.get("job"),
            evidence={"series": "tenant.input_wait_frac",
                      "median": round(med, 4),
                      "points": ctx.excerpt(pts)}))
    return out


@doctor_rule("straggler",
             "per-worker step-time divergence: the slowest/median worker "
             f"ratio sustained at or above {STRAGGLER_RATIO}")
def _straggler(ctx: DoctorContext) -> List[Diagnosis]:
    out: List[Diagnosis] = []
    for labels, pts in ctx.store.range("tenant.straggler_ratio",
                                       since=ctx.since):
        vals = [v for _, v in pts]
        if len(vals) < MIN_POINTS:
            continue
        med = _median(vals)
        if med < STRAGGLER_RATIO:
            continue
        job = labels.get("job")
        rep = ctx.stragglers.get(job or "", {})
        out.append(Diagnosis(
            rule="straggler", verdict="straggler",
            confidence=min(1.0, med / (2.0 * STRAGGLER_RATIO) + 0.5),
            summary=(f"tenant {job} has a straggler: slowest/median "
                     f"worker step-time ratio {med:.2f}"
                     + (f" (slowest: {rep['slowest']})"
                        if rep.get("slowest") else "")),
            window=(pts[0][0], pts[-1][0]),
            job=job,
            evidence={"series": "tenant.straggler_ratio",
                      "median": round(med, 3),
                      "slowest_worker": rep.get("slowest"),
                      "worker_means": rep.get("workers"),
                      "points": ctx.excerpt(pts)}))
    return out


@doctor_rule("mfu_collapse",
             "tenant MFU dropped below "
             f"{MFU_DROP_FRAC} of its earlier level, correlated with a "
             "table layout change (layout_version bump) in the window")
def _mfu_collapse(ctx: DoctorContext) -> List[Diagnosis]:
    # waits for ``mfu`` (a FLOP count per step): the port's ledger gives
    # None, so no tenant.mfu series exists and this rule stays silent
    layout_bumps = sum(
        inc for _labels, inc in ctx.store.increase(
            "harmony_table_layout_changes_total", window=ctx.window,
            until=ctx.now))
    if layout_bumps <= 0:
        return []
    out: List[Diagnosis] = []
    for labels, pts in ctx.store.range("tenant.mfu", since=ctx.since):
        if len(pts) < 2 * MIN_POINTS:
            continue
        half = len(pts) // 2
        early = [v for _, v in pts[:half]]
        late = [v for _, v in pts[half:]]
        e_mean = sum(early) / len(early)
        l_mean = sum(late) / len(late)
        if e_mean <= 0 or l_mean >= e_mean * MFU_DROP_FRAC:
            continue
        out.append(Diagnosis(
            rule="mfu_collapse", verdict="mfu_collapse",
            confidence=min(1.0, 1.0 - l_mean / e_mean),
            summary=(f"tenant {labels.get('job')} MFU collapsed "
                     f"{e_mean:.3f} -> {l_mean:.3f} after "
                     f"{layout_bumps:.0f} table layout change(s)"),
            window=(pts[0][0], pts[-1][0]),
            job=labels.get("job"),
            evidence={"series": "tenant.mfu",
                      "early_mean": round(e_mean, 4),
                      "late_mean": round(l_mean, 4),
                      "layout_changes": layout_bumps,
                      "points": ctx.excerpt(pts)}))
    return out


@doctor_rule("compile_storm",
             f"compile-seconds rate at or above {COMPILE_RATE} s/s on one "
             "process, correlated with a progcache miss rate at or above "
             f"{MISS_RATE}/s — programs are being rebuilt instead of "
             "cache-hit")
def _compile_storm(ctx: DoctorContext) -> List[Diagnosis]:
    # waits for harmony_compile_seconds / harmony_progcache_events_total:
    # nothing in the port compiles programs at run time (its kernels are
    # built once, ahead of the jobs), so neither family is ever exposed
    compile_by_target: Dict[str, float] = {}
    for labels, r in ctx.store.rate("harmony_compile_seconds_sum",
                                    window=ctx.window, until=ctx.now):
        if r is not None:
            t = labels.get("target", "?")
            compile_by_target[t] = compile_by_target.get(t, 0.0) + r
    miss_by_target: Dict[str, float] = {}
    for labels, r in ctx.store.rate("harmony_progcache_events_total",
                                    labels={"result": "miss"},
                                    window=ctx.window, until=ctx.now):
        if r is not None:
            t = labels.get("target", "?")
            miss_by_target[t] = miss_by_target.get(t, 0.0) + r
    out: List[Diagnosis] = []
    for target, crate in sorted(compile_by_target.items()):
        mrate = miss_by_target.get(target, 0.0)
        if crate < COMPILE_RATE or mrate < MISS_RATE:
            continue
        out.append(Diagnosis(
            rule="compile_storm", verdict="compile_storm",
            confidence=min(1.0, crate / (2.0 * COMPILE_RATE) + 0.25),
            summary=(f"compile storm on {target}: {crate:.2f} "
                     f"compile-seconds/s with {mrate:.2f} progcache "
                     "misses/s"),
            window=(ctx.since, ctx.now),
            target=target, pid=ctx.store.target_pid(target),
            evidence={"compile_seconds_rate": round(crate, 4),
                      "progcache_miss_rate": round(mrate, 4)}))
    return out


#: retry ops the doctor's OWN sensor layer generates — a dead scrape
#: target already reports as a gap; counting its bounded retries as an
#: infra burst would make the doctor diagnose itself, blaming the
#: leader once per window forever
_SELF_OPS = ("obs.scrape",)


@doctor_rule("infra_suspect",
             "fault-fire + retry counter burst concentrated on one "
             f"process ({INFRA_BURST}+ events in the window) — transient "
             "infrastructure trouble, not a job bug (the scraper's own "
             "obs.scrape retries are excluded: a dead target's gap is "
             "already the signal)")
def _infra_suspect(ctx: DoctorContext) -> List[Diagnosis]:
    burst: Dict[str, Dict[str, float]] = {}
    for name in ("harmony_retry_events_total", "harmony_fault_fires_total"):
        for labels, inc in ctx.store.increase(name, window=ctx.window,
                                              until=ctx.now):
            if inc <= 0:
                continue
            if labels.get("op") in _SELF_OPS:
                continue
            t = labels.get("target", "?")
            key = ":".join(filter(None, (
                labels.get("op"), labels.get("kind"),
                labels.get("site"), labels.get("action")))) or name
            burst.setdefault(t, {})[key] = (
                burst.get(t, {}).get(key, 0.0) + inc)
    out: List[Diagnosis] = []
    for target, ops in sorted(burst.items()):
        total = sum(ops.values())
        if total < INFRA_BURST:
            continue
        out.append(Diagnosis(
            rule="infra_suspect", verdict="infra_suspect",
            confidence=min(1.0, total / (4.0 * INFRA_BURST) + 0.5),
            summary=(f"infra suspicion on {target}: {total:.0f} "
                     "fault/retry events in the window "
                     f"({', '.join(sorted(ops))})"),
            window=(ctx.since, ctx.now),
            target=target, pid=ctx.store.target_pid(target),
            evidence={"events_in_window": total,
                      "by_op": {k: round(v, 1)
                                for k, v in sorted(ops.items())}}))
    return out


def _phase_median(ctx: "DoctorContext", series: str,
                  job: Optional[str]) -> Optional[float]:
    """Median of one tenant.phase.* series for ``job`` over the window,
    or None below MIN_POINTS — phase verdicts need a SUSTAINED budget,
    not one noisy window."""
    want = {"job": job} if job else None
    for _labels, pts in ctx.store.range(series, labels=want,
                                        since=ctx.since):
        vals = [v for _, v in pts]
        if len(vals) >= MIN_POINTS:
            return _median(vals)
    return None


def _steady_points(ctx: "DoctorContext", series: str, labels: Dict[str, str],
                   pts: List[Tuple[float, float]]
                   ) -> List[Tuple[float, float]]:
    """Windowed points of one phase series MINUS the one-time
    set-up-bearing first sample: a tenant's first epoch pays one-time
    costs (first launches, allocations, the reference's compile) inside
    its pull/push wall, so a series whose
    first-EVER sample still sits inside the window would let capex
    masquerade as sustained traffic. Only that first-ever point is
    dropped — a long-lived tenant whose birth sample already aged out of
    the retained history (or out of the window) is untouched. The
    critpath CLASSIFIER keeps ingesting the raw sample: classification
    labels one window honestly; this rule issues a verdict."""
    job = labels.get("job")
    want = {"job": job} if job else None
    for _l, full in ctx.store.range(series, labels=want, since=0.0):
        if full and pts and full[0][0] == pts[0][0]:
            return pts[1:]
        break
    return pts


def _steady_phase_median(ctx: "DoctorContext", series: str,
                         job: Optional[str]) -> Optional[float]:
    """:func:`_phase_median` over the compile-excluded steady points
    (see _steady_points); the MIN_POINTS floor applies AFTER the
    exclusion — one steady sample is still not a sustained verdict."""
    want = {"job": job} if job else None
    for labels, pts in ctx.store.range(series, labels=want,
                                       since=ctx.since):
        vals = [v for _, v in _steady_points(ctx, series, labels, pts)]
        if len(vals) >= MIN_POINTS:
            return _median(vals)
    return None


@doctor_rule("comm_bound",
             "tenant's windowed pull_comm + push_comm wall fraction "
             f"sustained at or above {_CP.COMM_BOUND_FRAC} (the "
             "step-phase budget, metrics/phases.py) — model traffic, "
             "not math, owns the step; packing this tenant tighter "
             "makes it worse. The one-time compile-bearing first sample "
             "is excluded from the fractions (the _UnfusedStep pattern)")
def _comm_bound(ctx: DoctorContext) -> List[Diagnosis]:
    out: List[Diagnosis] = []
    for labels, raw in ctx.store.range("tenant.phase.pull_comm",
                                       since=ctx.since):
        pts = _steady_points(ctx, "tenant.phase.pull_comm", labels, raw)
        vals = [v for _, v in pts]
        if len(vals) < MIN_POINTS:
            continue
        job = labels.get("job")
        pull_med = _median(vals)
        push_med = _steady_phase_median(
            ctx, "tenant.phase.push_comm", job) or 0.0
        med = pull_med + push_med
        if med < _CP.COMM_BOUND_FRAC:
            continue
        out.append(Diagnosis(
            rule="comm_bound", verdict="comm_bound",
            confidence=min(1.0, 0.5 + (med - _CP.COMM_BOUND_FRAC)),
            summary=(f"tenant {job} is comm-bound: pull+push own "
                     f"{med:.0%} of its step wall (pull {pull_med:.2f}, "
                     f"push {push_med:.2f}) over {len(vals)} samples"),
            window=(pts[0][0], pts[-1][0]),
            job=job,
            evidence={"series": "tenant.phase.pull_comm",
                      "pull_median": round(pull_med, 4),
                      "push_median": round(push_med, 4),
                      "comm_fraction": round(med, 4),
                      "points": ctx.excerpt(pts)}))
    return out


@doctor_rule("dispatch_bound",
             "tenant's windowed host_dispatch wall fraction sustained "
             f"at or above {_CP.DISPATCH_BOUND_FRAC} (the step-phase "
             "budget) — host placement between batch-ready and device "
             "dispatch gates the step; more chips would sit as idle as "
             "the current ones")
def _dispatch_bound(ctx: DoctorContext) -> List[Diagnosis]:
    out: List[Diagnosis] = []
    for labels, pts in ctx.store.range("tenant.phase.host_dispatch",
                                       since=ctx.since):
        vals = [v for _, v in pts]
        if len(vals) < MIN_POINTS:
            continue
        med = _median(vals)
        if med < _CP.DISPATCH_BOUND_FRAC:
            continue
        job = labels.get("job")
        out.append(Diagnosis(
            rule="dispatch_bound", verdict="dispatch_bound",
            confidence=min(1.0, 0.5 + (med - _CP.DISPATCH_BOUND_FRAC)),
            summary=(f"tenant {job} is dispatch-bound: host dispatch "
                     f"owns {med:.0%} of its step wall over "
                     f"{len(vals)} samples"),
            window=(pts[0][0], pts[-1][0]),
            job=job,
            evidence={"series": "tenant.phase.host_dispatch",
                      "median": round(med, 4),
                      "points": ctx.excerpt(pts)}))
    return out


#: leader_flap: this many leader takeovers inside one window is churn,
#: not recovery — every takeover replays the log and re-arms in-flight
#: submissions, so a flapping lease multiplies recovery work
LEADER_FLAP_COUNT = 2


@doctor_rule("leader_flap",
             "control-plane HA churn: at least "
             f"{LEADER_FLAP_COUNT} kind=\"leader_takeover\" joblog "
             "events in one window — the lease is flapping between "
             "replicas (store latency, a too-short HARMONY_HA_LEASE_S, "
             "or a crash-looping leader) instead of settling")
def _leader_flap(ctx: DoctorContext) -> List[Diagnosis]:
    takeovers = [
        e for e in ctx.events.get("__ha__", [])
        if e.get("kind") == "leader_takeover"
        and float(e.get("ts", 0.0)) >= ctx.since
    ]
    if len(takeovers) < LEADER_FLAP_COUNT:
        return []
    leaders = [str(e.get("new_leader")) for e in takeovers]
    return [Diagnosis(
        rule="leader_flap", verdict="leader_flap",
        confidence=min(1.0, len(takeovers) / (2.0 * LEADER_FLAP_COUNT)
                       + 0.5),
        summary=(f"control plane flapped {len(takeovers)} times in the "
                 f"window (leaders: {' -> '.join(leaders)})"),
        window=(ctx.since, ctx.now),
        target="control-plane",
        evidence={"takeovers": [dict(e) for e in takeovers[-4:]],
                  "count": len(takeovers)})]


#: rebalance_ineffective: the post-action median must clear the
#: pre-action median by this factor (or +0.05 absolute) to count as
#: improvement — flat noise is not a win
POLICY_GAIN_FACTOR = 1.05


def _policy_judge_age() -> float:
    """How old a policy action must be before its effect is judged: two
    policy evaluation windows (jobserver/policy.py's period knob).
    Guarded lazy import — metrics must not hard-depend on the
    jobserver."""
    try:
        from harmony_tpu_torch.jobserver.policy import policy_period

        return 2.0 * policy_period()
    except Exception:
        return 20.0


@doctor_rule("rebalance_ineffective",
             "an executed GROW or ASYNC policy action (kind=\"policy\" "
             "joblog event, jobserver/policy.py) whose target tenant "
             "shows no MFU or SLO-attainment improvement within two "
             "policy windows of the fence — the engine backs the tenant "
             "off on this diagnosis instead of churning it (shrink/pack/"
             "preempt victims degrade BY DESIGN and are never judged)")
def _rebalance_ineffective(ctx: DoctorContext) -> List[Diagnosis]:
    # waits for kind="policy" events: the port has no policy engine yet,
    # so no action is ever judged
    judge_age = _policy_judge_age()
    out: List[Diagnosis] = []
    for job, events in ctx.events.items():
        # only actions meant to HELP their target are judged by the
        # target's own series — a shrink/pack/preempt victim's numbers
        # drop on purpose (the claimant got the capacity). `async` is
        # judged exactly like grow: it promised the TARGET a speedup
        # (overlapped comm), so flat series after the fence mean the
        # lever did not pay and the engine should back off.
        acts = [e for e in events
                if e.get("kind") == "policy" and e.get("executed")
                and e.get("action") in ("grow", "async")]
        if not acts:
            continue
        ev = acts[-1]
        ts = float(ev.get("ts", 0.0))
        age = ctx.now - ts
        if age < judge_age or age > ctx.window:
            # too fresh to judge, or ancient history — the upper bound
            # is ONE doctor window so the once-per-(rule,subject)
            # dedup horizon fully covers it: the same action can never
            # be re-diagnosed (and backed off) in a later window
            continue
        judged = False
        improved = False
        detail: Dict[str, Any] = {}
        for series in ("tenant.slo_attainment", "tenant.mfu"):
            for _labels, pts in ctx.store.range(
                    series, labels={"job": job}, since=ts - ctx.window):
                before = [v for t, v in pts if t < ts]
                after = [v for t, v in pts if t >= ts]
                if not before or not after:
                    continue
                judged = True
                b, a = _median(before), _median(after)
                detail[series] = {"before_median": round(b, 4),
                                  "after_median": round(a, 4)}
                if a > b * POLICY_GAIN_FACTOR or a > b + 0.05:
                    improved = True
        if not judged or improved:
            continue
        out.append(Diagnosis(
            rule="rebalance_ineffective",
            verdict="rebalance_ineffective",
            confidence=0.7,
            summary=(f"policy {ev.get('action')} on tenant {job} "
                     "produced no MFU/SLO-attainment improvement within "
                     "two policy windows — backing off"),
            window=(ts, ctx.now),
            job=job,
            evidence={"policy_event": dict(ev), "series": detail}))
    return out


#: control_overload: ladder transitions inside one window at/above this
#: (one step-down is an event; repeated stepping is sustained pressure)
OVERLOAD_EVENT_COUNT = 1


@doctor_rule("control_overload",
             "the control plane shed fidelity: kind=\"overload\" joblog "
             "events under __control__ (jobserver/overload.py) show the "
             "degradation ladder stepped down in the window — command-"
             "queue lag or scrape/diagnose/plan cycle overrun; scraping "
             "rotates subsets and SUBMIT may answer BUSY until it "
             "recovers")
def _control_overload(ctx: DoctorContext) -> List[Diagnosis]:
    evs = [e for e in ctx.events.get("__control__", [])
           if e.get("kind") == "overload"
           and float(e.get("ts", 0.0)) >= ctx.since]
    downs = [e for e in evs if e.get("direction") == "down"]
    if len(downs) < OVERLOAD_EVENT_COUNT:
        return []
    latest = evs[-1]
    deepest = max(downs, key=lambda e: int(e.get("level", 0)))
    recovered = (latest.get("direction") == "up"
                 and int(latest.get("level", 0)) == 0)
    return [Diagnosis(
        rule="control_overload", verdict="control_overload",
        confidence=min(1.0, 0.6 + 0.2 * len(downs)),
        summary=("control plane overloaded: ladder stepped down to "
                 f"{deepest.get('ladder')} ({deepest.get('reason')})"
                 + ("; since recovered" if recovered
                    else f"; currently {latest.get('ladder')}")),
        window=(ctx.since, ctx.now),
        target="control-plane",
        evidence={"transitions": [dict(e) for e in evs[-6:]],
                  "step_downs": len(downs),
                  "sheds": dict(latest.get("sheds") or {}),
                  "recovered": recovered})]


#: serving_slo_breach fires only when the windowed p99 sits this far
#: over the tenant's target — a single tail sample is load, not a breach
SERVING_BREACH_RATIO = 1.0


@doctor_rule("serving_slo_breach",
             "a serving tenant's windowed p99 lookup latency "
             "(tenant.serving.p99_ms, the ledger fold of the serving "
             "plane's latency summary) sits over its registered p99 SLO "
             "(tenant.serving.slo_p99_ms) across the window — "
             "attributed to the serving tenant with both evidence "
             "series excerpted")
def _serving_slo_breach(ctx: DoctorContext) -> List[Diagnosis]:
    out: List[Diagnosis] = []
    targets = {labels.get("job"): pts for labels, pts in
               ctx.store.range("tenant.serving.slo_p99_ms",
                               since=ctx.since)}
    for labels, pts in ctx.store.range("tenant.serving.p99_ms",
                                       since=ctx.since):
        if len(pts) < MIN_POINTS:
            continue
        job = labels.get("job")
        tpts = targets.get(job)
        if not tpts:
            continue  # no registered SLO: latency alone is not a breach
        target = float(tpts[-1][1])
        p99 = _median([v for _ts, v in pts])
        if target <= 0 or p99 <= target * SERVING_BREACH_RATIO:
            continue
        over = [v for _ts, v in pts if v > target]
        out.append(Diagnosis(
            rule="serving_slo_breach", verdict="serving_slo_breach",
            confidence=min(1.0, 0.5 + 0.5 * (len(over) / len(pts))),
            summary=(f"serving tenant {job} breaching its p99 SLO: "
                     f"windowed p99 {p99:.1f}ms vs target {target:.1f}ms "
                     f"({len(over)}/{len(pts)} samples over)"),
            window=(ctx.since, ctx.now),
            job=str(job) if job is not None else None,
            target="serving",
            evidence={"p99_ms": ctx.excerpt(pts),
                      "slo_p99_ms": ctx.excerpt(tpts),
                      "samples_over": len(over),
                      "samples": len(pts)}))
    return out


@doctor_rule("slo_breach",
             "a structured kind=\"slo\" joblog breach event joined to "
             "whichever rule fired in its window — the breach gets a "
             "cause, not just a timestamp")
def _slo_breach(ctx: DoctorContext) -> List[Diagnosis]:
    out: List[Diagnosis] = []
    for job, events in ctx.events.items():
        breaches = [e for e in events
                    if e.get("kind") == "slo"
                    and float(e.get("ts", 0.0)) >= ctx.since]
        if not breaches:
            continue
        ev = breaches[-1]
        cause = next((d for d in ctx.found if d.job == job), None)
        if cause is None:
            # process-scoped causes (compile storm, infra burst) have no
            # tenant attribution; a breach still inherits them as the
            # best available explanation
            cause = next((d for d in ctx.found if d.job is None), None)
        out.append(Diagnosis(
            rule="slo_breach", verdict="slo_breach",
            confidence=(0.9 if cause is not None else 0.4),
            summary=(f"tenant {job} breached its SLO "
                     f"(attainment {ev.get('attainment')}); cause: "
                     + (cause.verdict if cause is not None
                        else "unattributed")),
            window=(ctx.since, ctx.now),
            job=job,
            evidence={"slo_event": dict(ev),
                      "cause_rule": (cause.rule
                                     if cause is not None else None),
                      "cause_summary": (cause.summary
                                        if cause is not None else None)}))
    return out


# -- the engine ------------------------------------------------------------


class _ScopedStore:
    """Read-only tenant-scoped view of a :class:`HistoryStore` for
    incremental (degraded-mode) evaluation: ``range`` results whose
    labels name a tenant OUTSIDE the subset are dropped; unlabeled
    (process/cluster) series pass through, as do the non-series
    queries (``increase``/``rate``/``target_pid``) — they are already
    bounded per call."""

    def __init__(self, store: HistoryStore, jobs: "set[str]") -> None:
        self._store = store
        self._jobs = jobs

    def range(self, *args: Any, **kwargs: Any):
        return [(labels, pts)
                for labels, pts in self._store.range(*args, **kwargs)
                if labels.get("job") is None
                or str(labels.get("job")) in self._jobs]

    def __getattr__(self, name: str) -> Any:
        return getattr(self._store, name)


class Doctor:
    """Evaluates every shipped rule over a store; see module docstring.

    ``events_fn`` returns the structured joblog map (default: the
    process joblog); ``stragglers_fn`` the per-job straggler report;
    ``sinks`` observe every newly emitted diagnosis."""

    def __init__(self, store: HistoryStore,
                 window: Optional[float] = None,
                 events_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 stragglers_fn: Optional[Callable[[], Dict[str, Any]]]
                 = None,
                 sinks: Tuple[Callable[[Diagnosis], None], ...] = (),
                 ) -> None:
        self.store = store
        self.window = float(window if window is not None
                            else store.window_sec)
        self._events_fn = events_fn or _default_events
        self._stragglers_fn = stragglers_fn
        self._sinks = tuple(sinks)
        self._lock = threading.Lock()
        self._recent: "deque[Dict[str, Any]]" = deque(maxlen=128)
        #: (rule, subject) -> last emit ts: the once-per-window contract
        self._seen: Dict[Tuple[str, str], float] = {}

    def diagnose(self, now: Optional[float] = None,
                 jobs: Optional["set[str]"] = None) -> List[Diagnosis]:
        """One full rule evaluation; returns the NEWLY emitted
        diagnoses (deduped against the window). Safe to call at scrape
        cadence — rules are pure reads over bounded rings.

        ``jobs`` restricts the evaluation to a tenant subset (overload
        degraded mode — jobserver/overload.py rotates the subset per
        cycle so coverage stays complete, just slower): tenant series
        and per-job events outside it are invisible; system subjects
        (``__ha__``, ``__control__``) always evaluate."""
        now = time.time() if now is None else float(now)
        try:
            events = self._events_fn() or {}
        except Exception:
            events = {}
        stragglers: Dict[str, Any] = {}
        if self._stragglers_fn is not None:
            try:
                stragglers = self._stragglers_fn() or {}
            except Exception:
                stragglers = {}
        store = self.store
        if jobs is not None:
            scope = {str(j) for j in jobs}
            store = _ScopedStore(self.store, scope)
            events = {k: v for k, v in events.items()
                      if k in scope or k.startswith("__")}
            stragglers = {k: v for k, v in stragglers.items()
                          if k in scope}
        ctx = DoctorContext(store, now, self.window, events,
                            stragglers)
        for rule in all_rules():
            try:
                found = rule.fn(ctx) or []
            except Exception:
                continue  # one broken rule must not silence the rest
            ctx.found.extend(found)
        fresh: List[Diagnosis] = []
        with self._lock:
            # prune dedup entries the window already made inert — a
            # long-lived server diagnosing churning tenants must not
            # leak one dict entry per (rule, job-id) ever seen
            for key in [k for k, last in self._seen.items()
                        if now - last >= self.window]:
                del self._seen[key]
            for d in ctx.found:
                d.ts = now
                key = (d.rule, d.subject)
                last = self._seen.get(key)
                if last is not None and now - last < self.window:
                    continue  # once per (rule, subject) per window
                self._seen[key] = now
                fresh.append(d)
                self._recent.append(d.to_dict())
        for d in fresh:
            _record_diagnosis_event(d)
            for sink in self._sinks:
                try:
                    sink(d)
                except Exception:
                    pass  # a sink must not fail the diagnosis path
        return fresh

    def recent(self, limit: int = 32) -> List[Dict[str, Any]]:
        """Newest emitted diagnoses (dicts, newest last) — the STATUS /
        ``obs doctor`` surface."""
        with self._lock:
            return list(self._recent)[-limit:]

    def clear(self) -> None:
        with self._lock:
            self._recent.clear()
            self._seen.clear()


def _default_events() -> Dict[str, Any]:
    from harmony_tpu_torch.jobserver.joblog import job_events

    return job_events()


def _record_diagnosis_event(d: Diagnosis) -> None:
    """Structured ``kind="diagnosis"`` joblog event, riding STATUS
    ``job_events`` (and the incident engine's evidence). Guarded lazy
    import: metrics must not hard-depend on the jobserver."""
    try:
        from harmony_tpu_torch.jobserver.joblog import record_event

        record_event(d.subject, "diagnosis", rule=d.rule,
                     verdict=d.verdict,
                     confidence=round(d.confidence, 3),
                     job=d.job, pid=d.pid, target=d.target,
                     summary=d.summary, evidence=d.evidence)
    except Exception:
        pass


# -- process-wide doctor (flight-recorder peek) ----------------------------

_doctor_lock = threading.Lock()
_doctor: Optional[Doctor] = None


def set_doctor(doctor: Optional[Doctor]) -> Optional[Doctor]:
    """Publish the process's doctor (the jobserver wires its own here)
    so crash-path consumers can snapshot diagnoses."""
    global _doctor
    with _doctor_lock:
        _doctor = doctor
    return doctor


def peek_doctor() -> Optional[Doctor]:
    """The process doctor if one exists — never creates (the flight
    recorder must not instantiate diagnosis state while dying)."""
    with _doctor_lock:
        return _doctor
