"""Per-tenant step-phase time budget — where inside the step the time goes.

Counterpart of ``harmony_tpu/metrics/phases.py``, a copy of its pure-Python
split and store. The ledger (metrics/accounting.py) can say *that* a tenant
is slow and the straggler report *who* lags; this store says *where inside
the step* the wall time went, the breakdown an autoscaler needs to choose
between *scale out*, *pack tighter* and *leave alone*.

Every worker attributes its wall time per epoch to a CLOSED phase set:

* ``input_wait``    — prefetch consumer-stall seconds (measured);
* ``host_dispatch`` — host seconds between batch-ready and the step's
  enqueue (placement and staging on the training thread, measured);
* ``pull_comm`` / ``compute`` / ``push_comm`` — the device-work split:
  the unfused step uses its REAL per-phase measurements; the fused step
  applies the comm probe's absolute pull/push seconds to the measured step
  wall, refined by FLOP seconds when a FLOP count and the card's peak are
  known (the probe can overestimate comm on tiny tables; compute never
  drops below its FLOP floor);
* ``barrier_wait``  — the gap between a worker's epoch wall and its
  slowest sibling's at the same epoch index (the straggler report says
  *who*, this says what the fast workers paid waiting);
* ``residual``      — everything unattributed (admission waits, the drain's
  host share, epoch bookkeeping), kept as an EXPLICIT series, never
  silently absorbed into a real phase.

**Budget invariant**: per window, ``sum(phases) + residual == wall``
within tolerance — feeds are sanitized (no negative phase, and a feed
whose measured phases exceed its wall — an elastic shrink truncating
the epoch mid-window — is scaled down, never allowed to imply >100%).

Surfaces: ``harmony_phase_budget_seconds{job,attempt,worker,phase}``
callback gauges, STATUS ``phase_budget`` and ``obs critpath``.
:mod:`harmony_tpu_torch.metrics.critpath` classifies and names the epoch
critical path from this store.

Knob: ``HARMONY_PHASE_WINDOW`` (seconds of budget window, default =
``HARMONY_LEDGER_WINDOW`` — the two vectors describe the same tenant
and should cover the same span).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

ENV_PHASE_WINDOW = "HARMONY_PHASE_WINDOW"

#: the closed phase taxonomy, in waterfall order (the module docstring
#: documents each); ``residual`` rides beside them as the explicit
#: unattributed series
PHASES = ("input_wait", "host_dispatch", "pull_comm", "compute",
          "push_comm", "barrier_wait")
RESIDUAL = "residual"

#: feed samples kept per tenant — one per worker-epoch; covers days of
#: a long job while bounding a pathological feeder (accounting's shape)
_MAX_SAMPLES = 4096


def phase_window_seconds() -> float:
    """The budget window (seconds): ``HARMONY_PHASE_WINDOW``, defaulting
    to the ledger window so the cost vector and the phase vector of one
    tenant describe the same span."""
    raw = os.environ.get(ENV_PHASE_WINDOW, "")
    if raw:
        try:
            return max(1.0, float(raw))
        except ValueError:
            pass
    from harmony_tpu_torch.metrics.accounting import window_seconds

    return window_seconds()


def split_device_phases(work_sec: float, steps: int, *,
                        dispatch_sec: float = 0.0,
                        probe_split: Optional[Tuple[float, float]] = None,
                        measured: Optional[Tuple[float, float, float]]
                        = None,
                        flops_per_step: Optional[float] = None,
                        peak_flops: Optional[float] = None,
                        devices: int = 1) -> Dict[str, float]:
    """Split one epoch's measured device-work seconds (``work_sec`` =
    smeared per-batch time × steps, which INCLUDES host placement) into
    ``pull_comm`` / ``compute`` / ``push_comm``.

    * ``measured`` (unfused mode): the :class:`_UnfusedStep` per-step
      (pull, comp, push) means — real measurements. They are scaled
      DOWN if they exceed the available work (an elastic shrink or a
      rebuild mid-window truncates the wall they were measured against)
      and any leftover work stays UNattributed (it lands in the epoch
      residual — drain/sync overhead is not compute).
    * ``probe_split`` (fused mode): the comm probe's absolute per-step
      (pull, push) device seconds applied to the measured wall;
      ``compute`` is the remainder (PR 6's documented convention — with
      the probe off the whole work charges to compute, the conservative
      default). When ``flops_per_step`` AND ``peak_flops`` are known,
      the remainder is refined: compute never drops below the FLOP
      floor ``flops × steps / (peak × devices)`` — on tiny tables the
      probe's sub-millisecond measurements can rival the step wall and
      would otherwise starve compute to zero.

    Returns non-negative seconds with
    ``pull + comp + push <= max(work - dispatch, 0)``.
    """
    avail = max(float(work_sec) - max(float(dispatch_sec), 0.0), 0.0)
    steps = max(int(steps), 0)
    if avail <= 0.0 or steps == 0:
        return {"pull_comm": 0.0, "compute": 0.0, "push_comm": 0.0}
    if measured is not None:
        pull0 = max(float(measured[0]), 0.0) * steps
        comp0 = max(float(measured[1]), 0.0) * steps
        push0 = max(float(measured[2]), 0.0) * steps
        total0 = pull0 + comp0 + push0
        scale = min(1.0, avail / total0) if total0 > 0 else 0.0
        return {"pull_comm": pull0 * scale, "compute": comp0 * scale,
                "push_comm": push0 * scale}
    pull0 = push0 = 0.0
    if probe_split is not None:
        pull0 = max(float(probe_split[0]), 0.0) * steps
        push0 = max(float(probe_split[1]), 0.0) * steps
    comp_floor = 0.0
    if flops_per_step is not None and peak_flops:
        comp_floor = min(
            float(flops_per_step) * steps / (float(peak_flops)
                                             * max(int(devices), 1)),
            avail)
    comm0 = pull0 + push0
    comm = min(comm0, avail - comp_floor) if comm0 > 0 else 0.0
    comm = max(comm, 0.0)
    scale = comm / comm0 if comm0 > 0 else 0.0
    return {"pull_comm": pull0 * scale,
            # fused mode has no way to separate in-work overhead from
            # compute (one enqueued step) — the remainder IS compute by
            # the documented convention
            "compute": avail - comm,
            "push_comm": push0 * scale}


class _TenantPhases:
    """Mutable per-job phase state; all mutation under the store lock."""

    __slots__ = ("job", "attempt", "samples")

    def __init__(self, job: str) -> None:
        self.job = job
        self.attempt = job
        #: (ts, attempt, worker, epoch_idx, wall_sec, {phase: sec}) —
        #: the attempt rides each sample so the barrier join never
        #: mixes epoch walls across an elastic restart (attempt 2
        #: re-runs the same epoch indices; see snapshot())
        self.samples: deque = deque(maxlen=_MAX_SAMPLES)


class PhaseBudgetStore:
    """Process-wide per-tenant phase-budget store; see module docstring.

    Fed once per worker-epoch (never per batch); ``snapshot()`` joins
    sibling workers' walls at the same epoch index into ``barrier_wait``
    and emits per-tenant and per-worker budgets whose phases + residual
    sum to the wall exactly."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantPhases] = {}
        #: bumped on every mutation — the memoized-snapshot validity key
        self._version = 0
        #: window -> (version, expires, rows): see snapshot_memoized
        self._memo: Dict[float, Tuple[int, float, Dict[str, Any]]] = {}

    # -- feeds (worker side) ---------------------------------------------

    def observe_epoch(self, job: str, attempt: str, worker: str,
                      epoch_idx: int, wall_sec: float,
                      phases: Dict[str, float]) -> None:
        """One worker-epoch's budget feed. Sanitized at the door: every
        phase is clamped non-negative, and a feed whose measured phases
        exceed its wall (elastic shrink truncating the epoch mid-window,
        timer overlap) is scaled to fit — the invariant "phases sum to
        <= 100% of wall" holds at ingest, not just at render."""
        wall = max(float(wall_sec), 0.0)
        clean = {str(k): max(float(v), 0.0)
                 for k, v in (phases or {}).items()}
        total = sum(clean.values())
        if total > wall and total > 0:
            scale = wall / total
            clean = {k: v * scale for k, v in clean.items()}
        now = time.monotonic()
        with self._lock:
            t = self._tenants.get(job)
            if t is None:
                t = self._tenants[job] = _TenantPhases(job)
            if attempt:
                t.attempt = attempt
            t.samples.append((now, str(attempt or job), str(worker),
                              int(epoch_idx), wall, clean))
            self._version += 1

    # -- queries ---------------------------------------------------------

    def snapshot(self, window_sec: Optional[float] = None
                 ) -> Dict[str, Dict[str, Any]]:
        """Per-tenant phase budgets over the window. Each row:

        ``{job, attempt, window_sec, wall_sec, epochs, phases,
        fractions, per_worker, epoch_walls}`` — ``phases`` maps every
        taxonomy phase plus ``residual`` to windowed seconds;
        ``fractions`` the same over the tenant's wall (sums to 1.0 when
        wall > 0); ``per_worker`` one budget per worker;
        ``epoch_walls`` maps epoch index -> {worker: wall_sec} (the
        critical-path analyzer's raw material). ``barrier_wait`` for a
        worker-epoch is ``max(sibling walls) - own wall`` — the
        chief-observed gap between that worker's last step and the
        epoch drain; single-worker epochs pay none. The join is
        partitioned by the LIVE attempt: an elastic restart re-runs the
        same epoch indices, and mixing attempt 1's epoch-0 wall into
        attempt 2's epoch-0 gate would charge phantom barrier seconds
        nobody paid (the ledger keys by ``job@attempt`` for the same
        reason) — stale-attempt samples are simply dropped."""
        w = (window_sec if window_sec is not None
             else phase_window_seconds())
        cutoff = time.monotonic() - w
        with self._lock:
            tenants = [(t.job, t.attempt, list(t.samples))
                       for t in self._tenants.values()]
        rows: Dict[str, Dict[str, Any]] = {}
        for job, attempt, samples in tenants:
            live = [(ts, wk, ep, wall, ph)
                    for (ts, att, wk, ep, wall, ph) in samples
                    if ts >= cutoff and att == attempt]
            if not live:
                continue
            # sibling walls per epoch index: the barrier join's input
            epoch_walls: Dict[int, Dict[str, float]] = {}
            for _ts, wk, ep, wall, _ph in live:
                epoch_walls.setdefault(ep, {})[wk] = max(
                    epoch_walls.get(ep, {}).get(wk, 0.0), wall)
            per_worker: Dict[str, Dict[str, Any]] = {}
            for _ts, wk, ep, wall, ph in live:
                gate = max(epoch_walls[ep].values())
                barrier = max(gate - wall, 0.0)
                wrow = per_worker.setdefault(
                    wk, {"wall_sec": 0.0, "epochs": 0,
                         "phases": {p: 0.0 for p in PHASES}})
                wrow["epochs"] += 1
                # the worker's share of the JOB epoch spans its own wall
                # plus the gap to the drain — residual closes the sum
                wrow["wall_sec"] += wall + barrier
                for p in PHASES:
                    if p == "barrier_wait":
                        continue
                    wrow["phases"][p] += ph.get(p, 0.0)
                wrow["phases"]["barrier_wait"] += barrier
            for wrow in per_worker.values():
                attributed = sum(wrow["phases"].values())
                wrow["phases"][RESIDUAL] = max(
                    wrow["wall_sec"] - attributed, 0.0)
                wrow["fractions"] = _fractions(wrow["phases"],
                                               wrow["wall_sec"])
            wall_sum = sum(r["wall_sec"] for r in per_worker.values())
            phases = {p: sum(r["phases"][p] for r in per_worker.values())
                      for p in (*PHASES, RESIDUAL)}
            rows[job] = {
                "job": job,
                "attempt": attempt,
                "window_sec": w,
                "wall_sec": round(wall_sum, 6),
                "epochs": len(epoch_walls),
                "phases": {p: round(v, 6) for p, v in phases.items()},
                "fractions": _fractions(phases, wall_sum),
                "per_worker": {
                    wk: {"wall_sec": round(r["wall_sec"], 6),
                         "epochs": r["epochs"],
                         "phases": {p: round(v, 6)
                                    for p, v in r["phases"].items()},
                         "fractions": r["fractions"]}
                    for wk, r in sorted(per_worker.items())},
                "epoch_walls": {
                    str(ep): {wk: round(v, 6) for wk, v in ws.items()}
                    for ep, ws in sorted(epoch_walls.items())},
            }
        return rows

    #: memo TTL: bounds staleness when nothing feeds but the clock
    #: moves the window edge (a scrape cadence is >> this)
    _MEMO_TTL = 0.2

    def snapshot_memoized(self, window_sec: Optional[float] = None
                          ) -> Dict[str, Dict[str, Any]]:
        """:meth:`snapshot`, memoized per window while no feed landed
        (version check) and for at most ``_MEMO_TTL`` seconds. One
        STATUS walks the store for both its ``tenants`` join and its
        ``phase_budget``, and every /metrics scrape samples the budget
        gauge — without the memo each request paid N independent
        full-deque walks (PR 8's scrape-callback memo precedent).
        Callers must treat the returned rows as READ-ONLY (the critpath
        analyzer copies before enriching)."""
        w = (window_sec if window_sec is not None
             else phase_window_seconds())
        now = time.monotonic()
        with self._lock:
            hit = self._memo.get(w)
            version = self._version
        if hit is not None and hit[0] == version and now < hit[1]:
            return hit[2]
        rows = self.snapshot(w)
        with self._lock:
            if len(self._memo) > 8:  # windows are a handful of values
                self._memo.clear()
            self._memo[w] = (version, now + self._MEMO_TTL, rows)
        return rows

    def clear(self) -> None:
        with self._lock:
            self._tenants.clear()
            self._memo.clear()
            self._version += 1


def _fractions(phases: Dict[str, float],
               wall: float) -> Dict[str, float]:
    if wall <= 0:
        return {p: 0.0 for p in phases}
    return {p: round(min(max(v / wall, 0.0), 1.0), 6)
            for p, v in phases.items()}


# -- process-wide store ----------------------------------------------------

_store_lock = threading.Lock()
_store: Optional[PhaseBudgetStore] = None


def budget() -> PhaseBudgetStore:
    """The process phase-budget store, created (and its /metrics
    callback gauge registered) on first use — the ledger's shape."""
    global _store
    with _store_lock:
        if _store is None:
            _store = PhaseBudgetStore()
            _install_callbacks()
        return _store


def peek_budget() -> Optional[PhaseBudgetStore]:
    """The store if one exists — never creates (crash-path consumers
    like the flight recorder must not instantiate budget state as a
    side effect of dying)."""
    with _store_lock:
        return _store


def reset_budget() -> None:
    """Drop the process store (tests). The registry callback re-binds
    to whatever store exists at sample time."""
    global _store
    with _store_lock:
        _store = None


def _install_callbacks() -> None:
    """One labeled callback gauge sampled at scrape time: windowed
    per-phase seconds per (job, attempt, worker, phase) — the
    exposition face of the budget (pod followers' budgets reach the
    leader's history through this family). Registration failure must
    never fail store creation."""
    try:
        from harmony_tpu_torch.metrics.registry import get_registry

        def sample():
            s = _store
            if s is None:
                return []
            out = []
            for row in s.snapshot_memoized().values():
                for wk, wrow in row["per_worker"].items():
                    for phase, sec in wrow["phases"].items():
                        out.append((
                            {"job": row["job"],
                             "attempt": row["attempt"],
                             "worker": wk, "phase": phase},
                            float(sec)))
            return out

        get_registry().register_callback(
            "harmony_phase_budget_seconds",
            "Windowed per-phase wall seconds per worker (input_wait / "
            "host_dispatch / pull_comm / compute / push_comm / "
            "barrier_wait / residual; phases + residual sum to the "
            "window wall)",
            "gauge", sample)
    except Exception:
        pass  # already registered by an earlier store in this process
