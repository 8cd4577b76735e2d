"""Control-plane overload detection, admission control, and degradation.

Counterpart of ``harmony_tpu/jobserver/overload.py``, copied without its
observers: the reference's ``harmony_overload_*`` registry counters and its
``kind="overload"`` joblog events are best-effort hooks there (each in a
``try``), and the port has neither subsystem yet (ROADMAP A.10). What the
command plane and the serving edge consult is the reference's:

* **Admission control** — :meth:`OverloadMonitor.admit_submit` answers
  "may this SUBMIT enter?" from queue depth and in-flight dispatches. A
  rejected submission gets a structured ``BUSY {retry_after_ms}`` reply
  (client.py backs off with jitter and retries the same server), decided
  before anything is registered, so accepted-then-shed is impossible.
* **Overload detector + ladder** — :meth:`note_queue` (the JobServer's
  command queue depth and lag) and :meth:`note_cycle` (telemetry loops'
  overrun; no caller until the history scraper is ported) step the plane
  down ``normal -> degraded -> shedding``; at ``shedding`` the serving edge
  answers ``busy``. Every shed decision is counted in ``status()``.
* **Hysteretic recovery** — stepping back up goes through
  :class:`~harmony_tpu_torch.jobserver.policy.ActionGate`: calm must
  persist ``confirm`` consecutive evaluations and clear the cooldown
  before the ladder re-arms one rung.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from harmony_tpu_torch.jobserver.policy import ActionGate

#: master switch: 0 disables admission control AND the ladder (the
#: benchmark's protection-OFF arm; never disable in production)
ENV_OVERLOAD = "HARMONY_OVERLOAD"
#: fixed command-worker pool size (replaces thread-per-connection)
ENV_WORKERS = "HARMONY_CMD_WORKERS"
#: bounded accept-queue capacity; a full queue sheds at accept
ENV_QUEUE = "HARMONY_CMD_QUEUE"
#: per-command wall-clock deadline (read + handle), milliseconds
ENV_DEADLINE = "HARMONY_CMD_DEADLINE_MS"
#: queue-fill fraction at or above which SUBMIT sheds and the ladder
#: steps down
ENV_HIGH = "HARMONY_OVERLOAD_HIGH"
#: queue-fill fraction below which recovery may step the ladder up
ENV_LOW = "HARMONY_OVERLOAD_LOW"
#: in-flight dispatch count at or above which SUBMIT sheds
ENV_INFLIGHT = "HARMONY_OVERLOAD_INFLIGHT"
#: scrape targets / tenants evaluated per cycle in degraded mode (the
#: rotating subset size)
ENV_SUBSET = "HARMONY_OVERLOAD_SUBSET"

#: the declared degradation ladder, best fidelity first — level is an
#: index into this tuple
LADDER = ("normal", "degraded", "shedding")


def overload_enabled() -> bool:
    """``HARMONY_OVERLOAD`` (default on): 0 disables admission control
    and the degradation ladder — the chaos bench's OFF arm."""
    return os.environ.get(ENV_OVERLOAD, "").strip().lower() not in (
        "0", "off", "false")


def cmd_workers() -> int:
    """``HARMONY_CMD_WORKERS`` (default 8): fixed command-worker pool
    size — the whole command plane's thread budget."""
    try:
        return max(1, int(os.environ.get(ENV_WORKERS, "") or 8))
    except ValueError:
        return 8


def cmd_queue_cap() -> int:
    """``HARMONY_CMD_QUEUE`` (default 64): bounded accept-queue
    capacity; connections past it are answered BUSY at accept."""
    try:
        return max(1, int(os.environ.get(ENV_QUEUE, "") or 64))
    except ValueError:
        return 64


def cmd_deadline_sec() -> float:
    """``HARMONY_CMD_DEADLINE_MS`` (default 10000): per-command
    wall-clock budget in milliseconds, returned in seconds — caps the
    read phase (slow-loris eviction) and bounds a WAIT's future poll."""
    try:
        ms = float(os.environ.get(ENV_DEADLINE, "") or 10000.0)
    except ValueError:
        ms = 10000.0
    return max(0.1, ms / 1000.0)


def overload_high() -> float:
    """``HARMONY_OVERLOAD_HIGH`` (default 0.75): queue-fill fraction at
    or above which SUBMIT sheds and the ladder steps down."""
    try:
        return min(1.0, max(0.05,
                            float(os.environ.get(ENV_HIGH, "") or 0.75)))
    except ValueError:
        return 0.75


def overload_low() -> float:
    """``HARMONY_OVERLOAD_LOW`` (default 0.25): queue-fill fraction
    below which calm counts toward stepping the ladder back up."""
    try:
        return max(0.0, float(os.environ.get(ENV_LOW, "") or 0.25))
    except ValueError:
        return 0.25


def overload_inflight() -> int:
    """``HARMONY_OVERLOAD_INFLIGHT`` (default 256): running-dispatch
    count at or above which SUBMIT sheds — the registry and executor
    pool stay bounded even when the queue itself is drained fast."""
    try:
        return max(1, int(os.environ.get(ENV_INFLIGHT, "") or 256))
    except ValueError:
        return 256


def overload_subset() -> int:
    """``HARMONY_OVERLOAD_SUBSET`` (default 8): rotating-subset size —
    scrape targets per cycle and tenants per doctor/policy evaluation
    while degraded."""
    try:
        return max(1, int(os.environ.get(ENV_SUBSET, "") or 8))
    except ValueError:
        return 8


class OverloadMonitor:
    """The jobserver's overload detector + degradation ladder (module
    docstring). All inputs arrive via ``note_*``; :meth:`step` moves at
    most one ladder rung per call — down immediately under pressure, up
    only through the ActionGate's confirm-streak + cooldown hysteresis.
    Every method takes ``now=`` so tests drive time themselves."""

    #: consecutive cycle overruns of one kind before they count as
    #: pressure (a single slow GC pause is noise, a trend is load)
    OVERRUN_CONFIRM = 2

    def __init__(self, gate: Optional[ActionGate] = None,
                 enabled: Optional[bool] = None) -> None:
        self._lock = threading.Lock()
        self._enabled = overload_enabled() if enabled is None else enabled
        self._level = 0
        # upward recovery shares the policy engine's rate-limit idiom:
        # an ActionGate streak of calm windows + a cooldown per rung
        self.gate = gate or ActionGate(cooldown_sec=10.0, confirm=3,
                                       stale_after=600.0)
        self._fill = 0.0          # newest queue depth / capacity
        self._lag_sec = 0.0       # newest dequeue wait
        self._deadline = cmd_deadline_sec()
        self._overruns: Dict[str, int] = {}  # kind -> consecutive
        self._sheds: Dict[str, int] = {}
        self._rotor: Dict[str, int] = {}     # plan -> rotation cursor
        self._transitions: "deque[Dict[str, Any]]" = deque(maxlen=16)
        self._last_reason = ""

    # -- signal intake ---------------------------------------------------

    def note_queue(self, depth: int, cap: int,
                   lag_sec: Optional[float] = None) -> None:
        """Command-plane sample: accept-queue depth/capacity and (from
        the worker side) how long the dequeued connection waited."""
        with self._lock:
            self._fill = depth / float(max(1, cap))
            if lag_sec is not None:
                self._lag_sec = float(lag_sec)

    def note_cycle(self, kind: str, elapsed_sec: float,
                   budget_sec: float) -> None:
        """Telemetry-loop sample: one scrape/diagnose/plan cycle's wall
        time against its period budget. Consecutive overruns count as
        pressure; one clean cycle clears the streak."""
        with self._lock:
            if elapsed_sec > max(1e-6, budget_sec):
                self._overruns[kind] = self._overruns.get(kind, 0) + 1
            else:
                self._overruns.pop(kind, None)

    # -- pressure + ladder -----------------------------------------------

    def _pressure_reason(self) -> Optional[str]:
        """The active pressure signal, or None when calm (lock held)."""
        if self._fill >= overload_high():
            return f"queue_fill={self._fill:.2f}"
        if self._lag_sec >= 0.5 * self._deadline:
            return f"queue_lag={self._lag_sec * 1000:.0f}ms"
        hot = [k for k, n in self._overruns.items()
               if n >= self.OVERRUN_CONFIRM]
        if hot:
            return "cycle_overrun=" + ",".join(sorted(hot))
        return None

    def step(self, now: Optional[float] = None) -> int:
        """Advance the ladder at most one rung: down immediately under
        pressure, up only after the gate's hysteresis clears. Returns
        the (possibly unchanged) level."""
        if not self._enabled:
            return 0
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            reason = self._pressure_reason()
            level = self._level
            calm = reason is None and self._fill <= overload_low()
        if reason is not None and level < len(LADDER) - 1:
            # descending is immediate — shedding late is wedging
            self.gate.observe("control-plane", "overload_step_up",
                              wanted=False, signal="overload", now=now)
            return self._transition(level + 1, reason, now)
        if level > 0 and calm:
            ready = self.gate.observe("control-plane", "overload_step_up",
                                      wanted=True, signal="overload",
                                      now=now)
            if ready:
                self.gate.fired("control-plane", "overload_step_up",
                                signal="overload", now=now)
                return self._transition(level - 1, "recovered", now)
        elif not calm:
            # pressure gone but fill still above LOW: reset the calm
            # streak — hysteresis means CONSECUTIVE calm windows
            self.gate.observe("control-plane", "overload_step_up",
                              wanted=False, signal="overload", now=now)
        return self._level

    def _transition(self, new_level: int, reason: str, now: float) -> int:
        from harmony_tpu_torch import faults

        with self._lock:
            old, self._level = self._level, new_level
            self._last_reason = reason
            ev = {"from": LADDER[old], "to": LADDER[new_level],
                  "reason": reason, "ts": time.time()}
            self._transitions.append(ev)
        direction = "down" if new_level > old else "up"
        if faults.armed():
            # chaos hook: a raise here models the detector itself
            # wedging mid-transition — the ladder must stay consistent
            try:
                faults.site("server.overload", direction=direction,
                            level=LADDER[new_level])
            except Exception:
                pass
        return new_level

    # -- admission -------------------------------------------------------

    def admit_submit(self, queue_depth: int, queue_cap: int,
                     inflight: int) -> Optional[int]:
        """Admission decision for ONE SUBMIT: None admits; an int is the
        ``retry_after_ms`` hint of a structured BUSY rejection. Decided
        BEFORE anything durable happens, so a rejected submission left
        no trace and an admitted one cannot be shed later.

        Admission tracks the LIVE queue, not just the ladder: at the
        shedding rung a SUBMIT is still admitted once the queue has
        actually drained to the low-water mark. The ladder's hysteretic
        recovery governs telemetry fidelity; gating admission on it too
        would starve well-behaved backed-off clients for a full
        recovery cycle after every burst (their retries land exactly in
        the drained windows this clause admits)."""
        if not self._enabled:
            return None
        fill = queue_depth / float(max(1, queue_cap))
        with self._lock:
            level = self._level
        if (fill < overload_high() and inflight < overload_inflight()
                and (level < len(LADDER) - 1 or fill <= overload_low())):
            return None
        self.count_shed("busy_reject")
        return self.retry_after_ms(fill=fill, level=level)

    def retry_after_ms(self, fill: Optional[float] = None,
                       level: Optional[int] = None) -> int:
        """Backoff hint scaled by how overloaded we are — deeper ladder
        levels and fuller queues push retries further out (the client
        adds jitter so a storm's retries do not re-arrive in phase)."""
        with self._lock:
            fill = self._fill if fill is None else fill
            level = self._level if level is None else level
        ms = 200.0 * (1 + level) * max(1.0, fill / overload_high())
        return int(min(5000.0, max(100.0, ms)))

    # -- degraded-mode plans ---------------------------------------------

    def degraded(self) -> bool:
        return self._level >= 1

    def shedding(self) -> bool:
        return self._level >= len(LADDER) - 1

    def plan_subset(self, keys: Sequence[str], plan: str,
                    keep: Sequence[str] = ()) -> List[str]:
        """Rotating work subset for one degraded loop (``plan`` names
        the rotor: "scrape", "tenants", ...). Level 0 returns every
        key; degraded levels return ``keep`` plus the next
        ``HARMONY_OVERLOAD_SUBSET``-sized slice, advancing the cursor
        so successive cycles cover the full set. Skips are counted."""
        keys = list(keys)
        if not self.degraded() or not keys:
            return keys
        rest = sorted(k for k in keys if k not in keep)
        k = overload_subset()
        if len(rest) <= k:
            return list(keep) + rest
        with self._lock:
            idx = self._rotor.get(plan, 0) % len(rest)
            self._rotor[plan] = (idx + k) % len(rest)
        picked = [rest[(idx + i) % len(rest)] for i in range(k)]
        self.count_shed(f"{plan}_skip", n=len(rest) - k)
        return list(keep) + picked

    def dashboard_factor(self) -> float:
        """Multiplier on the dashboard tee's rate-limit period: 1x at
        normal fidelity, harder the further down the ladder."""
        return float(4 ** self._level)

    # -- accounting ------------------------------------------------------

    def count_shed(self, action: str, n: int = 1) -> None:
        """One counted shed decision (busy_reject, accept_shed,
        scrape_skip, tenants_skip, policy_skip, dashboard_skip,
        slowloris_evict, deadline_evict)."""
        with self._lock:
            self._sheds[action] = self._sheds.get(action, 0) + n

    def status(self) -> Dict[str, Any]:
        """The STATUS ``overload`` payload / ``obs top`` header."""
        with self._lock:
            return {
                "enabled": self._enabled,
                "level": self._level,
                "ladder": LADDER[self._level],
                "reason": self._last_reason,
                "queue_fill": round(self._fill, 4),
                "queue_lag_ms": round(self._lag_sec * 1000.0, 1),
                "cycle_overruns": dict(self._overruns),
                "sheds": dict(self._sheds),
                "transitions": list(self._transitions),
                "gate": self.gate.stats(),
            }
