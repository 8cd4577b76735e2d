"""ActionGate: the cooldown + hysteresis rate limiter of the policy engine.

Counterpart of ``harmony_tpu/jobserver/policy.py``, cut to the
:class:`ActionGate` (``:148-274``) and the env knobs it reads: the overload
ladder (``jobserver/overload.py``) steps back up through it. The policy
engine itself, which replans placement through elastic fences, waits for
the elastic control plane (ROADMAP A.10).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

ENV_PERIOD = "HARMONY_POLICY_PERIOD"
ENV_COOLDOWN = "HARMONY_POLICY_COOLDOWN"
ENV_CONFIRM = "HARMONY_POLICY_CONFIRM"


def policy_period() -> float:
    """``HARMONY_POLICY_PERIOD`` (default 10 s): seconds between policy
    evaluations (rides the history-scraper cycle, so the effective
    cadence is the next scrape at or after the period)."""
    try:
        return max(0.1, float(os.environ.get(ENV_PERIOD, "") or 10.0))
    except ValueError:
        return 10.0


def policy_cooldown() -> float:
    """``HARMONY_POLICY_COOLDOWN`` (default 30 s): minimum seconds
    between actions on one subject (tenant) and on one SIGNAL — the
    anti-thrash half of the gate."""
    try:
        return max(0.0, float(os.environ.get(ENV_COOLDOWN, "") or 30.0))
    except ValueError:
        return 30.0


def policy_confirm() -> int:
    """``HARMONY_POLICY_CONFIRM`` (default 2): consecutive evaluations a
    signal must persist before its action may fire — the hysteresis
    half of the gate."""
    try:
        return max(1, int(os.environ.get(ENV_CONFIRM, "") or 2))
    except ValueError:
        return 2


class ActionGate:
    """Cooldown + hysteresis rate limiter shared by the device policy
    engine and the input-worker autoscaler.

    Keys are ``(subject, action)``; cooldowns apply per SUBJECT and per
    SIGNAL (a fired action on signal ``input_wait`` cools every other
    key on that signal — the device engine and the input autoscaler
    cannot fight over one stall measurement). ``observe`` maintains the
    consecutive-wanting streak; ``fired`` stamps the cooldowns;
    ``back_off`` (driven by ``rebalance_ineffective`` diagnoses)
    multiplies the subject's next cooldown.
    """

    def __init__(self, cooldown_sec: Optional[float] = None,
                 confirm: Optional[int] = None,
                 stale_after: Optional[float] = None,
                 backoff_factor: float = 4.0) -> None:
        self.cooldown_sec = (policy_cooldown() if cooldown_sec is None
                             else float(cooldown_sec))
        self.confirm = policy_confirm() if confirm is None else max(1, int(confirm))
        #: a streak older than this is stale (the engine stopped seeing
        #: the signal) and restarts at 1; default spans ~3 periods so a
        #: single missed evaluation does not reset hysteresis
        self.stale_after = (3.0 * policy_period() if stale_after is None
                            else float(stale_after))
        self.backoff_factor = float(backoff_factor)
        self._lock = threading.Lock()
        self._streak: Dict[Tuple[str, str], Tuple[int, float]] = {}
        self._cool_until: Dict[str, float] = {}  # subject or signal
        self._backoffs: Dict[str, int] = {}      # subject -> count
        self.fired_total = 0

    def observe(self, subject: str, action: str, wanted: bool,
                signal: str = "device",
                now: Optional[float] = None) -> bool:
        """Record one evaluation's view of (subject, action); True when
        the action may fire NOW (streak >= confirm, subject and signal
        both outside cooldown)."""
        now = time.monotonic() if now is None else float(now)
        key = (subject, action)
        with self._lock:
            if not wanted:
                self._streak.pop(key, None)
                return False
            n, last = self._streak.get(key, (0, now))
            n = 1 if (n and now - last > self.stale_after) else n + 1
            self._streak[key] = (n, now)
            if n < self.confirm:
                return False
            for scope in (subject, signal):
                if now < self._cool_until.get(scope, 0.0):
                    return False
            return True

    def fired(self, subject: str, action: str,
              signal: Optional[str] = "device",
              now: Optional[float] = None) -> None:
        """An action executed: reset its streak and start the subject +
        signal cooldowns (scaled by any pending backoff).
        ``signal=None`` cools ONLY the subject — an ADVISORY firing must
        pace its own re-planning without throttling live actuators
        (the input autoscaler) sharing the signal scope."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            self._streak.pop((subject, action), None)
            cool = self.cooldown_sec
            if self._backoffs.get(subject):
                cool *= self.backoff_factor * self._backoffs[subject]
            self._cool_until[subject] = now + cool
            if signal is not None:
                self._cool_until[signal] = max(
                    self._cool_until.get(signal, 0.0),
                    now + self.cooldown_sec)
            self.fired_total += 1

    def sweep(self, observed: "set[Tuple[str, str]]",
              among: Optional["frozenset[str]"] = None,
              subjects: Optional["set[str]"] = None) -> None:
        """Drop streaks for keys NOT observed this round: hysteresis
        means CONSECUTIVE windows, so a candidate the planner stopped
        surfacing restarts from zero — and a long-lived server never
        accumulates streak entries for tenants long gone. ``among``
        restricts the sweep to keys whose ACTION is in the set — on a
        SHARED gate each loop sweeps only its own action vocabulary
        (the policy engine must never reset the input autoscaler's
        streaks). ``subjects`` restricts it to keys whose SUBJECT is in
        the set — an incremental (overload-degraded) evaluation swept
        only the tenants it actually looked at; the rest keep their
        streaks for their next rotation turn."""
        with self._lock:
            for key in [k for k in self._streak
                        if k not in observed
                        and (among is None or k[1] in among)
                        and (subjects is None or k[0] in subjects)]:
                del self._streak[key]

    def back_off(self, subject: str, now: Optional[float] = None) -> None:
        """A past action on ``subject`` proved ineffective: extend its
        cooldown multiplicatively so the engine stops churning it."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            self._backoffs[subject] = self._backoffs.get(subject, 0) + 1
            self._cool_until[subject] = max(
                self._cool_until.get(subject, 0.0),
                now + self.cooldown_sec * self.backoff_factor
                * self._backoffs[subject])

    def cooling(self, scope: str, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            return now < self._cool_until.get(scope, 0.0)

    def stats(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            return {
                "cooldown_sec": self.cooldown_sec,
                "confirm": self.confirm,
                "fired_total": self.fired_total,
                "streaks": {f"{s}:{a}": n
                            for (s, a), (n, _) in self._streak.items()},
                "cooling": sorted(k for k, t in self._cool_until.items()
                                  if now < t),
                "backoffs": dict(self._backoffs),
            }
