"""Deterministic fault injection — the plan, the sites, the counters.

A copy of ``harmony_tpu/faults/plan.py``.

The recovery paths this repo promises (pod heartbeat confinement,
checkpoint-chain auto-resume, bounded-retry transports) are only real if
they are *exercised*: parameter-server systems treat worker failure and
restore-from-checkpoint as a first-class, continuously tested path, not an
exception handler (TensorFlow, arXiv:1605.08695). This module provides the
machinery: production code declares named **fault sites**

    from harmony_tpu_torch import faults
    if faults.armed():
        faults.site("blockmove.send", block=b, dst=dst)

and tests arm a :class:`FaultPlan` of :class:`FaultRule` triggers ("the
k-th send of block 3 to process 1 raises OSError", "worker step 8 on
process 1 crashes the process"). Three properties matter:

  * **zero overhead disarmed** — ``armed()`` is one module-global read
    (after a one-time env probe), and sites are conventionally guarded by
    it so not even the context kwargs are materialized in production;
  * **deterministic** — triggers are pure predicates over the site name,
    the caller-supplied context, and per-rule hit counters; no randomness;
  * **process-crossing** — a plan serializes into the
    ``HARMONY_FAULT_PLAN`` env var, so subprocesses (pod followers, the
    isolated orbax worker) arm the same plan on first use and real
    processes can be killed mid-epoch. An optional shared ``state_path``
    persists hit counters across process respawns, so "fire once" means
    once per *plan*, not once per incarnation (a respawned worker must
    not re-wedge forever).
"""
from __future__ import annotations

import fnmatch
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

ENV_VAR = "HARMONY_FAULT_PLAN"


class InjectedFault(OSError):
    """Default exception an armed ``raise`` rule throws. An OSError
    subclass on purpose: injected faults stand in for transport/IO
    failures and must be caught by the same handlers."""


class DiskFullError(OSError):
    """Injected ENOSPC. Carries the real errno so ``e.errno ==
    errno.ENOSPC`` checks in IO handlers behave exactly as they would
    against a genuinely full disk."""

    def __init__(self, *args: Any) -> None:
        import errno as _errno
        super().__init__(_errno.ENOSPC, *(args or ("injected ENOSPC",)))


class DiskIOError(OSError):
    """Injected EIO — a failing device/sector, with the real errno set."""

    def __init__(self, *args: Any) -> None:
        import errno as _errno
        super().__init__(_errno.EIO, *(args or ("injected EIO",)))


# name -> exception class for FaultRule.exc (a closed registry: the plan
# crosses process boundaries as JSON, so arbitrary dotted paths would be
# an eval-from-env hazard)
_EXC_TYPES: Dict[str, type] = {
    "InjectedFault": InjectedFault,
    "OSError": OSError,
    "IOError": IOError,
    "ConnectionError": ConnectionError,
    "ConnectionResetError": ConnectionResetError,
    "ConnectionRefusedError": ConnectionRefusedError,
    "TimeoutError": TimeoutError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "DiskFullError": DiskFullError,
    "DiskIOError": DiskIOError,
}

_ACTIONS = ("raise", "crash", "hang", "delay", "skip", "corrupt", "spew")


class FaultRule:
    """One trigger: WHERE (site glob + context equality matchers), WHEN
    (skip the first ``after`` matching hits, fire at most ``count``
    times; count < 0 = forever), WHAT (``action``):

      * ``raise`` — raise ``exc`` (registry name) with ``message``;
      * ``crash`` — ``os._exit(exit_code)``: kill this process mid-step,
        no cleanup, exactly like a SIGKILL'd follower;
      * ``hang``  — sleep ``delay_sec`` (default 3600): a wedged worker;
      * ``delay`` — sleep ``delay_sec`` then continue: a slow link;
      * ``skip``  — returned to the caller, which suppresses the guarded
        operation (e.g. drop a heartbeat);
      * ``corrupt`` — returned to the caller, which damages its payload
        (e.g. flip bytes in a checkpoint block / emit a garbage
        protocol line);
      * ``spew`` — write ~``delay_sec`` KB of noise to stderr then
        continue (the stderr-flood regression for pipe-buffer hangs).
    """

    __slots__ = ("site", "match", "after", "count", "action", "exc",
                 "message", "delay_sec", "exit_code")

    def __init__(self, site: str, *, match: Optional[Dict[str, Any]] = None,
                 after: int = 0, count: int = 1, action: str = "raise",
                 exc: str = "InjectedFault", message: str = "injected fault",
                 delay_sec: float = 3600.0, exit_code: int = 86) -> None:
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r}")
        if action == "raise" and exc not in _EXC_TYPES:
            raise ValueError(f"unknown fault exception {exc!r} "
                             f"(registry: {sorted(_EXC_TYPES)})")
        self.site = site
        self.match = dict(match or {})
        self.after = int(after)
        self.count = int(count)
        self.action = action
        self.exc = exc
        self.message = message
        self.delay_sec = float(delay_sec)
        self.exit_code = int(exit_code)

    def matches(self, name: str, ctx: Dict[str, Any]) -> bool:
        if not fnmatch.fnmatchcase(name, self.site):
            return False
        return all(k in ctx and ctx[k] == v for k, v in self.match.items())

    def to_dict(self) -> Dict[str, Any]:
        return {s: getattr(self, s) for s in self.__slots__}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "FaultRule":
        d = dict(d)
        site = d.pop("site")
        return FaultRule(site, **d)


class FaultPlan:
    """An ordered rule list plus the hit/fired counters that make triggers
    like "the 3rd matching hit" deterministic. First matching *armed*
    rule wins per :meth:`fire` call."""

    def __init__(self, rules: List[FaultRule],
                 state_path: Optional[str] = None) -> None:
        self.rules = list(rules)
        #: optional JSON file persisting per-rule counters across process
        #: respawns (file-locked read-modify-write); None = in-memory
        self.state_path = state_path
        self._lock = threading.Lock()
        self._hits = [0] * len(self.rules)
        self._fired = [0] * len(self.rules)

    # -- serialization (env / process crossing) --------------------------

    def to_json(self) -> str:
        return json.dumps({
            "rules": [r.to_dict() for r in self.rules],
            "state_path": self.state_path,
        }, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "FaultPlan":
        d = json.loads(text)
        return FaultPlan([FaultRule.from_dict(r) for r in d.get("rules", [])],
                         state_path=d.get("state_path"))

    # -- shared counter state --------------------------------------------

    def _load_state(self) -> Dict[str, List[int]]:
        try:
            with open(self.state_path) as f:
                st = json.load(f)
            hits, fired = list(st.get("hits", [])), list(st.get("fired", []))
        except (OSError, ValueError):
            hits, fired = [], []
        n = len(self.rules)
        return {"hits": (hits + [0] * n)[:n], "fired": (fired + [0] * n)[:n]}

    def _fire_decision(self, name: str, ctx: Dict[str, Any],
                       hits: List[int], fired: List[int]) -> Optional[int]:
        """Pure trigger logic over explicit counters: returns the index of
        the rule that fires (counters mutated in place), or None."""
        for i, rule in enumerate(self.rules):
            if not rule.matches(name, ctx):
                continue
            hits[i] += 1
            if hits[i] <= rule.after:
                continue
            if 0 <= rule.count <= fired[i]:
                continue
            fired[i] += 1
            return i
        return None

    def fire(self, name: str, ctx: Dict[str, Any]) -> Optional[str]:
        """Evaluate the plan at site ``name``. Raises for ``raise`` rules,
        kills the process for ``crash``, sleeps for ``hang``/``delay``,
        and returns the action name for caller-interpreted actions
        (``skip``/``corrupt``) — None when nothing fired."""
        with self._lock:
            if self.state_path:
                idx = self._fire_with_file_state(name, ctx)
            else:
                idx = self._fire_decision(name, ctx, self._hits, self._fired)
        if idx is None:
            return None
        rule = self.rules[idx]
        _count(f"{rule.site}:{rule.action}")
        # Telemetry plane (best-effort, never breaks injection): the trip
        # lands (a) as an annotation on the current trace span, (b) in
        # the flight-recorder ring — with a one-per-site crash dump, so
        # even the "crash" action below leaves its black box on disk
        # before os._exit — and (c) on the harmony_fault_fires_total
        # counter the /metrics endpoints expose.
        _observe_fire(rule, name, ctx)
        if rule.action == "crash":
            sys.stderr.write(
                f"harmony.faults: injected crash at {name} "
                f"(exit {rule.exit_code})\n")
            sys.stderr.flush()
            os._exit(rule.exit_code)
        if rule.action in ("hang", "delay"):
            time.sleep(rule.delay_sec)
            return rule.action
        if rule.action == "spew":
            noise = ("injected stderr noise: " + "x" * 100 + "\n")
            for _ in range(max(1, int(rule.delay_sec * 1024 // len(noise)))):
                sys.stderr.write(noise)
            sys.stderr.flush()
            return rule.action
        if rule.action == "raise":
            raise _EXC_TYPES[rule.exc](
                f"{rule.message} [site={name} rule={idx}]")
        return rule.action  # skip | corrupt

    def _fire_with_file_state(self, name: str,
                              ctx: Dict[str, Any]) -> Optional[int]:
        """File-locked read-modify-write of the shared counters, so "fire
        once" holds across respawned processes arming the same plan."""
        import fcntl

        lock_path = self.state_path + ".lock"
        with open(lock_path, "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                st = self._load_state()
                idx = self._fire_decision(name, ctx, st["hits"], st["fired"])
                tmp = self.state_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(st, f)
                os.replace(tmp, self.state_path)
                return idx
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)


def _observe_fire(rule: "FaultRule", name: str, ctx: Dict[str, Any]) -> None:
    """Cross-wire a fired rule into the telemetry plane. Guarded: fault
    injection must keep working even if the observability layer is
    broken (it is the thing under test, after all)."""
    try:
        from harmony_tpu_torch.tracing.span import current_span

        span = current_span()
        if span is not None:
            span.annotate(f"fault:{name}", rule.action)
    except Exception:
        pass
    try:
        from harmony_tpu_torch.metrics.registry import get_registry

        get_registry().counter(
            "harmony_fault_fires_total",
            "Injected-fault rule fires, by site pattern and action",
            ("site", "action"),
        ).labels(site=rule.site, action=rule.action).inc()
    except Exception:
        pass
    try:
        from harmony_tpu_torch.tracing import flight

        flight.get_recorder().on_fault_trip(name, rule.action, ctx)
    except Exception:
        pass


# -- the armed plan + site entry points ----------------------------------

_plan: Optional[FaultPlan] = None
_env_checked = False
_state_lock = threading.Lock()
_counters: Dict[str, int] = {}


def _count(key: str) -> None:
    with _state_lock:
        _counters[key] = _counters.get(key, 0) + 1


def counters() -> Dict[str, int]:
    """Snapshot of fired-fault counters (``site:action`` -> fires) in
    THIS process. Retry counters live in harmony_tpu_torch.faults.retry."""
    with _state_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _state_lock:
        _counters.clear()


def arm(plan: FaultPlan, propagate: bool = False) -> None:
    """Arm ``plan`` in this process; ``propagate=True`` also exports it to
    ``HARMONY_FAULT_PLAN`` so subprocesses spawned afterwards inherit it."""
    global _plan, _env_checked
    _plan = plan
    _env_checked = True
    if propagate:
        os.environ[ENV_VAR] = plan.to_json()


def disarm() -> None:
    """Disarm and clear the env export. The process stays disarmed until
    an explicit :func:`arm` / :func:`arm_from_env`."""
    global _plan, _env_checked
    _plan = None
    _env_checked = True
    os.environ.pop(ENV_VAR, None)


def arm_from_env() -> Optional[FaultPlan]:
    """(Re)probe ``HARMONY_FAULT_PLAN`` and arm whatever it holds."""
    global _plan, _env_checked
    _env_checked = True
    text = os.environ.get(ENV_VAR)
    if text:
        try:
            _plan = FaultPlan.from_json(text)
        except (ValueError, KeyError, TypeError) as e:
            raise ValueError(f"unparseable {ENV_VAR}: {e}") from e
    else:
        _plan = None
    return _plan


def armed() -> bool:
    """True when a plan is armed. The guard hot paths use so a disarmed
    site costs one global read and no context construction."""
    if not _env_checked:
        arm_from_env()
    return _plan is not None


def site(name: str, **ctx: Any) -> Optional[str]:
    """Declare a fault site. No-op (None) unless an armed rule fires;
    otherwise raises / crashes / sleeps per the rule, or returns the
    action name (``skip``/``corrupt``/``delay``/``hang``/``spew``) for
    the caller to interpret."""
    if not _env_checked:
        arm_from_env()
    plan = _plan
    if plan is None:
        return None
    return plan.fire(name, ctx)
