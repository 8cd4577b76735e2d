"""Bounded retry with exponential backoff + jitter.

A copy of ``harmony_tpu/faults/retry.py``.

The layers under the pod's recovery machinery used to fail hard on the
first transient error (one ECONNRESET during a block migration killed the
job; one slow disk write killed a checkpoint chain). This module gives
them ONE retry idiom, driven by :class:`harmony_tpu_torch.config.params.
RetryPolicy` so every pod process shares the same knobs via env:

    from harmony_tpu_torch.faults.retry import call_with_retry
    call_with_retry(attempt_fn, RetryPolicy.from_env(), op="blockmove.send")

Exhausted retries raise :class:`RetryError` carrying the op, attempt
count, and last error. Callers on infra paths translate that into an
``infra_suspect`` failure (see :class:`InfraTransientError`) so the pod's
auto-resume treats it like the infrastructure fault it is, instead of a
job bug that would fail identically on resubmit.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple, Type, TypeVar

T = TypeVar("T")

_lock = threading.Lock()
_counters: Dict[str, int] = {}

# The jitter source for every backoff pause. Module-level and swappable
# so chaos replays can pin it: same seed -> byte-identical retry timing
# across a whole run (the client's busy-backoff uses this too).
_DEFAULT_RNG: random.Random = getattr(random, "_inst", None) or random.Random()
_jitter_rng: random.Random = _DEFAULT_RNG


def set_jitter_rng(rng: Optional[random.Random]) -> random.Random:
    """Install ``rng`` as the backoff-jitter source (None restores the
    process default). Returns the previous source so tests can swap it
    back."""
    global _jitter_rng
    prev = _jitter_rng
    _jitter_rng = rng if rng is not None else _DEFAULT_RNG
    return prev


def jitter_rng() -> random.Random:
    """The current backoff-jitter source (see :func:`set_jitter_rng`)."""
    return _jitter_rng


def _count(key: str, n: int = 1) -> None:
    with _lock:
        _counters[key] = _counters.get(key, 0) + n
    # Mirror onto the process instrument registry (metrics/registry.py):
    # the ``<op>.retries`` / ``<op>.giveups`` keys become one labeled
    # counter a /metrics scraper can watch — *.retries rising flags
    # transient infra trouble before it becomes a giveup.
    try:
        from harmony_tpu_torch.metrics.registry import get_registry

        op, _, kind = key.rpartition(".")
        get_registry().counter(
            "harmony_retry_events_total",
            "Bounded-retry events per op: kind=retries (re-attempts) "
            "or kind=giveups (policy exhausted)",
            ("op", "kind"),
        ).labels(op=op or key, kind=kind).inc(n)
    except Exception:  # observability must never fail the retry path
        pass


def retry_counters() -> Dict[str, int]:
    """Snapshot: ``<op>.retries`` (re-attempts after a retryable error)
    and ``<op>.giveups`` (policies exhausted) per op, this process."""
    with _lock:
        return dict(_counters)


def reset_counters() -> None:
    with _lock:
        _counters.clear()


class InfraTransientError(RuntimeError):
    """Marker base for give-up errors whose cause is infrastructure
    (transport, storage, a wedged helper process) rather than the job's
    own logic. The pod leader counts a job failure carrying this marker
    as auto-resume evidence (jobserver/pod.py), because resubmission has
    a real chance of succeeding — unlike a deterministic job bug."""

    infra_suspect = True


class RetryError(InfraTransientError):
    """Retries exhausted. ``last_error`` is the final attempt's error
    (also chained as ``__cause__``)."""

    def __init__(self, op: str, attempts: int,
                 last_error: BaseException) -> None:
        super().__init__(
            f"{op}: gave up after {attempts} attempt(s); last error: "
            f"{type(last_error).__name__}: {last_error}")
        self.op = op
        self.attempts = attempts
        self.last_error = last_error


def backoff_delays(policy, attempts: Optional[int] = None):
    """The policy's backoff schedule (pre-jitter), for tests and docs."""
    delay = policy.base_delay_sec
    for _ in range((attempts or policy.max_attempts) - 1):
        yield min(delay, policy.max_delay_sec)
        delay *= policy.multiplier


def call_with_retry(
    fn: Callable[[], T],
    policy,
    *,
    op: str = "op",
    retryable: Tuple[Type[BaseException], ...] = (OSError, TimeoutError),
    fatal: Tuple[Type[BaseException], ...] = (),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    deadline: Optional[float] = None,
) -> T:
    """Run ``fn`` under ``policy`` (a config.params.RetryPolicy).

    ``fatal`` exceptions are re-raised immediately even when they subclass
    a retryable type — e.g. CheckpointCorruptError is an OSError, but
    re-reading corrupt bytes cannot help. ``deadline`` (time.monotonic
    value) caps the whole loop: no sleep is taken past it, and the give-up
    happens early rather than blowing an outer protocol timeout.
    ``on_retry(attempt, error)`` observes each re-attempt (logging hooks).
    """
    delay = policy.base_delay_sec
    last: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn()
        except fatal:
            raise
        except retryable as e:
            last = e
            if attempt >= policy.max_attempts or (
                    deadline is not None and time.monotonic() >= deadline):
                _count(f"{op}.giveups")
                raise RetryError(op, attempt, e) from e
            _count(f"{op}.retries")
            if on_retry is not None:
                on_retry(attempt, e)
            pause = min(delay, policy.max_delay_sec)
            pause *= 1.0 + policy.jitter * _jitter_rng.random()
            if deadline is not None:
                pause = min(pause, max(0.0, deadline - time.monotonic()))
            sleep(pause)
            delay *= policy.multiplier
    raise RetryError(op, policy.max_attempts, last or RuntimeError("no attempt"))
