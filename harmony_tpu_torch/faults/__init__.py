"""Deterministic fault injection + hardened-recovery primitives.

Counterpart of ``harmony_tpu/faults/__init__.py``; ``plan.py`` and
``retry.py`` are copies of the reference's. The sites the port declares are
the checkpoint path's (``chkp.block_write``, ``disk.write``,
``chkp.block_read``, ``disk.read``, ``chkp.commit``, ``disk.fsync``,
``chkp.partial_read``). Fires and retries are mirrored onto the metrics
registry (``harmony_fault_fires_total``, ``harmony_retry_events_total``); the
flight recorder is looked up lazily and skipped while absent (ROADMAP A item
6.4).

Two halves:
  * :mod:`harmony_tpu_torch.faults.plan` — named injection sites threaded
    through the transports/checkpoint/pod layers, armed by a
    :class:`FaultPlan` (env-serializable, so plans cross process
    boundaries into pod followers and the isolated orbax worker);
  * :mod:`harmony_tpu_torch.faults.retry` — the one bounded-backoff retry idiom
    those layers use, with give-up errors marked ``infra_suspect`` so the
    pod's auto-resume machinery treats them as infrastructure faults.

See docs/FAULT_TOLERANCE.md for the failure model, the site registry, and
the recovery matrix.
"""
from harmony_tpu_torch.faults.plan import (
    ENV_VAR,
    DiskFullError,
    DiskIOError,
    FaultPlan,
    FaultRule,
    InjectedFault,
    arm,
    arm_from_env,
    armed,
    counters,
    disarm,
    reset_counters,
    site,
)
from harmony_tpu_torch.faults.retry import (
    InfraTransientError,
    RetryError,
    backoff_delays,
    call_with_retry,
    jitter_rng,
    retry_counters,
    set_jitter_rng,
)


def all_counters() -> dict:
    """Fault-fire + retry counters merged (metrics surface)."""
    out = dict(counters())
    out.update(retry_counters())
    return out


__all__ = [
    "ENV_VAR",
    "DiskFullError",
    "DiskIOError",
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "InfraTransientError",
    "RetryError",
    "all_counters",
    "arm",
    "arm_from_env",
    "armed",
    "backoff_delays",
    "call_with_retry",
    "counters",
    "disarm",
    "jitter_rng",
    "reset_counters",
    "retry_counters",
    "set_jitter_rng",
    "site",
]
