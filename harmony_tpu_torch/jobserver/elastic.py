"""Elastic shrink-to-survivors recovery: the vocabulary both sides share.

A copy of ``harmony_tpu/jobserver/elastic.py`` (which imports no JAX; the
port keeps its own copy). A job flagged ``user.elastic_shrink`` does not fail
when a pod follower is lost: the leader keeps the SAME submission (one job
id, one client future) and dispatches it again over the survivors, restoring
from the newest committed chain entry only the blocks this process lost
(``checkpoint/manager.py::restore_partial`` and the per-process recovery
cache: O(lost bytes), not O(model bytes)). The reverse leg re-grows: when a
confined follower's beats resume, the running shrunk job is fenced once and
dispatched again over its original executors.

Why a FENCE and not a live reshard: the recovery point must be a consistent
epoch cut (the bar is the uninterrupted run's losses, every batch once an
epoch), so a reconfiguration always lands at the chief worker's epoch hook,
the one point every process of the job reaches at the same epoch
(``jobserver/podplan.py``). The fence rides the PLAN broadcast; the chain hook
has already snapshotted the fence epoch when it fires (the hook order of
``entity.run``), so the next attempt resumes one epoch later with nothing
lost and nothing replayed.

This module holds only what the pod's control plane and the job entity both
need, so neither imports the other for it.
"""
from __future__ import annotations

import os


class ElasticFence(RuntimeError):
    """Raised by the chief worker's epoch hook when a fence plan is due: a
    deliberate teardown of the current attempt in every process at once, so
    the leader can dispatch the same submission over another executor set.
    Not a failure of the job and not infra damage: the elastic dispatch loop
    catches it and continues the submission."""

    def __init__(self, kind: str, epoch: int) -> None:
        super().__init__(
            f"elastic {kind} fence at epoch {epoch}: attempt ends here so "
            "the same submission can continue on a different executor set")
        self.kind = kind          # "shrink" | "regrow"
        self.epoch = int(epoch)

    @property
    def elastic_fence(self) -> str:
        """The marker carried onto a follower's JOB_DONE and the leader's
        wrapper errors, so the elastic loop classifies a fence without
        importing exception types across the wire."""
        return self.kind


def attempt_key(job_id: str, attempt: int) -> str:
    """The wire, report and unit-protocol key of one elastic attempt.
    Attempt 0 is the plain job id, so every non-elastic path is unchanged;
    recovery attempts get a suffix, so a superseded attempt's reports,
    heartbeat listings and unit messages never reach the live one."""
    return job_id if attempt <= 0 else f"{job_id}@a{attempt}"


def attempt_of(config) -> int:
    """The attempt index a (possibly recovery) JobConfig encodes."""
    rec = config.user.get("elastic_recovery")
    return int(rec.get("attempt", 0)) if isinstance(rec, dict) else 0


def config_attempt_key(config) -> str:
    return attempt_key(config.job_id, attempt_of(config))


def max_shrinks() -> int:
    """Cap on in-place recoveries a submission (shrink and re-grow fences
    both count): a pod losing followers faster than recovery converges must
    fail loudly in the end, not thrash for ever."""
    return int(os.environ.get("HARMONY_ELASTIC_MAX_SHRINKS", "4"))


def regrow_enabled() -> bool:
    """Whether a recovered follower fences running shrunk jobs to re-grow
    (``HARMONY_ELASTIC_REGROW=0`` leaves them shrunk)."""
    return os.environ.get("HARMONY_ELASTIC_REGROW", "1").lower() not in (
        "0", "false", "off", "")


def cache_enabled() -> bool:
    """Whether elastic jobs keep a host copy of this process's blocks at each
    chain entry (the recovery cache that makes a partial restore O(lost
    bytes)). One host copy of the owned shard an elastic job;
    ``HARMONY_ELASTIC_CACHE=0`` trades restore reads for that memory."""
    return os.environ.get("HARMONY_ELASTIC_CACHE", "1").lower() not in (
        "0", "false", "off", "")
