"""Per-job prefixed operator logging and the structured event rings.

A copy of ``harmony_tpu/jobserver/joblog.py`` (which imports no JAX; the port
keeps its own copy). A multi-tenant server interleaves many jobs' lifecycle
events in one operator log, so every job-scoped line carries a ``[JobId:
<id>]`` prefix (:class:`JobLogger`, a ``logging.LoggerAdapter`` over the
shared ``harmony_tpu_torch.jobserver`` logger). The recovery paths (elastic
shrink and re-grow, confinement, rehabilitation, auto-resume) also record
STRUCTURED events (:func:`record_event`, :meth:`JobLogger.event`), which
STATUS's ``job_events`` and the pod's ``elastic_events`` surface: bounded,
in memory, one ring a job in each process. The port's kinds: ``elastic_restore``
(``jobserver/entity.py``), and ``follower_death``, ``follower_silenced``,
``follower_rehabilitated``, ``elastic_shrink_fence``, ``elastic_regrow_fence``,
``elastic_shrink``, ``elastic_regrow``, ``elastic_give_up`` and ``auto_resume``
(``jobserver/pod.py``).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

#: Shared base logger for server-scoped (not job-scoped) events.
server_log = logging.getLogger("harmony_tpu_torch.jobserver")

_EVENTS_LOCK = threading.Lock()
_EVENTS: Dict[str, List[Dict[str, Any]]] = {}
_EVENTS_PER_JOB = 64
_EVENTS_MAX_JOBS = 256
#: sinks: every structured event tees here. Sinks must never fail the
#: recording path.
_SINKS: List[Any] = []


def record_event(job_id: str, kind: str, **fields: Any) -> Dict[str, Any]:
    """Append one structured event to ``job_id``'s ring. ``fields`` must be
    JSON-serializable (they ride STATUS verbatim).

    Eviction is least recently APPENDED: the ring is re-inserted under its
    key on every append, so dict order is activity order and the jobs popped
    at the cap are the ones longest silent."""
    ev = {"ts": time.time(), "kind": kind, **fields}
    with _EVENTS_LOCK:
        ring = _EVENTS.pop(job_id, None)
        if ring is None:
            ring = []
        ring.append(ev)
        del ring[:-_EVENTS_PER_JOB]
        _EVENTS[job_id] = ring  # re-insert: now the most recently active
        while len(_EVENTS) > _EVENTS_MAX_JOBS:
            _EVENTS.pop(next(iter(_EVENTS)))
        sinks = list(_SINKS)
    for sink in sinks:
        try:
            sink(job_id, ev)
        except Exception:
            pass  # a tee must never fail the event path
    return ev


def add_sink(fn) -> None:
    """Register a ``fn(job_id, event_dict)`` tee on every recorded event."""
    with _EVENTS_LOCK:
        if fn not in _SINKS:
            _SINKS.append(fn)


def remove_sink(fn) -> None:
    with _EVENTS_LOCK:
        if fn in _SINKS:
            _SINKS.remove(fn)


def job_events(job_id: Optional[str] = None,
               limit: int = 32) -> "Dict[str, List[Dict[str, Any]]] | List[Dict[str, Any]]":
    """Recorded events: one job's (a list, newest last) or every job's
    (job id -> list). Snapshots, safe to mutate."""
    with _EVENTS_LOCK:
        if job_id is not None:
            return list(_EVENTS.get(job_id, []))[-limit:]
        return {j: list(evs)[-limit:] for j, evs in _EVENTS.items()}


def clear_events(job_id: Optional[str] = None) -> None:
    with _EVENTS_LOCK:
        if job_id is None:
            _EVENTS.clear()
        else:
            _EVENTS.pop(job_id, None)


class JobLogger(logging.LoggerAdapter):
    """Logger whose every message is prefixed with the owning job's id."""

    def __init__(self, job_id: str, logger: logging.Logger | None = None) -> None:
        super().__init__(logger or server_log, {"job_id": job_id})
        self.job_id = job_id

    def process(self, msg, kwargs):
        return f"[JobId: {self.job_id}] {msg}", kwargs

    def event(self, kind: str, **fields: Any) -> Dict[str, Any]:
        """A structured event and its operator-log line in one call (nothing
        important is ever ONLY in free text)."""
        self.info("%s %s", kind,
                  " ".join(f"{k}={v!r}" for k, v in sorted(fields.items())))
        return record_event(self.job_id, kind, **fields)


def job_logger(job_id: str) -> JobLogger:
    """The per-job logger factory."""
    return JobLogger(job_id)
