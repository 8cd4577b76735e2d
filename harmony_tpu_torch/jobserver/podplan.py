"""Pod-wide reconfiguration plans, applied at deterministic epoch points.

Plan-driven migration on a RUNNING pod job (ref: the driver-initiated
MoveInitMsg flow, MigrationExecutor.java:107-253) cannot run from an
orchestrator thread the way single-process jobs do: a reshard is a
collective transfer, and one process dispatching it off-schedule wedges
the pod. Instead the leader broadcasts the plan over the control plane
(PodJobServer.schedule_pod_reshard) and EVERY process applies the same
move at the same LOGICAL point — the chief worker's epoch hook, which
lockstep guarantees fires at identical epochs everywhere. This module is
the per-process registry between the control plane and the hook.

A copy of ``harmony_tpu/jobserver/podplan.py`` (which imports no JAX; the
port keeps its own copy). The port's pod answers ``POD_RESHARD`` with an
error and nothing applies these plans yet: the reshard's transports and the
chief's epoch hook wait for ROADMAP A item 3b. The pod server clears a
job's entry when the job ends, as the reference's does.

Scheduling contract: the apply epoch must be comfortably ahead of the
job's current epoch on every process — a plan landing mid-epoch-E while
some processes already passed their epoch-E hook would be applied at
different epochs (divergent meshes, wedged collectives). Plans applied
late (first hook at epoch > plan epoch) are applied immediately and
consistently ONLY when the message arrived before any process crossed
the plan epoch; give multi-epoch lead.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List

_LOCK = threading.Lock()
_PLANS: Dict[str, List[Dict[str, Any]]] = {}


def schedule(job_id: str, plan: Dict[str, Any]) -> None:
    """Register a plan: {"epoch": int, "src": executor_id,
    "dst": executor_id, "num_blocks": int}."""
    with _LOCK:
        _PLANS.setdefault(job_id, []).append(dict(plan))


def take(job_id: str, epoch_idx: int) -> List[Dict[str, Any]]:
    """Pop (in schedule order) every plan whose epoch is due at
    ``epoch_idx`` — called from the chief worker's epoch hook."""
    with _LOCK:
        plans = _PLANS.get(job_id)
        if not plans:
            return []
        due = [p for p in plans if int(p.get("epoch", 0)) <= epoch_idx]
        _PLANS[job_id] = [p for p in plans if p not in due]
        return due


def next_epoch(job_id: str) -> "int | None":
    """Smallest scheduled (not yet taken) plan epoch for the job — the
    worker's window clamp (see WorkerTasklet.pending_plan_epoch)."""
    with _LOCK:
        plans = _PLANS.get(job_id)
        if not plans:
            return None
        return min(int(p.get("epoch", 0)) for p in plans)


def clear(job_id: str) -> None:
    with _LOCK:
        _PLANS.pop(job_id, None)
