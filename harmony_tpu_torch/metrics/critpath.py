"""Cross-worker critical-path attribution over the step-phase budget.

Counterpart of ``harmony_tpu/metrics/critpath.py``, a copy of its pure
functions. The straggler report (metrics/manager.py) names *who* gated an
epoch; this module names *why*: per epoch, which worker's wall gated the
epoch barrier and which phase dominated that worker's time — and per
tenant, a one-word bound classification a policy engine can branch on:
*scale out* helps a compute-bound tenant, *pack tighter* a comm-bound one,
and an input- or dispatch-bound tenant needs neither.

Input is the :class:`~harmony_tpu_torch.metrics.phases.PhaseBudgetStore`
snapshot (per-tenant phase seconds/fractions + per-epoch sibling walls).
Everything here is pure functions over those rows — the analyzer holds
no state, so STATUS and the CLI compute the same verdicts from the same
budget.

Classification thresholds (absolute fractions of the tenant's window
wall):

* ``input-bound``    — ``input_wait`` >= 0.4 (the device sits idle on
  input);
* ``comm-bound``     — ``pull_comm + push_comm`` >= 0.4;
* ``dispatch-bound`` — ``host_dispatch`` >= 0.3 (host placement between
  batch-ready and dispatch is the gate);
* ``compute-bound``  — ``compute`` >= 0.6 (the healthy-but-saturated
  verdict: more cards would genuinely help);
* ``balanced``       — none of the above dominates.

Precedence is the listed order: a tenant both input- and comm-bound is
input-bound (fix the earliest pipeline stage first).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from harmony_tpu_torch.metrics.phases import PHASES, RESIDUAL

#: classification thresholds (fractions of window wall)
INPUT_BOUND_FRAC = 0.4
COMM_BOUND_FRAC = 0.4
DISPATCH_BOUND_FRAC = 0.3
COMPUTE_BOUND_FRAC = 0.6

#: the device-work phases a critical-path entry may name as gating
_DEVICE_PHASES = ("pull_comm", "compute", "push_comm")


def comm_fraction(fractions: Dict[str, float]) -> float:
    """Combined model-traffic fraction (pull + push) of one budget."""
    return (float(fractions.get("pull_comm", 0.0))
            + float(fractions.get("push_comm", 0.0)))


def classify(fractions: Dict[str, float]) -> str:
    """One-word bound verdict from a budget's wall fractions; see the
    module docstring for thresholds and precedence."""
    if float(fractions.get("input_wait", 0.0)) >= INPUT_BOUND_FRAC:
        return "input-bound"
    if comm_fraction(fractions) >= COMM_BOUND_FRAC:
        return "comm-bound"
    if float(fractions.get("host_dispatch", 0.0)) >= DISPATCH_BOUND_FRAC:
        return "dispatch-bound"
    if float(fractions.get("compute", 0.0)) >= COMPUTE_BOUND_FRAC:
        return "compute-bound"
    return "balanced"


def dominant_phase(phases: Dict[str, float],
                   include_residual: bool = True) -> Optional[str]:
    """The largest phase of a budget (ties resolve in taxonomy order);
    None for an all-zero budget."""
    names = (*PHASES, RESIDUAL) if include_residual else PHASES
    best, best_v = None, 0.0
    for p in names:
        v = float(phases.get(p, 0.0))
        if v > best_v:
            best, best_v = p, v
    return best


def epoch_critical_path(row: Dict[str, Any],
                        limit: int = 16) -> List[Dict[str, Any]]:
    """Per windowed epoch: which worker gated the epoch barrier (the
    max sibling wall) and which phase dominated THAT worker's budget —
    the straggler report says who, this says why. Newest ``limit``
    epochs, oldest first. The gating phase is the worker's dominant
    phase with the residual excluded when any real phase is nonzero
    (an epoch gated by pure bookkeeping honestly reports residual)."""
    out: List[Dict[str, Any]] = []
    per_worker = row.get("per_worker") or {}
    walls = row.get("epoch_walls") or {}
    for ep in sorted(walls, key=lambda e: int(e))[-limit:]:
        ws = walls[ep]
        if not ws:
            continue
        gate = max(ws, key=lambda w: ws[w])
        wrow = per_worker.get(gate) or {}
        phases = wrow.get("phases") or {}
        phase = dominant_phase(phases, include_residual=False)
        if phase is None:
            phase = RESIDUAL
        out.append({"epoch": int(ep), "worker": gate,
                    "wall_sec": float(ws[gate]), "phase": phase})
    return out


def analyze(budget_rows: Dict[str, Dict[str, Any]],
            stragglers: Optional[Dict[str, Dict[str, Any]]] = None
            ) -> Dict[str, Dict[str, Any]]:
    """The full per-tenant attribution STATUS and the CLI render:
    each budget row enriched with ``classification``,
    ``dominant_phase``, ``comm_frac``, the per-epoch
    ``critical_path``, and the straggler ratio when the report knows
    one. Pure — same inputs, same verdicts, everywhere."""
    out: Dict[str, Dict[str, Any]] = {}
    for job, row in budget_rows.items():
        fr = row.get("fractions") or {}
        enriched = dict(row)
        enriched["classification"] = classify(fr)
        enriched["dominant_phase"] = dominant_phase(
            row.get("phases") or {})
        enriched["comm_frac"] = round(comm_fraction(fr), 6)
        enriched["critical_path"] = epoch_critical_path(row)
        if stragglers:
            rep = stragglers.get(job)
            enriched["straggler_ratio"] = (rep or {}).get("ratio")
        out[job] = enriched
    return out
