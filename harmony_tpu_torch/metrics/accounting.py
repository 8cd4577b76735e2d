"""Per-tenant device cost accounting — the ledger behind ``obs top``.

Counterpart of ``harmony_tpu/metrics/accounting.py``, a copy of its store
with the reference's field names. A multi-tenant scheduler cannot close any
policy loop without knowing what each tenant COSTS on the device and
whether it is meeting its target rate. This module is that join: a
process-wide ledger of per-``job@attempt`` cost vectors, fed from the
worker (cheaply: one call per epoch drain, never per batch, on numbers the
drain already has) and read by ``MetricManager.tenant_ledger()``, the
STATUS payload, the registry's callback gauges and ``obs top``.

The vector per tenant:

* **device-compute seconds** — the measured dispatch+device time of the
  tenant's steps (the same smeared per-batch seconds BatchMetrics
  carries), windowed and cumulative;
* **model FLOPs** — None here, never 0.0: the reference multiplies the
  compiled step's ``cost_analysis()`` FLOPs by the steps run, and nothing
  in this package compiles a program to count (ROADMAP A item 6.5). The
  reference leaves the field None in exactly that case;
* **achieved MFU** — windowed model FLOPs / device seconds / (peak bf16
  FLOP/s × devices), peak from ``utils.platform.peak_bf16_flops``. None
  unless BOTH the FLOP count and the card's peak are known, so None
  throughout until item 6.5;
* **resident device bytes** — table storage + the worker's
  device-resident input copies (its devcache contributions). The
  reference's third component, a compiled program's temp/code bytes
  (``program``), has nothing to size here;
* **input-wait fraction** — prefetch consumer-stall seconds over
  (stall + device) seconds, windowed;
* **blockmove / checkpoint bytes** — per-job state-movement traffic;
* **SLO attainment** — windowed samples/sec over the job's
  ``target_samples_per_sec`` (None when no target is set).

Windowing: feeds are timestamped; ``snapshot()`` aggregates the last
``HARMONY_LEDGER_WINDOW`` seconds (default 300) so the vector tracks
CURRENT behavior, with cumulative totals kept beside it. Everything is
guarded get-or-create and lock-cheap: accounting must never fail (or
meaningfully slow) a training step, and it never reads the card.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

ENV_WINDOW = "HARMONY_LEDGER_WINDOW"
ENV_SLO = "HARMONY_SLO_SPS"

#: feed samples kept per tenant — at one feed per epoch drain this
#: covers days of a long job while bounding a pathological feeder
_MAX_SAMPLES = 4096


def window_seconds() -> float:
    """The ledger window (seconds). Operators tune it to their scrape
    cadence; the default covers several epochs of every bench app."""
    try:
        return max(1.0, float(os.environ.get(ENV_WINDOW, "") or 300.0))
    except ValueError:
        return 300.0


def slo_target_from_env() -> Optional[float]:
    """``HARMONY_SLO_SPS``: process-wide samples/sec target overriding
    ``TrainerParams.target_samples_per_sec`` for every job — the
    operator knob for fleet-wide floor enforcement. None = unset/bad."""
    raw = os.environ.get(ENV_SLO)
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if v > 0 else None


class _Tenant:
    """Mutable per-job ledger state. All mutation happens under the
    store lock (feeds are epoch-cadence, not per batch)."""

    __slots__ = ("job", "attempt", "workers", "devices", "samples",
                 "steps_total", "device_sec_total", "examples_total",
                 "flops_per_step", "resident", "bytes", "target_sps",
                 "slo_events", "first_ts", "last_ts", "async_state",
                 "serving_state")

    def __init__(self, job: str) -> None:
        self.job = job
        self.attempt = job
        self.workers: set = set()
        self.devices = 1
        #: (ts, steps, device_sec, examples, flops, input_wait_sec)
        self.samples: deque = deque(maxlen=_MAX_SAMPLES)
        self.steps_total = 0
        self.device_sec_total = 0.0
        self.examples_total = 0
        self.flops_per_step: Optional[float] = None
        self.resident: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}
        self.target_sps: Optional[float] = None
        self.slo_events = 0
        self.first_ts: Optional[float] = None
        self.last_ts: Optional[float] = None
        #: bounded-staleness async lever state (set_async_state): None
        #: until the worker reports; availability is what the policy
        #: engine keys its `async` proposal on
        self.async_state: Optional[Dict[str, Any]] = None
        #: online-serving state (set_serving_state): None until the
        #: serving plane reports this tenant; the p99-vs-SLO pair is
        #: what `obs top`, the doctor's serving_slo_breach rule and the
        #: policy engine's `protect` action all key on
        self.serving_state: Optional[Dict[str, Any]] = None


class LedgerStore:
    """Process-wide tenant ledger; see the module docstring."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tenants: Dict[str, _Tenant] = {}
        self._tables: Dict[str, str] = {}  # table_id -> job

    def _tenant(self, job: str, attempt: Optional[str] = None) -> _Tenant:
        t = self._tenants.get(job)
        if t is None:
            t = self._tenants[job] = _Tenant(job)
        if attempt:
            t.attempt = attempt
        return t

    # -- feeds (worker / checkpoint / blockmove side) --------------------

    def observe_steps(self, job: str, attempt: str, worker: str,
                      steps: int, device_sec: float, examples: int,
                      flops_per_step: Optional[float] = None,
                      input_wait_sec: float = 0.0,
                      devices: int = 1) -> None:
        """One dispatch window's worth of steps (the worker calls this
        from its epoch-end drain, once per epoch — never per batch)."""
        now = time.monotonic()
        with self._lock:
            t = self._tenant(job, attempt)
            t.workers.add(worker)
            # last-wins, not max(): after an elastic shrink the MFU
            # denominator must track the LIVE mesh, not the widest one
            # the job ever held
            t.devices = int(devices) or 1
            if flops_per_step is not None:
                t.flops_per_step = float(flops_per_step)
            t.samples.append((now, int(steps), float(device_sec),
                              int(examples),
                              None if flops_per_step is None
                              else float(flops_per_step) * int(steps),
                              float(input_wait_sec)))
            t.steps_total += int(steps)
            t.device_sec_total += float(device_sec)
            t.examples_total += int(examples)
            if t.first_ts is None:
                t.first_ts = now
            t.last_ts = now

    def record_input_wait(self, job: str, attempt: str,
                          seconds: float) -> None:
        """Prefetch consumer-stall seconds for one epoch (dolphin/
        prefetch.py's InputPipelineMetrics, attributed per tenant)."""
        now = time.monotonic()
        with self._lock:
            t = self._tenant(job, attempt)
            t.samples.append((now, 0, 0.0, 0, None, float(seconds)))

    def set_resident(self, job: str, attempt: str, component: str,
                     nbytes: int) -> None:
        """Overwrite one resident-HBM component (``table`` / ``input``; the
        reference also sizes ``program``): these are occupancy gauges, not
        flows."""
        with self._lock:
            self._tenant(job, attempt).resident[component] = int(nbytes)

    def set_slo_target(self, job: str, attempt: str,
                       sps: Optional[float]) -> None:
        with self._lock:
            self._tenant(job, attempt).target_sps = (
                float(sps) if sps else None)

    def record_slo_event(self, job: str) -> None:
        with self._lock:
            self._tenant(job).slo_events += 1

    def set_async_state(self, job: str, attempt: str, *, available: bool,
                        enabled: bool, bound: int = 0, max_lag: int = 0,
                        exposed_wait_sec: float = 0.0,
                        overlapped_comm_sec: float = 0.0) -> None:
        """Bounded-staleness async lever state (dolphin worker, once per
        epoch drain). ``available`` says the lever EXISTS for this
        tenant's (table, trainer, layout) — the policy engine proposes
        `async` only for available-but-disabled comm-bound tenants;
        the staleness telemetry shows overlapped vs exposed comm time
        when the mode is on."""
        with self._lock:
            self._tenant(job, attempt).async_state = {
                "available": bool(available),
                "enabled": bool(enabled),
                "staleness_bound": int(bound),
                "max_lag": int(max_lag),
                "exposed_wait_sec": round(float(exposed_wait_sec), 6),
                "overlapped_comm_sec": round(float(overlapped_comm_sec), 6),
            }

    def set_serving_state(self, job: str, attempt: Optional[str] = None,
                          *, enabled: bool,
                          qps: Optional[float] = None,
                          p50_ms: Optional[float] = None,
                          p99_ms: Optional[float] = None,
                          slo_p99_ms: Optional[float] = None,
                          batch_occupancy: Optional[float] = None,
                          cache_hit_rate: Optional[float] = None) -> None:
        """Online-serving telemetry for one tenant (the ServingEndpoint's
        windowed flush — summarized, never per request). None fields are
        UNKNOWN, kept as None all the way to `obs top`'s `-` rendering;
        ``attempt`` is optional because the serving plane addresses jobs,
        not attempts — omitted, the tenant's live attempt stands."""

        def _f(v: Optional[float]) -> Optional[float]:
            return None if v is None else round(float(v), 4)

        with self._lock:
            self._tenant(job, attempt).serving_state = {
                "enabled": bool(enabled),
                "qps": _f(qps),
                "p50_ms": _f(p50_ms),
                "p99_ms": _f(p99_ms),
                "slo_p99_ms": _f(slo_p99_ms),
                "batch_occupancy": _f(batch_occupancy),
                "cache_hit_rate": _f(cache_hit_rate),
            }

    def bind_table(self, table_id: str, job: str, attempt: str) -> None:
        """Name ``job`` as the owner of ``table_id`` so table-scoped byte
        streams (block migrations) resolve to a tenant. Last bind wins —
        exactly the live-attempt semantics elastic recovery needs."""
        with self._lock:
            self._tables[table_id] = job
            self._tenant(job, attempt)

    def record_table_bytes(self, table_id: str, kind: str,
                           nbytes: int) -> None:
        """Byte flow attributed through a table binding; unbound tables
        (no tenant ever claimed them) are dropped on the floor rather
        than invented into a tenant."""
        if nbytes <= 0:
            return
        with self._lock:
            job = self._tables.get(table_id)
            if job is None:
                return
            t = self._tenant(job)
            t.bytes[kind] = t.bytes.get(kind, 0) + int(nbytes)

    def record_job_bytes(self, job: str, kind: str, nbytes: int) -> None:
        """Byte flow already attributed (the per-job CheckpointManager)."""
        if nbytes <= 0:
            return
        with self._lock:
            t = self._tenant(job)
            t.bytes[kind] = t.bytes.get(kind, 0) + int(nbytes)

    # -- queries ---------------------------------------------------------

    def snapshot(self, window_sec: Optional[float] = None
                 ) -> Dict[str, Dict[str, Any]]:
        """The per-tenant cost vectors (see module docstring). Pure
        read; every number is JSON-serializable (STATUS rides it
        verbatim). ``hbm_share`` is each tenant's resident bytes over
        the sum across tenants (1.0 for a sole tenant)."""
        w = window_sec if window_sec is not None else window_seconds()
        now = time.monotonic()
        cutoff = now - w
        peak = _peak_flops()
        with self._lock:
            tenants = list(self._tenants.values())
            rows: Dict[str, Dict[str, Any]] = {}
            for t in tenants:
                steps = 0
                dev = 0.0
                examples = 0
                flops: Optional[float] = None
                wait = 0.0
                t0: Optional[float] = None
                for (ts, s, d, n, f, iw) in t.samples:
                    if ts < cutoff:
                        continue
                    if t0 is None:
                        t0 = ts
                    steps += s
                    dev += d
                    examples += n
                    wait += iw
                    if f is not None:
                        flops = (flops or 0.0) + f
                # wall span of the windowed samples; floored at the
                # measured busy (device + input-wait) seconds — PER
                # WORKER, since sibling workers' busy seconds overlap in
                # wall time — so a single just-landed feed, whose
                # first-ts-to-now gap is microseconds, cannot imply an
                # absurd rate, and a multi-worker tenant's rate is not
                # deflated by the workers' summed busy time
                elapsed = None
                if t0 is not None:
                    elapsed = max(now - t0,
                                  (dev + wait) / max(len(t.workers), 1))
                sps = (examples / elapsed
                       if elapsed and elapsed > 0 else None)
                mfu = None
                if (flops is not None and dev > 0 and peak):
                    mfu = flops / dev / (peak * max(t.devices, 1))
                wait_frac = (wait / (wait + dev)
                             if (wait + dev) > 0 else None)
                target = t.target_sps
                attain = (sps / target
                          if (target and sps is not None) else None)
                resident = sum(t.resident.values())
                rows[t.job] = {
                    "job": t.job,
                    "attempt": t.attempt,
                    "workers": len(t.workers),
                    "devices": t.devices,
                    "window_sec": w,
                    "steps": steps,
                    "examples": examples,
                    "device_seconds": round(dev, 6),
                    "device_seconds_total": round(t.device_sec_total, 6),
                    "steps_total": t.steps_total,
                    "examples_total": t.examples_total,
                    "samples_per_sec": (round(sps, 3)
                                        if sps is not None else None),
                    "flops_per_step": t.flops_per_step,
                    "model_flops": flops,
                    "mfu": mfu,
                    "peak_flops": peak,
                    "resident_bytes": resident,
                    "resident": dict(t.resident),
                    "input_wait_frac": (round(wait_frac, 4)
                                        if wait_frac is not None else None),
                    "bytes": dict(t.bytes),
                    "slo": {
                        "target_sps": target,
                        "attainment": (round(attain, 4)
                                       if attain is not None else None),
                        "events": t.slo_events,
                    },
                    "async": (dict(t.async_state)
                              if t.async_state is not None else None),
                    "serving": (dict(t.serving_state)
                                if t.serving_state is not None else None),
                }
        total_resident = sum(r["resident_bytes"] for r in rows.values())
        for r in rows.values():
            r["hbm_share"] = (
                round(r["resident_bytes"] / total_resident, 4)
                if total_resident > 0 else None)
        return rows

    def clear(self) -> None:
        with self._lock:
            self._tenants.clear()
            self._tables.clear()


def _peak_flops() -> Optional[float]:
    """The card's dense peak bf16 FLOP/s, or None off the card or for a card
    the table does not name. Guarded: the ledger must stay queryable on a
    host with no accelerator stack at all."""
    try:
        from harmony_tpu_torch.utils.platform import peak_bf16_flops

        return peak_bf16_flops()
    except Exception:
        return None


# -- process-wide store ----------------------------------------------------

_store_lock = threading.Lock()
_store: Optional[LedgerStore] = None


def ledger() -> LedgerStore:
    """The process ledger, created (and its /metrics callback gauges
    registered) on first use."""
    global _store
    with _store_lock:
        if _store is None:
            _store = LedgerStore()
            _install_callbacks(_store)
        return _store


def peek_ledger() -> Optional[LedgerStore]:
    """The ledger if one exists — never creates (crash-path consumers
    like the flight recorder must not instantiate accounting state as a
    side effect of dying)."""
    with _store_lock:
        return _store


def reset_ledger() -> None:
    """Drop the process ledger (tests). The registry callbacks re-bind
    to whatever store exists at sample time, so no re-install needed."""
    global _store
    with _store_lock:
        _store = None


def _install_callbacks(store: LedgerStore) -> None:
    """Labeled callback gauges sampled at scrape time — the exposition
    face of the ledger. Registration failure (or re-registration in an
    embedding process) must never fail ledger creation."""
    try:
        from harmony_tpu_torch.metrics.registry import get_registry

        reg = get_registry()
    except Exception:
        return

    # one scrape samples SEVEN families; without a memo each callback
    # would re-walk the whole store (and contend its lock with the
    # worker's epoch-drain feeds) for identical data
    memo = {"ts": 0.0, "rows": {}}
    memo_lock = threading.Lock()

    def rows():
        s = _store
        if s is None:
            return {}
        now = time.monotonic()
        with memo_lock:
            if now - memo["ts"] > 0.2:
                memo["rows"] = s.snapshot()
                memo["ts"] = now
            return memo["rows"]

    def gauge_of(field, sub=None):
        def sample():
            out = []
            for r in rows().values():
                v = r[field] if sub is None else r[field][sub]
                if v is None:
                    continue  # None is "unknown", not 0 — omit the sample
                out.append(({"job": r["job"], "attempt": r["attempt"]},
                            float(v)))
            return out
        return sample

    def bytes_samples():
        out = []
        for r in rows().values():
            for kind, n in r["bytes"].items():
                out.append(({"job": r["job"], "attempt": r["attempt"],
                             "kind": kind}, float(n)))
        return out

    def async_of(sub):
        # not gauge_of: the "async" row is None until the worker
        # reports, and the staleness series only mean anything with the
        # mode actually ON — absent otherwise, never 0
        def sample():
            out = []
            for r in rows().values():
                a = r.get("async")
                if not a or not a.get("enabled"):
                    continue
                out.append(({"job": r["job"], "attempt": r["attempt"]},
                            float(a[sub])))
            return out
        return sample

    def serving_of(sub):
        # not gauge_of: the "serving" row is None until the serving
        # plane reports, and a reported-None field (no traffic in the
        # window) stays absent, never 0
        def sample():
            out = []
            for r in rows().values():
                s = r.get("serving")
                if not s or not s.get("enabled") or s.get(sub) is None:
                    continue
                out.append(({"job": r["job"], "attempt": r["attempt"]},
                            float(s[sub])))
            return out
        return sample

    try:
        reg.register_callback(
            "harmony_tenant_mfu",
            "Windowed model-FLOP utilization vs peak bf16 (absent when "
            "the backend exposes no cost model or peak)",
            "gauge", gauge_of("mfu"))
        reg.register_callback(
            "harmony_tenant_device_seconds_total",
            "Cumulative device-compute seconds charged to this tenant",
            "counter", gauge_of("device_seconds_total"))
        reg.register_callback(
            "harmony_tenant_samples_per_sec",
            "Windowed achieved training samples/sec per tenant",
            "gauge", gauge_of("samples_per_sec"))
        reg.register_callback(
            "harmony_tenant_resident_bytes",
            "Resident device bytes attributed to this tenant (table + "
            "input copies + compiled-program temp/code)",
            "gauge", gauge_of("resident_bytes"))
        reg.register_callback(
            "harmony_tenant_input_wait_ratio",
            "Windowed fraction of tenant time spent waiting on input",
            "gauge", gauge_of("input_wait_frac"))
        reg.register_callback(
            "harmony_tenant_slo_attainment",
            "Windowed samples/sec over the tenant's target (absent "
            "without a target)",
            "gauge", gauge_of("slo", "attainment"))
        reg.register_callback(
            "harmony_tenant_state_bytes_total",
            "Cumulative state-movement bytes per tenant (kind: move / "
            "chkp_write / chkp_read)",
            "counter", bytes_samples)
        reg.register_callback(
            "harmony_tenant_staleness_lag",
            "Max applied-update lag observed by the tenant's async step "
            "(absent unless bounded-staleness async mode is on)",
            "gauge", async_of("max_lag"))
        reg.register_callback(
            "harmony_tenant_async_exposed_seconds",
            "Comm seconds the async step could NOT hide: staleness-gate "
            "wait blocking compute (absent unless async mode is on)",
            "gauge", async_of("exposed_wait_sec"))
        reg.register_callback(
            "harmony_tenant_serving_qps",
            "Windowed serving lookups/sec per tenant (absent unless the "
            "serving plane reports this tenant)",
            "gauge", serving_of("qps"))
        reg.register_callback(
            "harmony_tenant_serving_p99_ms",
            "Windowed serving p99 lookup latency in ms (absent unless "
            "the serving plane reports this tenant)",
            "gauge", serving_of("p99_ms"))
        reg.register_callback(
            "harmony_tenant_serving_cache_hit_rate",
            "Windowed serving hot-row cache hit rate (absent without "
            "cache traffic)",
            "gauge", serving_of("cache_hit_rate"))
    except Exception:
        pass  # already registered by an earlier store in this process
