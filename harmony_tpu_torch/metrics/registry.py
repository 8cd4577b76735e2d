"""Typed instrument registry with Prometheus text exposition.

Counterpart of ``harmony_tpu/metrics/registry.py``, a copy of its pure-Python
code (the port imports nothing of the JAX package):

  * typed, labeled instruments — :class:`Counter` (monotone),
    :class:`Gauge` (set/inc/dec), :class:`Histogram` (fixed boundaries,
    cumulative buckets) — created through a process-wide
    :class:`MetricRegistry`;
  * get-or-create semantics (``registry.counter(name, ...)`` twice
    returns the same family; a kind/label mismatch is a bug and raises),
    so call sites need no shared setup;
  * callback instruments (:meth:`MetricRegistry.register_callback`) for
    values that live elsewhere and are sampled at scrape time (the tenant
    ledger's and the phase budget's gauges);
  * Prometheus text-format rendering (:meth:`MetricRegistry.expose`) —
    ``# HELP`` / ``# TYPE`` lines, escaped label values, cumulative
    ``le`` buckets with ``+Inf``, ``_sum``/``_count`` — the same bytes as
    the reference's for the same operations;
  * a grammar linter (:func:`lint_exposition`) + parser
    (:func:`parse_exposition`) so a tier-1 test can hold the text to the
    format contract.

Dependency-free on purpose: instrumented modules (checkpoint, blockmove,
the worker's drain) import this from anywhere without cycles.
``metrics/exporter.py`` serves :meth:`MetricRegistry.expose` at
``GET /metrics``.

Conventions: metric names are namespaced ``harmony_*``; counters end in
``_total``; label keys are ``job``, ``attempt`` (the ``job@aN`` elastic
attempt key), ``worker``, ``op``, ``transport`` ...; the constant ``pid``
label (this process's OS pid) is stamped on every sample at exposition
time so one scrape target per process stays distinguishable in aggregated
views.
"""
from __future__ import annotations

import bisect
import math
import os
import re
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "STEP_TIME_BUCKETS",
    "EPOCH_TIME_BUCKETS",
    "TRANSFER_SIZE_BUCKETS",
    "get_registry",
    "set_registry",
    "lint_exposition",
    "parse_exposition",
]

#: Fixed step-time boundaries (seconds): sub-ms CPU toy steps through
#: multi-second pod steps — chosen once so histograms stay mergeable
#: across processes and PRs (changing boundaries orphans history).
STEP_TIME_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

#: Fixed epoch-wall-time boundaries (seconds): toy CPU epochs through
#: hour-scale production epochs — the step-time boundaries top out at
#: 30s and would collapse every real epoch into +Inf.
EPOCH_TIME_BUCKETS: Tuple[float, ...] = (
    0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 900.0, 3600.0,
)

#: Fixed transfer-size boundaries (bytes): one cache line of metadata up
#: through GB-scale block migrations.
TRANSFER_SIZE_BUCKETS: Tuple[float, ...] = (
    1024.0, 16384.0, 262144.0, 1048576.0, 4194304.0, 16777216.0,
    67108864.0, 268435456.0, 1073741824.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(v: float) -> str:
    if v != v:  # the spec spelling — repr's 'nan' is unscrapeable
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(pairs: Sequence[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in pairs
    )
    return "{" + inner + "}"


class _Child:
    """One (labelset, value) cell of a metric family."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Sequence[float]) -> None:
        self._lock = threading.Lock()
        self._bounds = list(bounds)
        self._counts = [0] * (len(self._bounds) + 1)  # + the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._counts[bisect.bisect_left(self._bounds, v)] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count


class _Family:
    """A named metric + its labeled children. ``labels(**kv)`` returns
    (creating on first use) the child for one label-value set; families
    with no labelnames expose the value ops directly for convenience."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln == "le":
                raise ValueError(f"invalid label name {ln!r} for {name}")
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.buckets = (tuple(sorted(float(b) for b in buckets))
                        if buckets is not None else None)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}

    def _new_child(self):
        if self.kind == "counter":
            return _CounterChild()
        if self.kind == "gauge":
            return _GaugeChild()
        return _HistogramChild(self.buckets or STEP_TIME_BUCKETS)

    def labels(self, **kv: Any):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}"
            )
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    # no-label convenience: family IS the single child
    def _solo(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels()"
            )
        return self.labels()

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    @property
    def value(self) -> float:
        return self._solo().value

    def children(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return list(self._children.items())


class Counter(_Family):
    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, "counter", labelnames)


class Gauge(_Family):
    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, "gauge", labelnames)


class Histogram(_Family):
    def __init__(self, name, help="", labelnames=(), buckets=None):
        super().__init__(name, help, "histogram", labelnames,
                         buckets=buckets or STEP_TIME_BUCKETS)


class MetricRegistry:
    """Process-wide instrument store + Prometheus text renderer."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        #: name -> (help, kind, fn) sampled at expose time; fn returns a
        #: number (no labels) or an iterable of (labels_dict, number)
        self._callbacks: Dict[str, Tuple[str, str, Callable[[], Any]]] = {}

    # -- get-or-create ---------------------------------------------------

    def _get_or_create(self, name: str, help: str, kind: str,
                       labelnames: Sequence[str],
                       buckets: Optional[Sequence[float]] = None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name} re-registered as {kind}"
                        f"{tuple(labelnames)} (was {fam.kind}"
                        f"{fam.labelnames})"
                    )
                return fam
            if name in self._callbacks:
                raise ValueError(f"metric {name} is a callback instrument")
            if kind == "counter":
                fam = Counter(name, help, labelnames)
            elif kind == "gauge":
                fam = Gauge(name, help, labelnames)
            else:
                fam = Histogram(name, help, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(name, help, "counter", labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(name, help, "gauge", labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(name, help, "histogram", labelnames,
                                   buckets)

    def register_callback(self, name: str, help: str = "",
                          kind: str = "gauge",
                          fn: Optional[Callable[[], Any]] = None) -> None:
        """Sample-at-scrape instrument for state owned elsewhere. ``fn``
        returns a number, or an iterable of ``(labels_dict, number)``.
        Re-registering the same name replaces the callback (idempotent
        wiring from re-created servers)."""
        if fn is None:
            raise ValueError("register_callback needs fn")
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        if kind not in ("gauge", "counter"):
            raise ValueError("callback instruments are gauge or counter")
        with self._lock:
            if name in self._families:
                raise ValueError(f"metric {name} already registered")
            self._callbacks[name] = (help, kind, fn)

    # -- exposition ------------------------------------------------------

    def expose(self) -> str:
        """Prometheus text format (version 0.0.4) of every instrument.
        The constant ``pid`` label is stamped here — never stored — so
        forked children render their own pid."""
        pid = str(os.getpid())
        out: List[str] = []
        with self._lock:
            families = sorted(self._families.items())
            callbacks = sorted(self._callbacks.items())
        for name, fam in families:
            out.append(f"# HELP {name} {_escape_help(fam.help)}")
            out.append(f"# TYPE {name} {fam.kind}")
            for key, child in sorted(fam.children()):
                base = list(zip(fam.labelnames, key)) + [("pid", pid)]
                if fam.kind == "histogram":
                    counts, total, n = child.snapshot()
                    cum = 0
                    for bound, c in zip(fam.buckets, counts):
                        cum += c
                        pairs = base + [("le", _format_value(float(bound)))]
                        out.append(
                            f"{name}_bucket{_label_str(pairs)} {cum}")
                    cum += counts[-1]
                    pairs = base + [("le", "+Inf")]
                    out.append(f"{name}_bucket{_label_str(pairs)} {cum}")
                    out.append(
                        f"{name}_sum{_label_str(base)} "
                        f"{_format_value(total)}")
                    out.append(f"{name}_count{_label_str(base)} {n}")
                else:
                    out.append(
                        f"{name}{_label_str(base)} "
                        f"{_format_value(child.value)}")
        for name, (help, kind, fn) in callbacks:
            try:
                sampled = fn()
            except Exception:
                continue  # a broken callback must not break the scrape
            out.append(f"# HELP {name} {_escape_help(help)}")
            out.append(f"# TYPE {name} {kind}")
            if isinstance(sampled, (int, float)):
                samples: Iterable[Tuple[Dict[str, Any], float]] = (
                    ({}, float(sampled)),)
            else:
                samples = sampled
            for labels, value in samples:
                pairs = sorted((str(k), str(v)) for k, v in labels.items())
                pairs.append(("pid", pid))
                out.append(
                    f"{name}{_label_str(pairs)} "
                    f"{_format_value(float(value))}")
        return "\n".join(out) + "\n"


# -- process-wide default registry ----------------------------------------

_registry_lock = threading.Lock()
_registry: Optional[MetricRegistry] = None
_START_TIME = time.time()


def get_registry() -> MetricRegistry:
    """The process-wide registry, created (with the built-in process
    collectors) on first use."""
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = MetricRegistry()
            _install_process_collectors(_registry)
        return _registry


def set_registry(registry: MetricRegistry) -> MetricRegistry:
    """Swap the process registry (tests). Returns the new one."""
    global _registry
    with _registry_lock:
        _registry = registry
    return registry


def _install_process_collectors(reg: MetricRegistry) -> None:
    reg.register_callback(
        "harmony_process_start_time_seconds",
        "Unix time this process's registry came up",
        "gauge", lambda: _START_TIME,
    )
    reg.register_callback(
        "harmony_process_uptime_seconds",
        "Seconds since this process's registry came up",
        "gauge", lambda: time.time() - _START_TIME,
    )

    # the reference's third collector, harmony_flight_dumps_total, samples
    # the flight recorder, which comes with tracing (ROADMAP A item 6.4)


# -- exposition grammar lint (the tier-1 format contract) -----------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?"
    r" (?P<value>[-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))"
    r"(?: [0-9]+)?$"
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\["\\n])*)"'
)


def parse_exposition(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse text exposition into
    ``{family: {"type", "help", "samples": [(name, labels, value)]}}``.
    Raises ValueError on grammar violations (the strictness IS the
    point — see :func:`lint_exposition` for the error-listing variant).
    """
    families: Dict[str, Dict[str, Any]] = {}

    def family_of(sample_name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            base = sample_name[: -len(suffix)] if sample_name.endswith(
                suffix) else None
            if base and base in families \
                    and families[base]["type"] == "histogram":
                return base
        return sample_name

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 3:
                raise ValueError(f"line {lineno}: malformed HELP")
            families.setdefault(
                parts[2], {"type": None, "help": None, "samples": []}
            )["help"] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {lineno}: malformed TYPE")
            fam = families.setdefault(
                parts[2], {"type": None, "help": None, "samples": []})
            if fam["type"] is not None:
                raise ValueError(f"line {lineno}: duplicate TYPE {parts[2]}")
            fam["type"] = parts[3]
            continue
        if line.startswith("#"):
            continue  # comments are legal
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: unparseable sample {line!r}")
        name = m.group("name")
        labels: Dict[str, str] = {}
        raw = m.group("labels")
        if raw:
            body = raw[1:-1]
            consumed = 0
            for pm in _LABEL_PAIR_RE.finditer(body):
                labels[pm.group(1)] = pm.group(2)
                consumed = pm.end()
            rest = body[consumed:].strip().strip(",")
            if rest:
                raise ValueError(
                    f"line {lineno}: bad label syntax near {rest!r}")
        fam_name = family_of(name)
        if fam_name not in families or families[fam_name]["type"] is None:
            raise ValueError(
                f"line {lineno}: sample {name} has no preceding TYPE")
        value = float(m.group("value").replace("Inf", "inf"))
        families[fam_name]["samples"].append((name, labels, value))
    return families


def lint_exposition(text: str) -> List[str]:
    """Validate exposition grammar + semantic rules; returns the list of
    problems (empty = clean). Checked: parseability, HELP/TYPE presence,
    histogram bucket monotonicity and the ``+Inf``/``_count`` identity,
    non-negative counters, and the ``_total`` counter naming convention
    for ``harmony_*`` metrics."""
    problems: List[str] = []
    try:
        families = parse_exposition(text)
    except ValueError as e:
        return [str(e)]
    if not text.endswith("\n"):
        problems.append("exposition must end with a newline")
    for name, fam in sorted(families.items()):
        if fam["type"] is None:
            problems.append(f"{name}: no TYPE line")
            continue
        if fam["help"] is None:
            problems.append(f"{name}: no HELP line")
        if (fam["type"] == "counter" and name.startswith("harmony_")
                and not name.endswith("_total")):
            problems.append(f"{name}: harmony_* counters must end _total")
        if fam["type"] == "counter":
            for sname, labels, value in fam["samples"]:
                if value < 0:
                    problems.append(f"{sname}{labels}: negative counter")
        if fam["type"] == "histogram":
            series: Dict[Tuple[Tuple[str, str], ...], Dict[str, Any]] = {}
            for sname, labels, value in fam["samples"]:
                key = tuple(sorted(
                    (k, v) for k, v in labels.items() if k != "le"))
                st = series.setdefault(
                    key, {"buckets": [], "count": None, "sum": None})
                if sname == f"{name}_bucket":
                    if "le" not in labels:
                        problems.append(f"{sname}: bucket without le")
                        continue
                    le = labels["le"]
                    st["buckets"].append(
                        (math.inf if le == "+Inf" else float(le), value))
                elif sname == f"{name}_count":
                    st["count"] = value
                elif sname == f"{name}_sum":
                    st["sum"] = value
            for key, st in series.items():
                buckets = sorted(st["buckets"])
                if not buckets or buckets[-1][0] != math.inf:
                    problems.append(f"{name}{dict(key)}: no +Inf bucket")
                    continue
                cum = [c for _, c in buckets]
                if any(b > a for a, b in zip(cum[1:], cum)):
                    problems.append(
                        f"{name}{dict(key)}: buckets not cumulative")
                if st["count"] is None or st["sum"] is None:
                    problems.append(f"{name}{dict(key)}: missing _count/_sum")
                elif st["count"] != buckets[-1][1]:
                    problems.append(
                        f"{name}{dict(key)}: _count != +Inf bucket")
    return problems


def counters_monotone(before: str, after: str) -> List[str]:
    """Cross-scrape monotonicity check for the lint test: every counter
    sample present in ``before`` must be <= its value in ``after``.
    Returns violations (empty = monotone)."""
    problems: List[str] = []
    fam_b = parse_exposition(before)
    fam_a = parse_exposition(after)
    for name, fam in fam_b.items():
        if fam["type"] != "counter" or name not in fam_a:
            continue
        after_vals = {
            (sname, tuple(sorted(labels.items()))): value
            for sname, labels, value in fam_a[name]["samples"]
        }
        for sname, labels, value in fam["samples"]:
            key = (sname, tuple(sorted(labels.items())))
            if key in after_vals and after_vals[key] < value:
                problems.append(
                    f"{sname}{labels}: {value} -> {after_vals[key]}")
    return problems
