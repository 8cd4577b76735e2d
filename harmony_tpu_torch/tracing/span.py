"""Distributed tracing spans — the HTrace-equivalent.

A copy of ``harmony_tpu/tracing/span.py`` (the port's device profiling is
``torch.profiler``; the reference's ``tracing/profiler.py`` is not ported).

Parity with the reference's tracing wiring (SURVEY.md §5.1): HTrace 3.0.4
gives Harmony (a) process-wide SpanReceiver selection (utils/trace/
HTrace.java:30-56 + ReceiverConstructor: Zipkin or local-file), (b) span
creation around interesting operations, and (c) parent-span propagation
across process boundaries via avro-encoded TraceInfo
(HTraceInfoCodec/HTraceUtils, utils/src/main/avro/traceinfo.avsc).

Rebuilt here dependency-free:

  * ``Span`` — id, parent id, trace id, description, wall-clock start/stop,
    key-value annotations;
  * ``SpanReceiver`` SPI with ``InMemorySpanReceiver`` (tests/inspection)
    and ``LocalFileSpanReceiver`` (JSON-lines file — the local-file receiver
    analogue; Zipkin's wire model is the same shape, so an exporter is a
    receiver away);
  * ``trace_span`` context manager maintaining the current span in a
    contextvar (threads/asyncio safe — the analogue of HTrace's
    thread-local trace scope);
  * ``SpanContext.to_wire()/from_wire()`` — the TraceInfo codec analogue:
    a compact dict carried inside control-plane messages so master↔worker
    protocol spans keep their parents across the jobserver's TCP boundary.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional


@dataclasses.dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    description: str
    start_sec: float
    stop_sec: Optional[float] = None
    annotations: Dict[str, Any] = dataclasses.field(default_factory=dict)
    process_id: str = ""

    @property
    def duration_sec(self) -> float:
        return (self.stop_sec or time.time()) - self.start_sec

    def annotate(self, key: str, value: Any) -> None:
        self.annotations[key] = value

    def discard(self) -> None:
        """Mark the span to be dropped at context exit (e.g. the work it
        covers turned out not to have happened — an aborted epoch)."""
        self._discarded = True

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """What crosses a process/message boundary (ref: TraceInfo avro record:
    traceId + spanId are enough to re-parent remote child spans)."""

    trace_id: str
    span_id: str

    def to_wire(self) -> Dict[str, str]:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @staticmethod
    def from_wire(wire: Optional[Dict[str, str]]) -> Optional["SpanContext"]:
        if not wire:
            return None
        return SpanContext(wire["trace_id"], wire["span_id"])


class SpanReceiver:
    """SPI (ref: HTrace SpanReceiver picked by HTraceParameters)."""

    def receive(self, span: Span) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemorySpanReceiver(SpanReceiver):
    def __init__(self) -> None:
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    def receive(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def by_description(self, desc: str) -> List[Span]:
        with self._lock:
            return [s for s in self.spans if s.description == desc]


class LocalFileSpanReceiver(SpanReceiver):
    """JSON-lines span log (ref: the HTrace local-file receiver option).

    Lifecycle hardening: ``close`` is registered with :mod:`atexit`, so a
    short-lived follower/worker process that never reaches an orderly
    ``Tracing.close()`` still flushes its tail spans instead of silently
    dropping them; and the file ROTATES at ``max_bytes`` (keeping one
    ``<path>.1`` predecessor) so a long-lived jobserver's span log stays
    bounded instead of growing without limit. ``max_bytes=0`` disables
    rotation; the default comes from ``HARMONY_TRACE_MAX_BYTES``
    (64 MiB)."""

    def __init__(self, path: str, max_bytes: Optional[int] = None) -> None:
        import atexit

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        if max_bytes is None:
            try:
                max_bytes = int(os.environ.get(
                    "HARMONY_TRACE_MAX_BYTES", str(64 << 20)))
            except ValueError:
                max_bytes = 64 << 20
        self.max_bytes = max_bytes
        self._f = open(path, "a", buffering=1)
        self._written = self._f.tell()  # appending: count existing bytes
        self._lock = threading.Lock()
        self._closed = False
        atexit.register(self.close)

    def _rotate_locked(self) -> None:
        self._f.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass  # rotation is best-effort; keep appending regardless
        self._f = open(self.path, "a", buffering=1)
        self._written = self._f.tell()

    def receive(self, span: Span) -> None:
        line = json.dumps(span.to_dict()) + "\n"
        with self._lock:
            if self._closed:
                return  # an atexit-closed receiver drops, never crashes
            if self.max_bytes and self._written + len(line) > self.max_bytes:
                self._rotate_locked()
            self._f.write(line)
            self._written += len(line)

    def close(self) -> None:
        import atexit

        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._f.flush()
            self._f.close()
        # this receiver is done; keep the process-exit hook list short
        try:
            atexit.unregister(self.close)
        except Exception:  # pragma: no cover - interpreter teardown
            pass


class Tracing:
    """Process-wide tracing state: receivers + sampling.

    ``sample_rate``: 1.0 traces everything, 0.0 nothing (HTrace samplers);
    child spans of a sampled trace are always kept so traces stay whole.
    """

    def __init__(self, process_id: str = "", sample_rate: float = 1.0) -> None:
        self.process_id = process_id or f"proc-{os.getpid()}"
        self.sample_rate = sample_rate
        self._receivers: List[SpanReceiver] = []
        self._lock = threading.Lock()

    def add_receiver(self, receiver: SpanReceiver) -> SpanReceiver:
        with self._lock:
            self._receivers.append(receiver)
        return receiver

    def remove_receiver(self, receiver: SpanReceiver) -> None:
        with self._lock:
            if receiver in self._receivers:
                self._receivers.remove(receiver)

    def emit(self, span: Span) -> None:
        with self._lock:
            receivers = list(self._receivers)
        for r in receivers:
            r.receive(span)

    def close(self) -> None:
        with self._lock:
            receivers, self._receivers = list(self._receivers), []
        for r in receivers:
            r.close()


_tracing = Tracing()
_current: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "harmony_current_span", default=None
)
_rng = threading.local()


def get_tracing() -> Tracing:
    return _tracing


def set_tracing(tracing: Tracing) -> Tracing:
    global _tracing
    _tracing = tracing
    return tracing


def current_span() -> Optional[Span]:
    return _current.get()


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


def _sampled() -> bool:
    rate = _tracing.sample_rate
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    import random

    if not hasattr(_rng, "r"):
        _rng.r = random.Random()
    return _rng.r.random() < rate


@contextlib.contextmanager
def trace_span(
    description: str,
    parent: Optional[SpanContext] = None,
    **annotations: Any,
) -> Iterator[Optional[Span]]:
    """Open a span; nests under the current span unless ``parent`` (a wire
    context from a remote caller) overrides it. Yields None when the trace
    is sampled out — callers never branch on it."""
    cur = _current.get()
    if parent is None and cur is None and not _sampled():
        yield None
        return
    if parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    elif cur is not None:
        trace_id, parent_id = cur.trace_id, cur.span_id
    else:
        trace_id, parent_id = _new_id(), None
    span = Span(
        trace_id=trace_id,
        span_id=_new_id(),
        parent_id=parent_id,
        description=description,
        start_sec=time.time(),
        annotations=dict(annotations),
        process_id=_tracing.process_id,
    )
    token = _current.set(span)
    try:
        yield span
    finally:
        _current.reset(token)
        span.stop_sec = time.time()
        if not getattr(span, "_discarded", False):
            _tracing.emit(span)


def wire_context() -> Optional[Dict[str, str]]:
    """Current span as a message-embeddable dict (None outside any span)."""
    span = _current.get()
    if span is None:
        return None
    return SpanContext(span.trace_id, span.span_id).to_wire()
