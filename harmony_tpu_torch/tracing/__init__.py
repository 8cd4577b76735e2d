"""Tracing spans (``span.py``, a copy of the reference's)."""
from harmony_tpu_torch.tracing.span import (
    InMemorySpanReceiver,
    LocalFileSpanReceiver,
    Span,
    SpanContext,
    SpanReceiver,
    Tracing,
    current_span,
    get_tracing,
    set_tracing,
    trace_span,
    wire_context,
)

__all__ = [
    "Span",
    "SpanContext",
    "SpanReceiver",
    "InMemorySpanReceiver",
    "LocalFileSpanReceiver",
    "Tracing",
    "trace_span",
    "current_span",
    "get_tracing",
    "set_tracing",
    "wire_context",
]
