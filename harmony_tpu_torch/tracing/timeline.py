"""Trace-timeline shaping for the renderers.

A copy of ``harmony_tpu/tracing/timeline.py`` (pure Python; the port keeps
its own): turns a list of span dicts into a start-ordered timeline with
nesting depth and offsets. ``cli obs incidents`` draws each incident's
causal chain through it. Edge cases (spans with no start/stop time, parent
cycles, orphaned parents) are handled once, here."""
from __future__ import annotations

from typing import Any, Dict, List


def timeline_rows(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Shape spans into render-ready rows:

    ``[{span, depth, offset_sec, duration_sec, wall_sec}]`` — offsets are
    relative to the earliest known start; ``wall_sec`` (same value on
    every row) is the whole timeline's extent, floored at 1e-9 so scale
    divisions are safe. Spans with no ``start_sec`` (a receiver is free
    to store partial records) sort first at offset 0 with duration 0;
    parent cycles and unknown parents terminate at depth 0."""
    if not spans:
        return []
    by_id = {s.get("span_id"): s for s in spans if s.get("span_id")}

    def depth(s: Dict[str, Any], seen: tuple = ()) -> int:
        p = s.get("parent_id")
        if p is None or p not in by_id or p in seen:
            return 0
        return 1 + depth(by_id[p], seen + (s.get("span_id"),))

    starts = [s["start_sec"] for s in spans if s.get("start_sec") is not None]
    t0 = min(starts) if starts else 0.0
    rows = []
    for s in sorted(spans, key=lambda x: x.get("start_sec") or t0):
        start = s.get("start_sec")
        stop = s.get("stop_sec")
        offset = (start - t0) if start is not None else 0.0
        duration = max((stop - start), 0.0) \
            if start is not None and stop is not None else 0.0
        rows.append({"span": s, "depth": depth(s), "offset_sec": offset,
                     "duration_sec": duration})
    wall = max(
        (r["offset_sec"] + r["duration_sec"] for r in rows), default=0.0)
    wall = max(wall, 1e-9)
    for r in rows:
        r["wall_sec"] = wall
    return rows
