"""Directed acyclic graph with ready-set semantics for plan scheduling.

A copy of ``harmony_tpu/utils/dag.py`` (which imports no JAX; the port keeps
its own copy and imports nothing of the JAX package).

Capability parity with the reference's ``utils/DAG.java`` / ``DAGImpl.java``
(used by its plan engine, ``services/et/.../plan/impl/ETPlan.java:37-80``):
vertices with dependency edges, queries for root ("ready") vertices, and
removal that releases dependents. Thread-safe: the plan executor pops ready
ops from multiple threads.
"""
from __future__ import annotations

import threading
from typing import Dict, Generic, List, Set, TypeVar

V = TypeVar("V")


class CyclicDependencyError(Exception):
    """Adding an edge would create a cycle."""


class DAG(Generic[V]):
    """A mutable DAG over hashable vertices.

    ``roots()`` returns vertices with no remaining in-edges (ready to run);
    ``remove(v)`` deletes a vertex and its out-edges, potentially promoting
    its dependents to roots — the pop/complete cycle the plan executor runs
    (ref: PlanExecutorImpl.java:80-130).
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._out: Dict[V, Set[V]] = {}
        self._in: Dict[V, Set[V]] = {}

    def add_vertex(self, v: V) -> None:
        with self._lock:
            if v in self._out:
                raise ValueError(f"vertex already present: {v!r}")
            self._out[v] = set()
            self._in[v] = set()

    def add_edge(self, src: V, dst: V) -> None:
        """Edge src -> dst: dst depends on src (src must finish first)."""
        with self._lock:
            if src not in self._out or dst not in self._out:
                raise KeyError("both endpoints must be added first")
            if dst in self._out[src]:
                return
            if self._reaches(dst, src):
                raise CyclicDependencyError(f"{src!r} -> {dst!r} creates a cycle")
            self._out[src].add(dst)
            self._in[dst].add(src)

    def _reaches(self, start: V, target: V) -> bool:
        stack = [start]
        seen: Set[V] = set()
        while stack:
            v = stack.pop()
            if v == target:
                return True
            if v in seen:
                continue
            seen.add(v)
            stack.extend(self._out.get(v, ()))
        return False

    def roots(self) -> List[V]:
        with self._lock:
            return [v for v, preds in self._in.items() if not preds]

    def remove(self, v: V) -> List[V]:
        """Remove ``v``; return dependents that became roots. Also detaches
        ``v`` from any remaining predecessors, so removing a non-root vertex
        (e.g. cancelling a pending op) leaves the graph consistent."""
        with self._lock:
            if v not in self._out:
                raise KeyError(f"no such vertex: {v!r}")
            released = []
            for dst in self._out.pop(v):
                self._in[dst].discard(v)
                if not self._in[dst]:
                    released.append(dst)
            for src in self._in.pop(v):
                self._out[src].discard(v)
            return released

    def __len__(self) -> int:
        with self._lock:
            return len(self._out)

    def __contains__(self, v: V) -> bool:
        with self._lock:
            return v in self._out

    def vertices(self) -> List[V]:
        with self._lock:
            return list(self._out)

    def topological_order(self) -> List[V]:
        """Kahn's algorithm over a snapshot; does not mutate the DAG."""
        with self._lock:
            in_deg = {v: len(preds) for v, preds in self._in.items()}
            out = {v: set(s) for v, s in self._out.items()}
        order: List[V] = []
        ready = [v for v, d in in_deg.items() if d == 0]
        while ready:
            v = ready.pop()
            order.append(v)
            for dst in out[v]:
                in_deg[dst] -= 1
                if in_deg[dst] == 0:
                    ready.append(dst)
        if len(order) != len(in_deg):
            raise CyclicDependencyError("graph contains a cycle")
        return order
