"""One process-wide order for work enqueued on several slots.

Counterpart of ``harmony_tpu/parallel/dispatch.py``. Concurrent jobs that
share slots need ONE GLOBAL ORDER of their multi-slot work (the reference's
GlobalTaskUnitScheduler insight, driver/impl/GlobalTaskUnitScheduler.java:29-36):
a step over a sharded table enqueues its per-slot gathers, copies and folds
inside :func:`dispatch_scope`, so two jobs never interleave theirs. Work on
one slot skips the scope.

The reference also BLOCKS inside the scope on the CPU backend, whose
in-process collectives rendezvous across device threads (two overlapping
multi-device programs could starve them). The port has no in-process
rendezvous, since each slot's work is plain kernels on its device's stream,
so it never blocks here and the scope only orders enqueues.

Lock order: table lock(s) first, then this scope, and no other lock inside.
"""
from __future__ import annotations

import contextlib
import threading

_LOCK = threading.RLock()


@contextlib.contextmanager
def dispatch_scope(mesh):
    """Enqueue the enclosed multi-slot work in the process-wide order (a
    no-op for a mesh of one slot, or no mesh)."""
    if mesh is None or mesh.size <= 1:
        yield
        return
    with _LOCK:
        yield
