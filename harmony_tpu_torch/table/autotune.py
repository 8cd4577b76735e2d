"""Measured push-route selection.

Counterpart of ``harmony_tpu/table/autotune.py``. A keyed additive push on a
``DenseTable`` has more than one lowering (``TableSpec.push``), and which is
faster depends on the table's size and width, the key count and the device,
in ways a static gate gets wrong: the reference replaced its ``capacity //
256`` gate with a one-time measurement per shape signature, cached for the
process. ``HARMONY_PUSH_VIA`` still overrides upstream
(``DenseTable.push_via``).

On a CUDA table the arms are the two deterministic folds, ``mxu``
(``weighted_histogram``, K3) and ``sparse`` (``segment_sum_rows``, K2): both
fold in index order from 0.0 and give the same bits, so the choice changes a
step's time, never its result. They are two entries into one kernel pair
(``csrc/keyed_fold.cu``), so their times differ by less than a measurement
spreads: the incumbent, ``mxu`` (the fold the static gate names), stays
unless the other arm is faster by more than ``MARGIN``. The reference also
measures ``scatter``; on the card that is ``index_add_``, whose float
atomics add in an order that changes from run to run, which the port's
deterministic paths rule out.

Each arm is timed on DEVICE time: a push of a few microseconds is shorter
than the host's enqueue of it, so a host clock would time the host. The
pushes run on a stream of their own, enqueued behind a device-side sleep on
that stream and timed by CUDA events recorded on it, after a warm-up
(:func:`device_ms`). Other tenants' kernels on their own streams are not
counted (they may share the card's SMs while the pushes run) and are not
held up by the sleep. A host too slow to enqueue the pushes within the
sleep is a failed measurement: it is retried behind a longer sleep, and if
every try fails the incumbent is kept.

On a table over several slots the push folds once a shard
(``TableSpec._push_sharded``), so the route is measured for one shard: a
push into a copy of the first slot's shard alone, on its device, timed with
the same keys a whole push routes; the signature carries the shard's rows
and the slot's device. Every shard holds as many rows, and a pool's cards
are one kind, so the route measured there is every shard's.

On the CPU the static gate stays (``_static_gate``, the rule ``mxu_auto``
resolves by inside ``TableSpec.push``), unless the caller hands in a timer.
A push that fails (a kernel that does not build or launch) raises: the
reference caches its static gate then, which would hide the fault.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from harmony_tpu_torch.table.table import ShardedArray

_LOCK = threading.Lock()
_ROUTES: Dict[Tuple, str] = {}
_MEASUREMENTS: Dict[Tuple, Dict[str, Optional[float]]] = {}

# the folds the card compares; the first is the incumbent
CUDA_ARMS = ("mxu", "sparse")
# the share by which a challenger must beat the incumbent's time
MARGIN = 0.05
# pushes timed in one measurement, and the device-side sleep queued before
# them, long enough for the host to enqueue them all behind it; each retry
# after a sleep that ended too early sleeps four times as long
_TIMED_PUSHES = 10
_SLEEP_CYCLES = 50_000_000  # ~25 ms at the H100's 1.98 GHz boost clock
_SLEEP_TRIES = 4

# a timer returns milliseconds per call, or None when it could not measure
Timer = Callable[[Callable[[], object]], Optional[float]]


def _signature(spec, device: torch.device, nkeys: int, shard_rows: int = 0) -> Tuple:
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return (spec.config.capacity, spec.block_size, tuple(spec.value_shape),
            str(spec.dtype), int(nkeys), str(device), int(shard_rows))


def reset() -> None:
    with _LOCK:
        _ROUTES.clear()
        _MEASUREMENTS.clear()


def measurements() -> Dict[Tuple, Dict[str, Optional[float]]]:
    """Each measured signature's milliseconds per arm."""
    with _LOCK:
        return dict(_MEASUREMENTS)


def _static_gate(spec, nkeys: int) -> str:
    """The density gate: the fold when the push touches at least
    capacity/256 keys (and at least 32), else the scatter."""
    dense_enough = nkeys >= max(32, spec.config.capacity // 256)
    return "mxu" if dense_enough else "scatter"


def _behind_short_sleeps(attempt: Callable[[int], Optional[float]]) -> Optional[float]:
    """``attempt(cycles)`` with a sleep of ``_SLEEP_CYCLES``, then four times
    longer after each try whose sleep ended before the host had enqueued
    (``attempt`` returns None); None if every try failed."""
    cycles = _SLEEP_CYCLES
    for _ in range(_SLEEP_TRIES):
        ms = attempt(cycles)
        if ms is not None:
            return ms
        cycles *= 4
    return None


def device_ms(fn: Callable[[], object]) -> Optional[float]:
    """Milliseconds of device time per call of ``fn`` (which launches on the
    current stream), or None if the host could not be timed out of it. On a
    stream of its own: two warm-up calls, then ``_TIMED_PUSHES`` calls
    enqueued behind a device-side sleep, between two CUDA events on that
    stream. The sleep holds the stream while the host enqueues, so the calls
    then run back to back and the events time the device alone; a sleep
    that ended first would let the host stretch the time, so that try is
    discarded (:func:`_behind_short_sleeps`)."""
    caller = torch.cuda.current_stream()
    stream = torch.cuda.Stream(caller.device)
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        fn()
        fn()

        def attempt(cycles: int) -> Optional[float]:
            stream.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record(stream)
            for _ in range(_TIMED_PUSHES):
                fn()
            end.record(stream)
            held = not start.query()
            end.synchronize()
            return start.elapsed_time(end) / _TIMED_PUSHES if held else None

        ms = _behind_short_sleeps(attempt)
    caller.wait_stream(stream)
    return ms


def pick(meas: Dict[str, Optional[float]]) -> str:
    """The route for one signature's measurement: the incumbent unless the
    challenger is faster by more than ``MARGIN`` (both measured)."""
    incumbent, challenger = CUDA_ARMS
    a, b = meas[f"{incumbent}_ms"], meas[f"{challenger}_ms"]
    if a is not None and b is not None and b < a * (1.0 - MARGIN):
        return challenger
    return incumbent


def choose_push_route(spec, device: torch.device, nkeys: int, table=None,
                      timer: Optional[Timer] = None) -> str:
    """The keyed-push route for pushes of ``nkeys`` keys into tables of
    ``spec`` on ``device``, cached per shape signature for the process.

    Non-additive update fns always take "scatter". On the CPU, with no
    ``timer``, the static gate. Otherwise each arm is timed by ``timer``
    (default :func:`device_ms`) on a push into a COPY of ``table``'s storage
    (or of a zero table), so the live table never changes, and the route
    cached is the incumbent (``CUDA_ARMS[0]``) unless the other arm is
    faster by more than ``MARGIN``, or the incumbent if either arm could
    not be measured."""
    if spec.update_fn.scatter_mode != "add":
        return "scatter"
    if timer is None and device.type != "cuda":
        return _static_gate(spec, nkeys)
    sharded = table is not None and isinstance(table._step_state, ShardedArray)
    slot = table.sharding.compute_slot() if sharded else None
    shard_rows = spec._rows_per_shard(table.sharding) if sharded else 0
    sig = _signature(spec, slot.device if sharded else device, nkeys, shard_rows)
    with _LOCK:
        hit = _ROUTES.get(sig)
    if hit is not None:
        return hit
    if sharded:
        with table._lock:
            st = table._step_state
            arr = ShardedArray(st.sharding, {slot: st.shards[slot].clone()})
        on = (torch.cuda.device(slot.device) if slot.device.type == "cuda"
              else contextlib.nullcontext())
    elif table is not None:
        with table._lock:
            arr = table._step_state.clone()
    else:
        arr = torch.zeros(spec.storage_shape, dtype=spec.dtype, device=device)
    rng = np.random.default_rng(0)
    keys = torch.as_tensor(rng.integers(0, spec.config.capacity, int(nkeys)),
                           dtype=torch.int32, device=device)
    deltas = torch.zeros((int(nkeys), *spec.value_shape), dtype=spec.dtype, device=device)
    timer = timer or device_ms
    if not sharded:
        on = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
    with on:
        meas = {f"{via}_ms": timer(lambda via=via: spec.push(arr, keys, deltas, via=via))
                for via in CUDA_ARMS}
    route = pick(meas)
    with _LOCK:
        _ROUTES[sig] = route
        _MEASUREMENTS[sig] = meas
        while len(_ROUTES) > 1024:
            _ROUTES.pop(next(iter(_ROUTES)))
        while len(_MEASUREMENTS) > 1024:
            _MEASUREMENTS.pop(next(iter(_MEASUREMENTS)))
    return route
