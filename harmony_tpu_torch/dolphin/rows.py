"""The data rows of a step on a mesh with a data axis > 1.

The reference places a batch ``P(DATA_AXIS)`` (``harmony_tpu/dolphin/
worker.py:720``) and lets GSPMD split the step; the port runs the rows'
parts itself (``dolphin/worker.py::_DataParallelStep``). Two pieces live
here:

  * :class:`RowBatch`: a batch cut over the rows as that placement cuts it
    (row ``r`` holds examples ``n * r // D`` to ``n * (r + 1) // D``), each
    row's part on its row's compute slot. The worker's device caches and the
    prefetch ring stage batches this way (:func:`stage_rows`), so a step
    copies no batch between cards;
  * :func:`run_split`, the driver of a trainer's split contract
    (``Trainer.row_part`` and ``Trainer.row_finish``): each row's part runs on
    its slot and yields sufficient statistics; each round's statistics are
    added in row order on the first row's slot and handed to the finish,
    whose reply goes back to every row; when the finish returns, its delta
    and metrics are the step's.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from harmony_tpu_torch.dolphin.trainer import RowResult, Trainer
from harmony_tpu_torch.table.table import on_device


def row_bounds(n: int, rows: int) -> List[int]:
    """The cut of ``n`` examples over ``rows`` rows: row ``r`` holds
    ``bounds[r]`` to ``bounds[r + 1]``."""
    return [n * r // rows for r in range(rows + 1)]


def row_devices(mesh) -> Optional[Tuple[torch.device, ...]]:
    """The compute device of each data row of a table on ``mesh`` (a row
    computes on its first slot, ``BlockSharding.compute_slot``), as its
    tensors report it (a slot's "cuda" is the current card), or None for one
    row."""
    rows = mesh.devices.shape[0]
    if rows <= 1:
        return None
    devs = [mesh.devices[r].flat[0].device for r in range(rows)]
    return tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d for d in devs)


class RowBatch:
    """A batch (or a stack of batches) cut over the data rows: ``parts[r]``
    is row ``r``'s tuple of arrays, on its compute device."""

    def __init__(self, parts: Sequence[Tuple[torch.Tensor, ...]]) -> None:
        self.parts = [tuple(p) for p in parts]

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(p[0].device for p in self.parts)

    @property
    def nbytes(self) -> int:
        """Bytes held, for the device cache's budget."""
        return sum(a.numel() * a.element_size() for p in self.parts for a in p)

    def index(self, b: int) -> "RowBatch":
        """Batch ``b`` of a stack: each row's part of it (views)."""
        return RowBatch([tuple(a[b] for a in p) for p in self.parts])

    def joined(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """The whole batch on ``device``: the rows' parts joined in row
        order (the fallback of a step on another layout than the one the
        batch was staged for)."""
        return tuple(torch.cat([on_device(p[i], device) for p in self.parts])
                     for i in range(len(self.parts[0])))


def stage_rows(batch: Sequence[Any], devices: Sequence[torch.device]) -> RowBatch:
    """Row ``r``'s slice of ``batch`` (host arrays, or tensors anywhere) on
    ``devices[r]``: host arrays are uploaded straight to their row."""
    parts = []
    for r, dev in enumerate(devices):
        part = []
        for a in batch:
            if isinstance(a, torch.Tensor):
                n = a.shape[0]
                lo, hi = row_bounds(n, len(devices))[r:r + 2]
                part.append(on_device(a[lo:hi], dev))
            else:
                n = len(a)
                lo, hi = row_bounds(n, len(devices))[r:r + 2]
                part.append(torch.as_tensor(np.ascontiguousarray(a[lo:hi]), device=dev))
        parts.append(tuple(part))
    return RowBatch(parts)


def stage_stack_rows(stack: Sequence[torch.Tensor], devices: Sequence[torch.device]
                     ) -> RowBatch:
    """A stack of batches ``[num_batches, batch, ...]`` cut over the rows
    along the batch axis, each row's part copied to its device."""
    parts = []
    for r, dev in enumerate(devices):
        part = []
        for a in stack:
            lo, hi = row_bounds(a.shape[1], len(devices))[r:r + 2]
            part.append(a[:, lo:hi].to(dev, copy=True).contiguous())
        parts.append(tuple(part))
    return RowBatch(parts)


def sum_in_row_order(stats: List[Dict[str, torch.Tensor]], device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    """Each key's values added in row order on ``device``: the same bits
    from run to run."""
    out = {}
    for k in stats[0]:
        total = on_device(stats[0][k], device)
        for s in stats[1:]:
            total = total + on_device(s[k], device)
        out[k] = total
    return out


def _on(reply: Optional[Dict[str, torch.Tensor]], device: torch.device):
    if reply is None:
        return None
    return {k: on_device(v, device) for k, v in reply.items()}


class RowInput:
    """One row's operands of a split step, all on ``device``."""

    __slots__ = ("device", "model", "batch", "hyper", "local")

    def __init__(self, device, model, batch, hyper, local=None) -> None:
        self.device, self.model, self.batch = device, model, batch
        self.hyper, self.local = hyper, local


def run_split(trainer: Trainer, rows: List[RowInput], n: int):
    """Drive ``trainer``'s split over ``rows`` (``n`` examples in all).
    Returns ``(delta, metrics, local_writes, row_results)``: the finish's
    delta (None for a keyed pull, whose rows return their own) and metrics
    on the first row's device, its local writes ``(keys, rows)`` or None,
    and each row's :class:`RowResult`."""
    name = type(trainer).__name__
    dev0 = rows[0].device
    parts = [trainer.row_part(r.model, r.batch, r.hyper, r.local) for r in rows]
    first = rows[0]
    finish = trainer.row_finish(first.model, first.hyper, n, first.local)
    next(finish)   # to its first ``stats = yield``
    stats = [next(p) for p in parts]
    while True:
        try:
            reply = finish.send(sum_in_row_order(stats, dev0))
        except StopIteration as stop:
            out = stop.value
            break
        try:
            stats = [p.send(_on(reply, r.device)) for p, r in zip(parts, rows)]
        except StopIteration:
            raise RuntimeError(f"{name}.row_part ended while row_finish "
                               "still takes statistics") from None
    results = []
    for p in parts:
        try:
            p.send(None)
        except StopIteration as stop:
            results.append(stop.value if stop.value is not None else RowResult())
        else:
            raise RuntimeError(f"{name}.row_part yields more rounds than "
                               "row_finish takes")
    delta, metrics, *local = out
    return delta, metrics, (local[0] if local else None), results
