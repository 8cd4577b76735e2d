"""The data rows of a step on a mesh with a data axis > 1.

The reference places a batch ``P(DATA_AXIS)`` (``harmony_tpu/dolphin/
worker.py:720``) and lets GSPMD split the step; the port runs the rows'
parts itself (``dolphin/worker.py::_DataParallelStep``). Three pieces live
here:

  * :class:`RowBatch`: a batch cut over the rows as that placement cuts it
    (row ``r`` holds examples ``n * r // D`` to ``n * (r + 1) // D``), each
    row's part on its row's compute slot. The worker's device caches and the
    prefetch ring stage batches this way (:func:`stage_rows`), so a step
    copies no batch between cards. On a pod a process stages only the rows
    it computes (those holding its slots): a row of another process has no
    part here;
  * :class:`RowExchange`: the rows' results on every process of the mesh,
    in row order, when the rows lie in different processes (one
    variable-length all-gather, ``collectives.process_all_gather_v``);
  * :func:`run_split`, the driver of a trainer's split contract
    (``Trainer.row_part`` and ``Trainer.row_finish``): each row's part runs on
    its slot and yields sufficient statistics; each round's statistics are
    added in row order on this process's first row's slot and handed to the
    finish, whose reply goes back to this process's rows; when the finish
    returns, its delta and metrics are the step's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from harmony_tpu_torch.dolphin.trainer import RowResult, Trainer
from harmony_tpu_torch.parallel.collectives import counted_as, process_all_gather_v
from harmony_tpu_torch.parallel.mesh import is_local, this_process
from harmony_tpu_torch.table.table import on_device


def row_bounds(n: int, rows: int) -> List[int]:
    """The cut of ``n`` examples over ``rows`` rows: row ``r`` holds
    ``bounds[r]`` to ``bounds[r + 1]``."""
    return [n * r // rows for r in range(rows + 1)]


def row_devices(mesh) -> Optional[Tuple[Optional[torch.device], ...]]:
    """The compute device of each data row of a table on ``mesh`` (a row
    computes on its first slot of this process,
    ``BlockSharding.compute_slot``), as its tensors report it (a slot's
    "cuda" is the current card), None for a row with no slot in this
    process; None for one row."""
    rows = mesh.devices.shape[0]
    if rows <= 1:
        return None
    devs = [next((s.device for s in mesh.devices[r].flat if is_local(s)), None)
            for r in range(rows)]
    return tuple(torch.device("cuda", torch.cuda.current_device())
                 if d is not None and d.type == "cuda" and d.index is None else d
                 for d in devs)


class RowBatch:
    """A batch (or a stack of batches) of ``n`` examples cut over the data
    rows: ``parts[r]`` is row ``r``'s tuple of arrays, on its compute device,
    or None for a row this process does not compute."""

    def __init__(self, parts: Sequence[Optional[Tuple[torch.Tensor, ...]]], n: int) -> None:
        self.parts = [None if p is None else tuple(p) for p in parts]
        self.n = int(n)

    @property
    def devices(self) -> Tuple[Optional[torch.device], ...]:
        return tuple(None if p is None else p[0].device for p in self.parts)

    @property
    def nbytes(self) -> int:
        """Bytes held, for the device cache's budget."""
        return sum(a.numel() * a.element_size() for p in self.parts if p for a in p)

    def index(self, b: int) -> "RowBatch":
        """Batch ``b`` of a stack: each row's part of it (views)."""
        return RowBatch([None if p is None else tuple(a[b] for a in p)
                         for p in self.parts], self.n)

    def joined(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """The whole batch on ``device``: the rows' parts joined in row
        order (the fallback of a step on another layout than the one the
        batch was staged for). A batch that lacks another process's rows
        cannot be joined."""
        if any(p is None for p in self.parts):
            raise ValueError("a batch staged for this process's data rows only "
                             "cannot be re-cut for another layout")
        return tuple(torch.cat([on_device(p[i], device) for p in self.parts])
                     for i in range(len(self.parts[0])))


def stage_rows(batch: Sequence[Any], devices: Sequence[Optional[torch.device]]) -> RowBatch:
    """Row ``r``'s slice of ``batch`` (host arrays, or tensors anywhere) on
    ``devices[r]`` (host arrays are uploaded straight to their row); no
    part for a row whose device is None."""
    n = batch[0].shape[0] if isinstance(batch[0], torch.Tensor) else len(batch[0])
    bounds = row_bounds(n, len(devices))
    parts = []
    for r, dev in enumerate(devices):
        lo, hi = bounds[r:r + 2]
        if dev is None:
            parts.append(None)
            continue
        parts.append(tuple(on_device(a[lo:hi], dev) if isinstance(a, torch.Tensor)
                           else torch.as_tensor(np.ascontiguousarray(a[lo:hi]), device=dev)
                           for a in batch))
    return RowBatch(parts, n)


def stage_stack_rows(stack: Sequence[torch.Tensor],
                     devices: Sequence[Optional[torch.device]]) -> RowBatch:
    """A stack of batches ``[num_batches, batch, ...]`` cut over the rows
    along the batch axis, each row's part copied to its device (none for a
    row whose device is None)."""
    n = stack[0].shape[1]
    bounds = row_bounds(n, len(devices))
    parts = []
    for r, dev in enumerate(devices):
        lo, hi = bounds[r:r + 2]
        parts.append(None if dev is None else tuple(
            a[:, lo:hi].to(dev, copy=True).contiguous() for a in stack))
    return RowBatch(parts, n)


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


# the dtypes a row's tensors may have, by their code in the exchange's header
_CODES = (torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int64,
          torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)
# a tensor's header: its dtype's code (-1 for None), its rank, its dims
_HEAD = 8


def _pack(tensors: Sequence[Optional[torch.Tensor]], device: torch.device) -> torch.Tensor:
    """``tensors`` as one byte tensor on ``device``: a header (the count,
    then each tensor's dtype code, rank and dims, int64), then each
    tensor's bytes, every piece padded to 8 bytes so each unpacks as a
    view."""
    head = [len(tensors)]
    bodies = []
    for t in tensors:
        if t is None:
            head += [-1] + [0] * (_HEAD - 1)
            continue
        if t.dim() > _HEAD - 2:
            raise ValueError(f"a row's tensor of rank {t.dim()} (at most {_HEAD - 2})")
        head += [_CODES.index(t.dtype), t.dim(), *t.shape] + [0] * (_HEAD - 2 - t.dim())
        raw = on_device(t, device).contiguous().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % 8
        bodies.append(raw if not pad else torch.cat([raw, raw.new_zeros(pad)]))
    header = torch.tensor(head, dtype=torch.int64).view(torch.uint8).to(device)
    return torch.cat([header] + bodies)


def _unpack(payload: torch.Tensor) -> List[Optional[torch.Tensor]]:
    """What :func:`_pack` packed, as views of ``payload``; only the header
    is read on the host."""
    count = int(payload[:8].cpu().view(torch.int64)[0])
    end = 8 * (1 + _HEAD * count)
    head = payload[8:end].cpu().view(torch.int64).reshape(count, _HEAD).tolist()
    out: List[Optional[torch.Tensor]] = []
    at = end
    for code, rank, *dims in head:
        if code < 0:
            out.append(None)
            continue
        dtype, shape = _CODES[code], tuple(dims[:rank])
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        out.append(payload[at:at + nbytes].view(dtype).reshape(shape))
        at += nbytes + (-nbytes % 8)
    return out


def in_row_order(mine: Dict[int, Sequence[Optional[torch.Tensor]]]
                 ) -> List[List[Optional[torch.Tensor]]]:
    """The exchange where this process computes every row: ``mine`` (row
    ``r``'s tensors at key ``r``) in row order; nothing crosses."""
    return [list(mine[r]) for r in range(len(mine))]


class RowExchange:
    """Each data row's tensors on every process of a table's mesh, in row
    order, on ``device`` (this process's first row's slot).

    Row ``r``'s tensors are its provider's, the lowest process computing it
    (``BlockSharding.row_processes``): each process sends the tensors of the
    rows it provides in one variable-length all-gather over the mesh's
    processes, so a row's keys and deltas cross processes unchanged, and
    every process gets every row's bits from the same process. When every
    process computes every row (one process, or rows that each span the
    mesh's processes) nothing crosses: the rows are this process's own."""

    def __init__(self, sharding, device: torch.device) -> None:
        self._sh = sharding
        self._device = device
        rows = sharding.data_rows
        self._provided = {p: [r for r in range(rows) if sharding.row_processes(r)[0] == p]
                          for p in sharding.processes}

    def __call__(self, mine: Dict[int, Sequence[Optional[torch.Tensor]]]
                 ) -> List[List[Optional[torch.Tensor]]]:
        """``mine``: this process's rows' tensors (the same number a row, in
        the same order in every row); returns every row's, in row order."""
        if not self._sh.rows_apart:
            return in_row_order(mine)
        sent = [t for r in self._provided[this_process()] for t in mine[r]]
        out: List[List[Optional[torch.Tensor]]] = [[] for _ in range(self._sh.data_rows)]
        procs = list(self._provided)
        with counted_as("exchange"):
            parts = process_all_gather_v(_pack(sent, self._device), procs)
        for p, part in zip(procs, parts):
            got, rows = _unpack(part), self._provided[p]
            per = len(got) // max(len(rows), 1)
            for i, r in enumerate(rows):
                out[r] = got[i * per:(i + 1) * per]
        return out


class RowInput:
    """One row's operands of a split step, all on ``device``; ``row`` is its
    index among the mesh's data rows (its position in the list, when not
    given)."""

    __slots__ = ("device", "model", "batch", "hyper", "local", "row")

    def __init__(self, device, model, batch, hyper, local=None, row=None) -> None:
        self.device, self.model, self.batch = device, model, batch
        self.hyper, self.local, self.row = hyper, local, row


def run_split(trainer: Trainer, rows: List[RowInput], n: int,
              exchange: Callable[[Dict[int, Sequence]], List[List]] = in_row_order):
    """Drive ``trainer``'s split over this process's ``rows`` (``n``
    examples in all, over every row of the mesh); ``exchange`` is the
    step's :class:`RowExchange` (:func:`in_row_order` when ``rows`` are
    every row, in row order). Returns ``(delta, metrics, local_writes,
    row_results)``: the finish's delta (None for a keyed pull, whose rows
    return their own) and metrics on the first row's device, its local
    writes ``(keys, rows)`` or None, and EVERY row's :class:`RowResult`, in
    row order (another process's on the first row's device).

    Over several processes each process drives the parts of its own rows;
    each round, the rows' statistics reach every process through the
    exchange, and every process runs the finish itself, on its first row's
    slot (``rows[0]``: its model and local replicas, which every replica
    holds alike; a keyed finish reads no rows), over the same sums added in
    the same row order. The finish so gets the same operands in the same
    order on the same kind of device in every process, and in one process
    over the same mesh: every process derives the one-process delta and
    replies, bit for bit, and no broadcast is needed. Each process sends
    the finish's replies to its own parts only."""
    name = type(trainer).__name__
    ids = [i if r.row is None else r.row for i, r in enumerate(rows)]
    dev0 = rows[0].device
    parts = [trainer.row_part(r.model, r.batch, r.hyper, r.local) for r in rows]
    first = rows[0]
    finish = trainer.row_finish(first.model, first.hyper, n, first.local)
    next(finish)   # to its first ``stats = yield``
    stats = [next(p) for p in parts]
    while True:
        names = list(stats[0])
        every = exchange({i: [s[k] for k in names] for i, s in zip(ids, stats)})
        try:
            reply = finish.send(sum_in_row_order([dict(zip(names, t)) for t in every], dev0))
        except StopIteration as stop:
            out = stop.value
            break
        try:
            stats = [p.send(_on(reply, r.device)) for p, r in zip(parts, rows)]
        except StopIteration:
            raise RuntimeError(f"{name}.row_part ended while row_finish "
                               "still takes statistics") from None
    mine = {}
    for p, i in zip(parts, ids):
        try:
            p.send(None)
        except StopIteration as stop:
            res = stop.value if stop.value is not None else RowResult()
            mine[i] = [res.delta, res.local_keys, res.local_rows]
        else:
            raise RuntimeError(f"{name}.row_part yields more rounds than "
                               "row_finish takes")
    results = [RowResult(*t) for t in exchange(mine)]
    delta, metrics, *local = out
    return delta, metrics, (local[0] if local else None), results
