"""Collectives over slots, each in a fixed slot order.

The reference runs its sequence- and tensor-parallel steps per device inside
``shard_map``, with ``lax.ppermute``, ``lax.all_to_all`` and ``lax.psum`` as
collectives. The port is one process driving every slot of a mesh
(``parallel/mesh.py``), so a collective is a set of copies between the slots'
devices that this process enqueues itself:

  * :func:`ppermute` — each slot's tensor moves to the next slot of a ring;
  * :func:`all_to_all` — slot ``j`` gathers piece ``j`` of every slot's tensor;
  * :func:`psum` — the slots' tensors summed onto one device, in slot order;
  * :func:`broadcast` — one tensor copied to several slots, whose gradients
    come back summed in slot order.

Between two slots of one device a copy costs nothing but a device copy (a
virtual mesh), between two cards it is the peer copy; autograd carries the
gradients back the same way. Every sum here is taken in slot order. Autograd
adds the gradients of a tensor's consumers in the order their backward passes
finish, which on several cards depends on the other cards; a sum of two terms
is exact in either order, so the steps give no tensor more than two gradient
consumers whose backward waits on another slot, and a virtual mesh and a mesh
of cards give the same bits.

Across the processes of a pod (``parallel/multihost.py``) the one layer is
``torch.distributed``, over the group of the processes concerned:

  * :func:`process_all_gather` — each process's tensor, the parts in process
    order (the order of their slots), on every process. A copy with no
    arithmetic: gloo and NCCL give the same bits. Both take a card's
    tensor as it is (gloo copies it through the host itself);
    :func:`process_all_gather_v` the same for tensors whose first
    dimension differs by process (a data row's keyed delta);
  * :func:`process_psum` — that all-gather, then a left-to-right sum in
    process order (``all_reduce``'s order of addition is not slot order);
  * :func:`process_broadcast` — one process's tensor on every process.

Every such call blocks the calling thread until each process of the group
has made it, so every one lies inside its job's unit scope
(``runtime/podunits.py``), where no other job's collective on these
processes can interleave. :data:`POD_STATS` counts the calls and their bytes
in this process, and apart by caller (:func:`counted_as`): the worker's comm
probe, a step's row exchange, and a row's read of shards over its processes.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Sequence

import torch


def send(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` as a new tensor on ``device``: a peer copy between cards, a device
    copy between slots of one device. Always a copy, so every hop of a ring is
    its own tensor, with its own two consumers, on a virtual mesh as on cards."""
    return t.to(device, non_blocking=True, copy=True)


def ppermute(shards: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """One step of a ring: slot ``i``'s tensor moves to slot ``i + 1`` (the last
    to the first), as ``lax.ppermute`` with the permutation ``i -> i + 1``."""
    n = len(shards)
    return [send(shards[(i - 1) % n], devices[i]) for i in range(n)]


def all_to_all(shards: Sequence[torch.Tensor], devices: Sequence[torch.device],
               split_dim: int, concat_dim: int) -> List[torch.Tensor]:
    """``lax.all_to_all(..., tiled=True)`` over the slots of one axis: slot
    ``j`` receives piece ``j`` (of ``n`` along ``split_dim``) of every slot's
    tensor, joined in slot order along ``concat_dim``."""
    n = len(shards)
    pieces = [t.chunk(n, dim=split_dim) for t in shards]
    return [torch.cat([p[j].to(devices[j], non_blocking=True) for p in pieces], dim=concat_dim)
            for j in range(n)]


def psum(tensors: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The tensors summed on ``device``, left to right in slot order."""
    total = tensors[0].to(device, non_blocking=True)
    for t in tensors[1:]:
        total = total + t.to(device, non_blocking=True)
    return total


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.device = x.device
        return tuple(send(x, d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        return psum(grads, ctx.device), None


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """A copy of ``x`` on each of ``devices`` (a replicated activation entering
    each model shard); the backward sums the copies' gradients in slot order,
    where autograd would add them into ``x`` in the order they arrive."""
    return list(_Broadcast.apply(x, tuple(devices)))


# -- across processes --------------------------------------------------------

_STAT_KEYS = ("calls", "bytes_out", "bytes_in")
# the callers counted apart too, as "<caller>.<key>"
POD_CALLERS = ("probe", "exchange", "read")
POD_STATS: Dict[str, int] = {k: 0 for k in _STAT_KEYS}
POD_STATS.update({f"{c}.{k}": 0 for c in POD_CALLERS for k in _STAT_KEYS})
_STATS_LOCK = threading.Lock()
_CALLER = threading.local()


@contextlib.contextmanager
def counted_as(caller: str) -> Iterator[None]:
    """Count the calls this thread makes inside under ``caller`` (one of
    :data:`POD_CALLERS`) as well; an enclosing caller keeps them (a probe's
    reads are the probe's)."""
    outer = getattr(_CALLER, "name", None)
    _CALLER.name = outer or caller
    try:
        yield
    finally:
        _CALLER.name = outer


def _note(bytes_out: int, bytes_in: int) -> None:
    caller = getattr(_CALLER, "name", None)
    with _STATS_LOCK:
        for prefix in ("",) + ((f"{caller}.",) if caller else ()):
            POD_STATS[prefix + "calls"] += 1
            POD_STATS[prefix + "bytes_out"] += bytes_out
            POD_STATS[prefix + "bytes_in"] += bytes_in


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend takes it: NCCL a tensor on this process's
    card, gloo a host or a card tensor as it is."""
    from harmony_tpu_torch.parallel import multihost

    if multihost.backend() == "nccl" and t.device.type != "cuda":
        return t.to(multihost.local_devices()[0])
    return t.contiguous()


def _back(p: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A received tensor on ``device``: async onto a card (ordered on its
    stream), but a blocking copy to the host, whose values the caller reads at
    once (a non-blocking copy to the host would return before the collective
    has delivered them)."""
    if p.device == device:
        return p
    return p.to(device, non_blocking=device.type == "cuda")


def process_all_gather(t: torch.Tensor, processes: Sequence[int]) -> List[torch.Tensor]:
    """This process's ``t`` and the same-shaped tensor of every other process
    of ``processes``, in process order, each on ``t``'s device."""
    from harmony_tpu_torch.parallel import multihost

    procs = tuple(sorted(set(processes)))
    if len(procs) == 1:
        return [t]
    group = multihost.group_of(procs)
    src = _wire(t)
    parts = [torch.empty_like(src) for _ in procs]
    torch.distributed.all_gather(parts, src, group=group)
    out = [_back(p, t.device) for p in parts]
    nbytes = t.numel() * t.element_size()
    _note(nbytes, nbytes * len(procs))
    return out


def process_all_gather_v(t: torch.Tensor, processes: Sequence[int]) -> List[torch.Tensor]:
    """:func:`process_all_gather` of tensors whose first dimension differs by
    process (the rest alike): each process first sends its count, then its
    tensor padded to the largest count, and the padding is cut off what
    arrives. Two all-gathers, each counted; the counts reach the host before
    the second is made (``_back`` blocks), and when every count is 0 the
    second is not made at all, in every process alike."""
    procs = tuple(sorted(set(processes)))
    if len(procs) == 1:
        return [t]
    counts = [int(c[0]) for c in process_all_gather(
        torch.tensor([t.shape[0]], dtype=torch.int64), procs)]
    top = max(counts)
    if top == 0:
        return [t[:0] for _ in procs]
    padded = t if t.shape[0] == top else torch.cat(
        [t, t.new_zeros((top - t.shape[0],) + tuple(t.shape[1:]))])
    return [p[:n] for p, n in zip(process_all_gather(padded, procs), counts)]


def process_psum(t: torch.Tensor, processes: Sequence[int]) -> torch.Tensor:
    """The processes' tensors summed left to right in process order."""
    parts = process_all_gather(t, processes)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def process_broadcast(t: torch.Tensor, src: int, processes: Sequence[int]) -> torch.Tensor:
    """Process ``src``'s ``t`` on every process of ``processes`` (a copy on
    ``t``'s device; ``t`` gives the shape and dtype elsewhere)."""
    from harmony_tpu_torch.parallel import multihost

    procs = tuple(sorted(set(processes)))
    if len(procs) == 1:
        return t
    buf = _wire(t)
    buf = buf.clone() if buf is t else buf
    torch.distributed.broadcast(buf, src=src, group=multihost.group_of(procs))
    out = _back(buf, t.device)
    nbytes = t.numel() * t.element_size()
    _note(nbytes if multihost.process_index() == src else 0, nbytes)
    return out
