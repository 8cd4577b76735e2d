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
"""
from __future__ import annotations

from typing import List, Sequence

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
