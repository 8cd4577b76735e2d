"""Pipeline parallelism: GPipe-style microbatched stages over a mesh axis.

Counterpart of ``harmony_tpu/parallel/pipeline.py``. The reference runs the
M + S - 1 tick schedule per device inside ``shard_map``: at tick t stage s
works on microbatch t - s and ``ppermute``s its output to stage s + 1; bubble
ticks compute garbage that a mask drops, and the last stage's outputs are
psum-broadcast to every stage. The port is one process driving every slot,
so it enqueues the ticks in the same order itself:

  * at tick t each stage s with 0 <= t - s < M applies ``stage_fn`` on its own
    slot to the activation that arrived from stage s - 1 (stage 0 to
    microbatch t), and sends its output on with ``collectives.send``;
  * a bubble tick launches nothing, and the S - 1 -> 0 wrap edge carries
    nothing;
  * each (stage, microbatch) application is rematerialised in the backward
    (``torch.utils.checkpoint``), as the reference checkpoints each tick;
  * the outputs come back to the home slot (stage 0's) in microbatch order.

Autograd's per-device threads then run the backward pipelined on real cards.
A stage's parameters feed its M applications through :class:`_Uses`, whose
backward adds their M gradients in microbatch order: autograd would add them
in the order the applications' backward passes finish, which the later
stages decide on other cards.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from harmony_tpu_torch.models.pytree_trainer import tree_leaves, tree_unflatten
from harmony_tpu_torch.parallel.collectives import send
from harmony_tpu_torch.parallel.dispatch import dispatch_scope

STAGE_AXIS = "stage"


class _Uses(torch.autograd.Function):
    """``n`` aliases of ``x``, one for each use; the backward adds their
    gradients in use order."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0]
        for g in grads[1:]:
            total = total + g
        return total, None


def _uses(tree: Any, n: int) -> List[Any]:
    """``n`` trees shaped like ``tree``, the i-th holding each tensor's i-th
    alias (a tensor that needs no gradient is shared as it is)."""
    leaves = list(tree_leaves(tree))
    per_leaf = [_Uses.apply(p, n) if isinstance(p, torch.Tensor) and p.requires_grad
                else (p,) * n for p in leaves]
    return [tree_unflatten(tree, [uses[i] for uses in per_leaf]) for i in range(n)]


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Sequence[Any],
    microbatches: Sequence[torch.Tensor],
    devices: Sequence[torch.device],
) -> torch.Tensor:
    """Run ``microbatches`` (M tensors, or one with a leading M) through S
    pipelined stages: stage s applies ``stage_fn(stage_params[s], x)`` on
    ``devices[s]``, where its parameters lie. Returns the [M, ...] outputs on
    ``devices[0]``, the composition of the stages on each microbatch."""
    S, M = len(devices), len(microbatches)
    if len(stage_params) != S:
        raise ValueError(f"{len(stage_params)} stage parameter trees for {S} stages")
    uses = [_uses(p, M) for p in stage_params]
    # acts[m]: microbatch m's activation, on the slot of the stage it enters next
    acts = [mb.to(devices[0], non_blocking=True) for mb in microbatches]
    outs: List[Optional[torch.Tensor]] = [None] * M
    for t in range(M + S - 1):
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue  # a bubble: nothing to launch
            y = checkpoint(stage_fn, uses[s][m], acts[m], use_reentrant=False)
            if s + 1 < S:
                acts[m] = send(y, devices[s + 1])
            else:
                outs[m] = send(y, devices[0])
    return torch.stack(outs)


def make_pipeline_fn(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh,
    axis_name: str = STAGE_AXIS,
    num_microbatches: Optional[int] = None,
):
    """``fn(stage_params, x) -> y``: ``stage_params`` is a list of S
    parameter trees, tree s on the slot at index s of ``axis_name`` (the
    reference stacks them on a leading axis sharded over it), and ``x [B,
    ...]`` is split into ``num_microbatches`` (default S) equal microbatches.
    ``y`` lies on the home slot (stage 0's)."""
    S = mesh.shape[axis_name]
    devices = [mesh.slot_at({axis_name: s}).device for s in range(S)]

    def fn(stage_params, x):
        M = num_microbatches or S
        B = x.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible into {M} microbatches")
        with dispatch_scope(mesh):
            out = pipeline_apply(stage_fn, stage_params, x.chunk(M), devices)
        return out.reshape(B, *out.shape[2:])

    return fn
