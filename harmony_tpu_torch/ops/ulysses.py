"""All-to-all (Ulysses-style) sequence parallelism: the head-scatter alternative
to ring attention.

Counterpart of ``harmony_tpu/ops/ulysses.py``. Where the ring keeps tokens home
and rotates k/v, this scheme re-shards once a call: an all-to-all turns the
sequence-split [B, H, S/n, D] chunks into head-split [B, H/n, S, D] groups,
each slot runs ordinary attention over the whole sequence for its heads, and a
second all-to-all restores the sequence split. Two collectives a call against
the ring's n - 1 rotations.

The reference runs :func:`a2a_attention` per device inside ``shard_map``
(``lax.all_to_all``); here it takes the local chunks of one ring of slots
(:mod:`harmony_tpu_torch.parallel.collectives`), and :func:`a2a_self_attention`
splits global tensors over a mesh and joins the outputs. After the gather each
slot holds dense full-sequence q/k/v, flash attention's case (K4, K5a, K5b at
the default blocks) on the card when the sequence tiles by 128; the plain
blockwise route otherwise, and on the CPU.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from harmony_tpu_torch.ops.attention import blockwise_attention, flash_attention
from harmony_tpu_torch.ops.ring import join_rings, mesh_rings, split_over_rings
from harmony_tpu_torch.parallel.collectives import all_to_all
from harmony_tpu_torch.parallel.mesh import Mesh


def a2a_attention(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    causal: bool = False,
    scale: Optional[float] = None,
) -> List[torch.Tensor]:
    """Exact attention over a sequence split along one ring of slots, by head
    scattering.

    qs/ks/vs: the ring's local chunks [B, H, S_local, D] in sequence order,
    chunk ``i`` on slot ``i``'s device; H must divide by the ring's size.
    Returns the local outputs, each on its slot's device."""
    n = len(qs)
    H = qs[0].shape[1]
    if H % n:
        raise ValueError(f"num heads {H} must divide by axis size {n}")
    devices = [q.device for q in qs]
    # sequence-split -> head-split: split heads, join the sequence
    qh, kh, vh = (all_to_all(t, devices, split_dim=1, concat_dim=2) for t in (qs, ks, vs))
    outs = []
    for q, k, v in zip(qh, kh, vh):
        if q.is_cuda and q.shape[2] % 128 == 0:
            outs.append(flash_attention(q, k, v, causal=causal, scale=scale))
        else:
            outs.append(blockwise_attention(q, k, v, causal=causal, scale=scale))
    # head-split -> sequence-split: split the sequence, join heads
    return all_to_all(outs, devices, split_dim=2, concat_dim=1)


def a2a_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    seq_axis: str,
    batch_axis: Optional[str] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Split [B, H, S, D] inputs over ``mesh`` (sequence on ``seq_axis``, batch
    on ``batch_axis`` if given), run :func:`a2a_attention` on each ring and join
    the outputs on q's device."""
    rings = mesh_rings(mesh, seq_axis, batch_axis)
    parts = [split_over_rings(t, rings) for t in (q, k, v)]
    outs = [a2a_attention(qs, ks, vs, causal=causal) for qs, ks, vs in zip(*parts)]
    return join_rings(outs, q.device)
