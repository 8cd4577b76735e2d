"""Ring attention: exact attention over a sequence split across the slots of a ring.

Counterpart of ``harmony_tpu/ops/ring.py``. Long-context training splits the
sequence over the slots of a mesh axis: each slot holds a q/k/v chunk, the k/v
chunks travel around the ring, and every slot folds each visiting chunk into
its own online-softmax state, so the full-sequence softmax stays exact.

The reference runs :func:`ring_attention` per device inside ``shard_map``,
rotating with ``lax.ppermute``. The port is one process driving every slot, so
:func:`ring_attention` takes the local chunks of one ring (one tensor a slot,
in ring order, each on its slot's device) and returns the local outputs; a
rotation is :func:`~harmony_tpu_torch.parallel.collectives.ppermute`, a peer
copy between cards and a device copy between slots of one device, and
autograd carries dK/dV back around the ring. :func:`ring_self_attention`
splits global tensors over a mesh's slots and joins the outputs, as the
reference's wrapper does.

Two inners fold a chunk:

  * ``"einsum"`` — the reference's streaming-softmax fold in f32, with the
    finite ``-1e30`` mask and ``l = max(l, 1e-30)``; any device.
  * ``"flash"`` — each chunk through :func:`flash_attention_lse` (K4, with K5a
    and K5b in the backward) on q pre-scaled to f32 and k/v cast to f32
    (``scale=1``), merged across chunks through their log-sum-exps; the
    backward then runs K5a/K5b with a nonzero LSE cotangent. On the card that
    is the ``simt`` route at blocks of 256 clamped to the chunk.
  * ``"auto"`` — ``"flash"`` when the chunks lie on a card, ``"einsum"`` on the
    CPU; ``HARMONY_RING_INNER`` overrides. (The reference picks flash only on
    one attached TPU chip, where its Mosaic kernel under ``shard_map`` had been
    captured; see ROADMAP's known differences.)

A causal ring skips the chunks that lie wholly above the diagonal: a skipped
chunk launches nothing and leaves the state as it was (the reference's einsum
inner computes and masks it, which adds exact zeros; the bits are the same).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from harmony_tpu_torch.ops.attention import DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q, flash_attention_lse
from harmony_tpu_torch.parallel.collectives import ppermute
from harmony_tpu_torch.parallel.mesh import Mesh
from harmony_tpu_torch.utils.platform import env_choice

_NEG_INF = -1e30
INNERS = ("flash", "einsum")


def _resolve_inner(inner: str, on_card: bool = False) -> str:
    """The inner a ring takes: ``"auto"`` is ``HARMONY_RING_INNER`` when set,
    else flash on the card and einsum on the CPU."""
    if inner == "auto":
        forced = env_choice("HARMONY_RING_INNER", INNERS)
        if forced:
            return forced
        return "flash" if on_card else "einsum"
    if inner not in INNERS:
        raise ValueError(f"unknown ring inner {inner!r}")
    return inner


def ring_attention(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    causal: bool = False,
    scale: Optional[float] = None,
    inner: str = "auto",
) -> List[torch.Tensor]:
    """Exact attention over a sequence split along one ring of slots.

    qs/ks/vs: the ring's local chunks [B, H, S_local, D], in ring (sequence)
    order, chunk ``i`` on slot ``i``'s device. Returns the local outputs
    [B, H, S_local, D] in q's dtype, each on its slot's device."""
    n = len(qs)
    S, D = qs[0].shape[2], qs[0].shape[3]
    scale = scale if scale is not None else D ** -0.5
    devices = [q.device for q in qs]
    inner = _resolve_inner(inner, qs[0].is_cuda)
    qf = [q.float() * scale for q in qs]
    fold = _flash_fold if inner == "flash" else _einsum_fold
    state = [_empty_state(q) for q in qf]
    kb, vb = list(ks), list(vs)
    for t in range(n):
        if t:  # the last visiting chunk is folded with no rotation after it
            kb, vb = ppermute(kb, devices), ppermute(vb, devices)
        for my in range(n):
            src = (my - t) % n
            if causal and src > my:
                continue  # wholly above the diagonal
            state[my] = fold(state[my], qf[my], kb[my].float(), vb[my].float(),
                             causal, my * S, src * S)
    return [(num / den.clamp_min(1e-30)[..., None]).to(q.dtype)
            for (num, _, den), q in zip(state, qs)]


def _empty_state(qf):
    """A chunk's softmax state before any fold: zeros, the finite -inf, zeros."""
    rows = qf.shape[:-1]
    return (torch.zeros_like(qf),
            torch.full(rows, _NEG_INF, dtype=torch.float32, device=qf.device),
            torch.zeros(rows, dtype=torch.float32, device=qf.device))


def _einsum_fold(st, qf, kb, vb, causal, q0, k0):
    """Merge one visiting chunk (first key at global position ``k0``) into the
    streaming softmax state (acc, m, l) of the chunk whose first query is at
    ``q0``."""
    acc, m, l = st
    s = qf @ kb.transpose(-1, -2)
    if causal:
        S = qf.shape[2]
        q_pos = q0 + torch.arange(S, device=qf.device)[:, None]
        kv_pos = k0 + torch.arange(S, device=qf.device)[None, :]
        s = torch.where(q_pos >= kv_pos, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + p @ vb
    return acc_new, m_new, l_new


def _flash_fold(st, qf, kb, vb, causal, q0, k0):
    """One visiting chunk through the flash kernels (the diagonal chunk causal,
    any other in full) and merged through its LSE into (num, m, den): num the
    output unnormalised in the running frame m, den the normaliser. Both
    guards stay: exp(x - m_new) with x at the finite floor weighs 0, not 1."""
    o_t, lse_t = flash_attention_lse(qf, kb, vb, causal and q0 == k0,
                                     DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K, 1.0)
    num, m, den = st
    m_new = torch.maximum(m, lse_t)
    c_prev = torch.where(m <= _NEG_INF / 2, 0.0, torch.exp(m - m_new))
    c_new = torch.where(lse_t <= _NEG_INF / 2, 0.0, torch.exp(lse_t - m_new))
    return num * c_prev[..., None] + o_t * c_new[..., None], m_new, den * c_prev + c_new


def mesh_rings(mesh: Mesh, seq_axis: str, batch_axis: Optional[str] = None):
    """The rings of ``mesh`` along ``seq_axis``: one list of slots for each
    index of ``batch_axis`` (one ring without it), every other axis at index 0
    (the reference's shard_map replicates over them)."""
    n = mesh.shape[seq_axis]
    rows = mesh.shape[batch_axis] if batch_axis else 1
    return [[mesh.slot_at({seq_axis: i, **({batch_axis: b} if batch_axis else {})})
             for i in range(n)] for b in range(rows)]


def split_over_rings(x: torch.Tensor, rings) -> List[List[torch.Tensor]]:
    """[B, H, S, D] cut into batch rows (one a ring) and sequence chunks (one a
    slot), each on its slot's device."""
    return [[c.to(slot.device, non_blocking=True)
             for c, slot in zip(row.chunk(len(ring), dim=2), ring)]
            for row, ring in zip(x.chunk(len(rings), dim=0), rings)]


def join_rings(outs: List[List[torch.Tensor]], device: torch.device) -> torch.Tensor:
    """The inverse of :func:`split_over_rings`, on ``device``."""
    return torch.cat([torch.cat([c.to(device, non_blocking=True) for c in row], dim=2)
                      for row in outs], dim=0)


def ring_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    seq_axis: str,
    batch_axis: Optional[str] = None,
    causal: bool = False,
    inner: str = "auto",
) -> torch.Tensor:
    """Split [B, H, S, D] inputs over ``mesh`` (sequence on ``seq_axis``, batch
    on ``batch_axis`` if given), run :func:`ring_attention` on each ring and
    join the outputs on q's device. Differentiable end to end."""
    rings = mesh_rings(mesh, seq_axis, batch_axis)
    parts = [split_over_rings(t, rings) for t in (q, k, v)]
    outs = [ring_attention(qs, ks, vs, causal=causal, inner=inner)
            for qs, ks, vs in zip(*parts)]
    return join_rings(outs, q.device)
