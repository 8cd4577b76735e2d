"""Mixture-of-Experts FFN (Switch-style top-1 routing), on one device.

Counterpart of ``harmony_tpu/models/moe.py`` without its expert parallelism.
Semantics are the reference's: each token goes to the expert of its largest
router probability (f32 softmax; the first index wins a tie, as ``jnp.argmax``)
at that probability as its gate; an expert takes at most C = ceil(T *
capacity_factor / E) tokens, in token order; a token past its expert's
capacity is dropped and outputs 0 (callers keep the residual); the Switch aux
loss is E * sum_e (fraction of tokens routed to e) * (mean router prob of e).

The reference dispatches with one-hot einsums over [T, E, C] tensors. At the
bench-lm MoE size (T = 32,768, E = 8, C = 6,144) each is 6.4 GB of f32 that
autograd keeps, so the port computes the same thing with indices: each token's
slot in its expert's bucket is the count of earlier tokens routed there (the
reference's exclusive cumsum), kept tokens are copied into an [E, C, d] f32
buffer, the expert FFN runs as two batched products (f32, tanh GELU), and each
token reads its row back scaled by its gate. Every non-zero term of the
reference's one-hot sums is a single product, so the dispatched rows are
exactly the reference's. Each (expert, slot) holds at most one token and each
token at most one slot; the only shared index is a trash row past the buffer
that dropped tokens write to and read zeros from, whose gradient is discarded.
So neither pass depends on the order of a float atomic.

Expert parallelism (``axis_name``: experts sharded over a mesh axis, buckets
exchanged all-to-all) is not ported yet: ROADMAP A.9.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    d_model: int
    d_ff: int
    capacity_factor: float = 1.5

    def capacity(self, num_tokens: int) -> int:
        return max(1, -(-int(num_tokens * self.capacity_factor) // self.num_experts))


def init_moe_params(rng: np.random.Generator, cfg: MoEConfig) -> Dict[str, np.ndarray]:
    """Router and expert-stacked FFN weights, numpy f32: the layout, scaling and
    draw order of the reference's ``TransformerLM.init_numpy`` MoE branch (its
    ``init_moe_params`` draws from ``jax.random``, which is not reproduced)."""
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": (rng.standard_normal((d, E)) * d ** -0.5).astype(np.float32),
        "w1": (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32),
        "w2": (rng.standard_normal((E, f, d)) * f ** -0.5).astype(np.float32),
    }


class Routing(NamedTuple):
    expert: torch.Tensor   # [T] int64, argmax of the router probabilities
    slot: torch.Tensor     # [T] int64, the count of earlier tokens routed to that expert
    keep: torch.Tensor     # [T] bool, slot < capacity
    dest: torch.Tensor     # [T] int64, expert * C + slot, or E * C (the trash row) if dropped
    gate: torch.Tensor     # [T] f32, the router probability of that expert (differentiable)
    aux: torch.Tensor      # [] f32, the Switch load-balance loss (differentiable)


def route(x: torch.Tensor, router: torch.Tensor, num_experts: int,
          capacity: int) -> Routing:
    """Top-1 routing of tokens ``x`` [T, d] (the reference's
    ``_dispatch_combine`` without its [T, E, C] tensors)."""
    probs = torch.softmax(x.float() @ router, dim=-1)            # [T, E] f32
    expert = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    experts = torch.arange(num_experts, device=x.device)
    # [E, T]: the prefix count runs along the inner dimension, a parallel scan
    # on the card (along T in a [T, E] layout it is E serial scans)
    onehot = (experts[:, None] == expert[None, :]).long()
    slot = (torch.cumsum(onehot, dim=1) - onehot).gather(0, expert[None, :])[0]
    keep = slot < capacity
    dest = torch.where(keep, expert * capacity + slot,
                       torch.full_like(slot, num_experts * capacity))
    frac = onehot.float().mean(dim=1)
    aux = num_experts * torch.sum(frac * probs.mean(dim=0))
    return Routing(expert, slot, keep, dest, gate, aux)


def dispatch(x: torch.Tensor, r: Routing, num_experts: int, capacity: int) -> torch.Tensor:
    """Kept tokens' rows in f32 at their (expert, slot): [E, C, d], zeros in
    the empty slots. Each kept row is copied, not summed."""
    d = x.shape[1]
    buf = x.new_zeros((num_experts * capacity + 1, d), dtype=torch.float32)
    buf = buf.index_copy(0, r.dest, x.float())
    return buf[:-1].view(num_experts, capacity, d)


def combine(ye: torch.Tensor, r: Routing) -> torch.Tensor:
    """Each token's expert output row times its gate, 0 for a dropped token:
    [T, d] f32 from ye [E, C, d]."""
    rows = torch.cat([ye.reshape(-1, ye.shape[-1]), ye.new_zeros((1, ye.shape[-1]))])
    return rows.index_select(0, r.dest) * (r.gate * r.keep)[:, None]


def moe_ffn(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,                     # [T, d] tokens
    cfg: MoEConfig,
    axis_name: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [T, d] in x's dtype, aux loss f32), all experts local."""
    if axis_name is not None:
        raise NotImplementedError(
            "expert parallelism (moe_ffn with axis_name) is not ported yet: ROADMAP A.9")
    E, C = cfg.num_experts, cfg.capacity(x.shape[0])
    r = route(x, params["router"], E, C)
    # the expert FFN on the buckets, f32: gelu(xe w1) w2 per expert
    h = F.gelu(torch.bmm(dispatch(x, r, E, C), params["w1"]), approximate="tanh")
    return combine(torch.bmm(h, params["w2"]), r).to(x.dtype), r.aux
