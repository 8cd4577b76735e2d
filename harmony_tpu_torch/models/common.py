"""Numeric primitives of the model families.

Counterpart of ``harmony_tpu/models/common.py``. ``dense_init`` is the numpy
initialiser of the reference's ``init_numpy`` (``jax.random`` cannot be
reproduced here); ``resolve_attn`` picks flash attention when the tensors lie
on the card and the sequence tiles, where the reference asks for a TPU.

The steps over a mesh of slots share :func:`mesh_slot`, :func:`replica` and
:func:`sgd_update`: the reference's ``shard_map`` gives each device its own
copy of a replicated parameter and inserts the gradient psum; the port gives
each slot its own autograd leaf and adds the slots' gradients in slot order.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from harmony_tpu_torch.parallel.collectives import psum

#: valid values for a model config's ``attn`` field
ATTN_CHOICES = ("auto", "flash", "blockwise")
#: activation dtypes a model config takes by name
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dense_init(rng: np.random.Generator, shape) -> np.ndarray:
    """1/sqrt(fan_in)-scaled normal init for a [fan_in, ...] weight (f32)."""
    return (rng.standard_normal(shape) * shape[0] ** -0.5).astype(np.float32)


def rms_norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """RMSNorm: f32 statistics whatever the activation dtype, cast back to it,
    then scaled by ``w`` in that dtype."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (xf * scale).to(x.dtype) * w


def resolve_dtype(dtype: Any) -> torch.dtype:
    """A model config's activation dtype: a torch dtype, or its name in
    :data:`DTYPES` (the CLI's ``--set dtype=bfloat16``)."""
    if isinstance(dtype, str):
        if dtype not in DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}; choose from {sorted(DTYPES)}")
        return DTYPES[dtype]
    return dtype


def validate_attn(attn: str) -> str:
    if attn not in ATTN_CHOICES:
        raise ValueError(f"unknown attn {attn!r}; choose from {ATTN_CHOICES}")
    return attn


def flash_ok(seq: int, block: Optional[int] = None) -> bool:
    """Can the flash kernels tile this sequence length with the caller's block?
    Blocks clamp to min(block, seq), so any seq <= block tiles; longer
    sequences need divisibility."""
    if block is None:
        from harmony_tpu_torch.ops.attention import DEFAULT_BLOCK_Q

        block = DEFAULT_BLOCK_Q
    return seq % min(block, seq) == 0


def resolve_attn(attn: str, seq: int, on_card: bool, block: Optional[int] = None) -> str:
    """'auto' -> 'flash' when the tensors lie on the card and the kernel can
    tile the sequence, else 'blockwise'."""
    if attn != "auto":
        return attn
    return "flash" if on_card and flash_ok(seq, block) else "blockwise"


def mesh_slot(mesh, coords: Dict[str, int]):
    """The slot of ``mesh`` at ``coords`` (an axis the mesh lacks has size 1,
    index 0)."""
    return mesh.slot_at({a: i for a, i in coords.items() if a in mesh.shape})


def replica(p: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A parameter as an autograd leaf of one slot's own: a detached alias on
    the parameter's device, a copy on another."""
    return p.detach().to(device, non_blocking=True).requires_grad_(True)


def sgd_update(p: torch.Tensor, grads: Sequence[torch.Tensor], learning_rate: float,
               donate: bool) -> torch.Tensor:
    """``p - lr * g`` with ``g`` the slots' gradients added in slot order on
    ``p``'s device; in place when ``donate``."""
    step = psum(grads, p.device) * learning_rate
    return p.sub_(step) if donate else p - step
