"""Numeric primitives of the model families.

Counterpart of ``harmony_tpu/models/common.py``. ``dense_init`` is the numpy
initialiser of the reference's ``init_numpy`` (``jax.random`` cannot be
reproduced here); ``resolve_attn`` picks flash attention when the tensors lie
on the card and the sequence tiles, where the reference asks for a TPU.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

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
