"""jax.random's threefry draws, bit for bit, as PyTorch tensor operations.

LDA samples its topics with ``jax.random`` (``harmony_tpu/apps/lda.py``:
``fold_in(PRNGKey(seed), epoch)`` per document, then ``categorical``). To draw
the same topics, this module computes what jax computes with its default
threefry2x32 implementation in partitionable mode (``jax_threefry_partitionable``,
jax's default):

  * :func:`PRNGKey` — ``jax._src.prng.threefry_seed``: the key of a 64-bit
    seed is its (high, low) 32-bit words; a uint32 seed has high word 0.
  * :func:`threefry_2x32` — the 20-round Threefry-2x32 block function
    (``prng._threefry2x32_lowering``).
  * :func:`fold_in` — ``threefry_fold_in``: the key hashed with (0, data).
  * :func:`split` — ``_threefry_split_foldlike``: key i of ``num`` is the
    block function's two output words at counter (i >> 32, i & 0xFFFFFFFF).
  * :func:`random_bits` — ``_threefry_random_bits_partitionable``: counter i of
    the flat output is (i >> 32, i & 0xFFFFFFFF); the two output words are
    XORed.
  * :func:`uniform` — ``jax._src.random._uniform``: 23 random mantissa bits
    under exponent 0, minus 1.0, scaled, floored at ``minval``.
  * :func:`gumbel` — ``_gumbel`` in mode "low": ``-log(-log(u))`` for u uniform
    on [tiny, 1).
  * :func:`categorical` — ``argmax(logits + gumbel)``.

uint32 arithmetic runs in int64 tensors holding values in [0, 2**32), masked
after every add and shift, so it is the same on the CPU and the card. Keys are
int64 tensors of shape ``[..., 2]``; every function takes a batch of keys, as
``jax.vmap`` over keys does, and draws ``shape`` values for each.

The bits are exact. The floats go through ``log``, which PyTorch and XLA may
round differently in the last bit, so a gumbel value may differ by an ulp and
an argmax between two near-equal scores may differ.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000   # 1.0f
_MANTISSA_BITS = 23
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry_2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                  x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words ``(x1, x2)`` under the key
    words ``(k1, k2)``; all int64 tensors of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed: torch.Tensor) -> torch.Tensor:
    """Keys ``[..., 2]`` of integer seeds ``[...]``, each read as a 64-bit value."""
    s = seed.to(torch.int64)
    return torch.stack([(s >> 32) & MASK, s & MASK], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` of keys ``[..., 2]`` with uint32 data (a tensor
    broadcast against the keys' batch shape)."""
    d = data.to(torch.int64) & MASK
    y1, y2 = threefry_2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split(key, num)`` of keys ``[..., 2]``: ``[..., num, 2]``."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry_2x32(key[..., 0, None], key[..., 1, None], idx >> 32, idx & MASK)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits a value: ``[*key.shape[:-1], *shape]`` int64 in [0, 2**32)."""
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    expand = (..., *([None] * len(shape)))
    y1, y2 = threefry_2x32(key[..., 0][expand], key[..., 1][expand],
                           idx >> 32, idx & MASK)
    return y1 ^ y2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform on [minval, maxval), ``[*key.shape[:-1], *shape]``."""
    bits = random_bits(key, shape)
    f = ((bits >> (32 - _MANTISSA_BITS)) | _ONE_F32_BITS).to(torch.int32)
    floats = f.view(torch.float32) - 1.0
    # jax rounds minval and maxval to float32 and takes hi - lo in float32;
    # each value here is a float32 held exactly in a Python float, so the
    # tensor ops below compute the same float32 arithmetic without copying a
    # scalar from the host (a copy that would wait for the device).
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(lo))
    return torch.clamp_min(floats * scale + lo, lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 standard Gumbel draws (jax's mode "low")."""
    return -torch.log(-torch.log(uniform(key, shape, minval=_F32_TINY, maxval=1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw from each categorical over the last axis of float32 ``logits``
    ``[*key.shape[:-1], *rest, K]`` -> int64 ``[*key.shape[:-1], *rest]``; the
    first index wins a tie, as ``jnp.argmax``."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical takes float32 logits, not {logits.dtype}")
    per_key = logits.shape[key.ndim - 1:]
    return torch.argmax(gumbel(key, per_key) + logits, dim=-1)
