"""Key -> (block, offset) partitioning over int32 key tensors.

Counterpart of ``harmony_tpu/table/partition.py``, exact int for int: the
reference's jnp ``//`` and ``%`` floor (the remainder takes the divisor's
sign), so this port uses floor division and ``torch.remainder``, never C-style
truncation. Every key maps to a (block, offset) pair addressing the dense
block-major storage ``[num_blocks, block_size, ...]``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _as_keys(keys) -> torch.Tensor:
    return torch.as_tensor(keys).to(torch.int32)


class BlockPartitioner:
    """key -> (block_id, offset) over a fixed key space [0, capacity)."""

    def __init__(self, capacity: int, num_blocks: int) -> None:
        if num_blocks > capacity:
            raise ValueError(
                f"num_blocks={num_blocks} > capacity={capacity}; "
                "TableConfig clamps this — construct partitioners from a config"
            )
        self.capacity = capacity
        self.num_blocks = num_blocks
        # ceil-div: the last block may be partially used; storage pads to a
        # uniform block_size
        self.block_size = -(-capacity // num_blocks)

    def locate(self, keys) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def key_of(self, blocks: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`locate` (needed to init storage cells by key)."""
        raise NotImplementedError


class RangePartitioner(BlockPartitioner):
    """Contiguous key ranges per block (ordered tables): block = key // bs."""

    def locate(self, keys) -> Tuple[torch.Tensor, torch.Tensor]:
        keys = _as_keys(keys)
        return (torch.div(keys, self.block_size, rounding_mode="floor"),
                torch.remainder(keys, self.block_size))

    def key_of(self, blocks: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        return blocks * self.block_size + offsets


class HashPartitioner(BlockPartitioner):
    """Interleaved placement (unordered tables): block = key % num_blocks."""

    def locate(self, keys) -> Tuple[torch.Tensor, torch.Tensor]:
        keys = _as_keys(keys)
        return (torch.remainder(keys, self.num_blocks),
                torch.div(keys, self.num_blocks, rounding_mode="floor"))

    def key_of(self, blocks: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        return offsets * self.num_blocks + blocks
