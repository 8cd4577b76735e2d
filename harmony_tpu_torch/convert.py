"""Carry a table's storage across from the JAX package.

A JAX ``DenseTable``'s storage, read out as numpy (``np.asarray(table.array)``,
shape ``[num_blocks, block_size, *value_shape]``), installs unchanged as this
port's storage: both packages lay a table out block-major with the same
partitioner. Wide&Deep keeps every parameter (embeddings, bias, MLP) as table
rows, so this one function carries a whole model. Nothing here imports JAX;
the caller hands over the numpy array.
"""
from __future__ import annotations

import numpy as np
import torch

from harmony_tpu_torch.table.table import DenseTable, TableSpec
from harmony_tpu_torch.utils.platform import DeviceLike


def table_from_numpy(spec: TableSpec, arr: np.ndarray,
                     device: DeviceLike = None) -> DenseTable:
    """A ``DenseTable`` of ``spec`` on ``device`` (the card unless asked
    otherwise) whose storage is a copy of ``arr``."""
    storage = torch.from_numpy(np.array(arr, copy=True))
    if tuple(storage.shape) != spec.storage_shape:
        raise ValueError(f"storage shape {tuple(storage.shape)} != {spec.storage_shape}")
    if storage.dtype != spec.dtype:
        raise ValueError(f"storage dtype {storage.dtype} != {spec.dtype}")
    return DenseTable(spec, device, storage)
