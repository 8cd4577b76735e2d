"""Carry state across from the JAX package.

A JAX ``DenseTable``'s storage, read out as numpy (``np.asarray(table.array)``,
shape ``[num_blocks, block_size, *value_shape]``), installs unchanged as this
port's storage: both packages lay a table out block-major with the same
partitioner. Wide&Deep keeps every parameter (embeddings, bias, MLP) as table
rows, so :func:`table_from_numpy` carries a whole model. A model whose
parameters are a tree (the LM) carries over as that tree
(:func:`lm_params_from_numpy`) or as the table rows it trains from
(:func:`pytree_rows_from_numpy`), in ``ravel_pytree``'s flat order. Nothing here
imports JAX; the caller hands over numpy arrays.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from harmony_tpu_torch.models.pytree_trainer import ravel_numpy, tree_map
from harmony_tpu_torch.table.table import DenseTable, TableSpec
from harmony_tpu_torch.utils.platform import DeviceLike, resolve_device


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


def lm_params_from_numpy(params: Any, device: DeviceLike = None) -> Any:
    """The LM's parameter tree (dicts and lists of numpy arrays, as the JAX
    package's ``init_numpy`` or ``np.asarray`` of its ``init`` gives it) as f32
    tensors on ``device`` (the card unless asked otherwise)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=dev), params)


def pytree_rows_from_numpy(params: Any, row_width: int) -> np.ndarray:
    """The parameter tree flattened in ``ravel_pytree``'s order and cut into
    zero-padded rows: ``[num_rows, row_width]`` f32, the param section of a
    ``PyTreeTrainer`` table."""
    flat = ravel_numpy(params)
    num_rows = -(-flat.shape[0] // row_width)
    out = np.zeros((num_rows * row_width,), np.float32)
    out[: flat.shape[0]] = flat
    return out.reshape(num_rows, row_width)
