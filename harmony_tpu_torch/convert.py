"""Carry state across from the JAX package.

A JAX ``DenseTable``'s storage, read out as numpy (``np.asarray(table.array)``,
shape ``[num_blocks, block_size, *value_shape]``), installs unchanged as this
port's storage: both packages lay a table out block-major with the same
partitioner. Wide&Deep keeps every parameter (embeddings, bias, MLP) as table
rows, so :func:`table_from_numpy` carries a whole model. A JAX
``DeviceHashTable``'s ``(slot_keys, values)`` pair installs the same way
(:func:`hash_table_from_numpy`): both packages place keys in the same slots. A model whose
parameters are a tree (the LM, dense or MoE with its nested ``moe`` dicts, and
ViT) carries over as that tree (:func:`pytree_params_from_numpy`) or as the
table rows it trains from (:func:`pytree_rows_from_numpy`), in
``ravel_pytree``'s flat order. A GBT
ensemble carries over as its tree rows and round counter
(:func:`gbt_tables_from_numpy`), a Pregel job's vertex state as its values in
vertex order (:func:`pregel_vertex_state_from_numpy`). Nothing here imports
JAX; the caller hands over numpy arrays.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from harmony_tpu_torch.models.pytree_trainer import ravel_numpy, tree_map
from harmony_tpu_torch.table.hashtable import DeviceHashTable, HashTableSpec
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


def hash_table_from_numpy(spec: HashTableSpec, slot_keys: np.ndarray, values: np.ndarray,
                          device: DeviceLike = None) -> DeviceHashTable:
    """A ``DeviceHashTable`` of ``spec`` on ``device`` (the card unless asked
    otherwise) whose state is a copy of the JAX table's ``(slot_keys,
    values)``, as ``np.asarray`` reads them out."""
    sk = torch.from_numpy(np.array(slot_keys, copy=True))
    v = torch.from_numpy(np.array(values, copy=True))
    if sk.dtype != torch.int32:
        raise ValueError(f"slot keys dtype {sk.dtype} != torch.int32")
    if v.dtype != spec.dtype:
        raise ValueError(f"values dtype {v.dtype} != {spec.dtype}")
    return DeviceHashTable(spec, device, (sk, v))


def pytree_params_from_numpy(params: Any, device: DeviceLike = None) -> Any:
    """A model's parameter tree (dicts and lists of numpy or JAX arrays: the
    LM's ``init_numpy`` or ``init``, ViT's ``init``) as f32 tensors on
    ``device`` (the card unless asked otherwise)."""
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


def gbt_tables_from_numpy(trainer: Any, trees: np.ndarray, rounds: int,
                          device: DeviceLike = None) -> Tuple[DenseTable, DenseTable]:
    """A ``GBTTrainer``'s model and local tables on ``device`` (the card unless
    asked otherwise) holding an ensemble: ``trees`` are the model table's rows
    in round order, ``[num_rounds, tree_vec_len]`` f32 as the JAX table's
    ``pull_array`` reads them, and ``rounds`` the boosting-round counter (the
    JAX local table's ``get(0)[0]``)."""
    trees = np.asarray(trees, np.float32)
    want = (trainer.num_rounds, trainer.tree_vec_len)
    if trees.shape != want:
        raise ValueError(f"tree rows {trees.shape} != {want}")
    model = DenseTable(TableSpec(trainer.model_table_config()), device)
    model.write_all(trees)
    local = DenseTable(TableSpec(trainer.local_table_config()), device)
    local.write_all(np.full((1, 1), rounds, np.float32))
    return model, local


def pregel_vertex_state_from_numpy(master: Any, values: np.ndarray) -> None:
    """Install a vertex state, ``[num_vertices, state_dim]`` f32 in vertex
    order (the JAX master's ``vertex_table.pull_array()``), into a
    ``PregelMaster`` of this port before it runs."""
    values = np.asarray(values, np.float32)
    want = (master.graph.num_vertices, master.comp.state_dim)
    if values.shape != want:
        raise ValueError(f"vertex state {values.shape} != {want}")
    master.vertex_table.write_all(values)
