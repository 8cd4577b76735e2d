"""DenseTable — the partitioned model table, on one device.

Counterpart of ``harmony_tpu/table/table.py``. Storage is ONE dense tensor
``[num_blocks, block_size, *value_shape]``; keys map to (block, offset) through
the table's hash or range partitioner. :class:`TableSpec` holds the device ops
a trainer's step calls (pull, push, push_all, write_all); :class:`DenseTable`
is the host-side handle that serialises access to the storage.

The reference's device state is functional: a step takes the array and
returns a new one, and JAX donates the old buffer. Here the ops update the
storage IN PLACE instead (no second table-sized buffer per step) and return
it. What made the functional version safe is kept by the lock: a step runs
and commits under the table lock (:meth:`DenseTable.apply_step`), and host
readers (:meth:`DenseTable.multi_get`, :meth:`DenseTable.pull_array`) copy
under the same lock, so no reader sees a half-applied push.

The keyed pull goes through ``gather_rows`` (K1); the keyed push's duplicate
fold through ``weighted_histogram``/``segment_sum`` (K3, ``via="mxu"``) or
``segment_sum_rows`` (K2, ``via="sparse"``). On the card these are the
hand-written kernels; on the CPU their plain versions.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.ops.histogram import segment_sum
from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows, value_width
from harmony_tpu_torch.table.partition import (
    BlockPartitioner,
    HashPartitioner,
    RangePartitioner,
)
from harmony_tpu_torch.table.update import UpdateFunction, get_update_fn
from harmony_tpu_torch.utils.platform import DeviceLike, env_choice, resolve_device

PUSH_ROUTES = ("scatter", "mxu", "mxu_auto", "sparse")


class TableSpec:
    """Static description of a table + its device ops (which update the
    storage in place and return it)."""

    def __init__(self, config: TableConfig,
                 update_fn: Optional[UpdateFunction] = None) -> None:
        self.config = config
        self.update_fn = update_fn or get_update_fn(config.update_fn)
        part_cls = RangePartitioner if config.is_ordered else HashPartitioner
        self.partitioner: BlockPartitioner = part_cls(config.capacity,
                                                      config.num_blocks)
        self.value_shape: Tuple[int, ...] = tuple(config.value_shape)
        self.dtype: torch.dtype = getattr(torch, config.dtype)

    @property
    def table_id(self) -> str:
        return self.config.table_id

    @property
    def num_blocks(self) -> int:
        return self.partitioner.num_blocks

    @property
    def block_size(self) -> int:
        return self.partitioner.block_size

    @property
    def num_rows(self) -> int:
        """Stored rows, padding of the last block included."""
        return self.num_blocks * self.block_size

    @property
    def storage_shape(self) -> Tuple[int, ...]:
        return (self.num_blocks, self.block_size, *self.value_shape)

    def _is_range(self) -> bool:
        return isinstance(self.partitioner, RangePartitioner)

    def _all_keys(self, device: torch.device) -> torch.Tensor:
        return torch.arange(self.config.capacity, dtype=torch.int32, device=device)

    # -- device ops -------------------------------------------------------

    def init_array(self, device: torch.device) -> torch.Tensor:
        """Initial storage from the update fn's ``init`` (getOrInit semantics:
        every key starts at its init value), broadcast to the value shape."""
        b = torch.arange(self.num_blocks, dtype=torch.int32, device=device)[:, None]
        o = torch.arange(self.block_size, dtype=torch.int32, device=device)[None, :]
        keys = self.partitioner.key_of(b, o).reshape(-1)
        vals = self.update_fn.init(keys)
        if vals.ndim == 1 and self.value_shape:
            vals = vals.reshape(-1, *([1] * len(self.value_shape))).expand(
                keys.shape[0], *self.value_shape)
        return vals.to(self.dtype).reshape(self.storage_shape).contiguous()

    def _flat_index(self, b: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        return (b * self.block_size + o).to(torch.int32)

    def _in_bounds(self, b: torch.Tensor, o: torch.Tensor):
        """Flat rows of the (block, offset) pairs inside the storage, and the
        mask of those pairs: out-of-range pairs write nothing. The reference's
        scatter drops pairs past the end but wraps a negative block or offset
        NumPy-style (key -1 of a range table lands on the last padding row);
        its own folds (``mxu``, ``sparse``) drop negative ids. The port drops
        every out-of-range pair, on every route."""
        ok = (b >= 0) & (b < self.num_blocks) & (o >= 0) & (o < self.block_size)
        return self._flat_index(b[ok], o[ok]).long(), ok

    def pull(self, arr: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        """multiGetOrInit: gather values for ``keys`` -> [*keys.shape, *value_shape]
        through ``gather_rows`` (K1)."""
        b, o = self.partitioner.locate(keys)
        flat_idx = self._flat_index(b, o)
        flat = arr.reshape(self.num_rows, value_width(self.value_shape))
        rows = gather_rows(flat, flat_idx.reshape(-1))
        return rows.reshape(*flat_idx.shape, *self.value_shape)

    def pull_all(self, arr: torch.Tensor) -> torch.Tensor:
        """Whole table as ``[capacity, *value_shape]`` in key order. For a range
        table this is a VIEW of the storage."""
        if self._is_range():
            flat = arr.reshape(self.num_rows, *self.value_shape)
            return flat[: self.config.capacity]
        return self.pull(arr, self._all_keys(arr.device))

    def _post_touched(self, arr: torch.Tensor, b: torch.Tensor, o: torch.Tensor) -> None:
        flat = arr.view(self.num_rows, *self.value_shape)
        idx, _ = self._in_bounds(b.reshape(-1), o.reshape(-1))
        flat[idx] = self.update_fn.post(flat[idx])

    def push(self, arr: torch.Tensor, keys: torch.Tensor, deltas: torch.Tensor,
             *, via: str = "auto") -> torch.Tensor:
        """multiUpdate: fold ``deltas`` into the table IN PLACE (duplicate keys
        fold per the update fn's scatter_mode) and return ``arr``.

        ``via`` picks the lowering of additive pushes, as in the reference:
          * "scatter" — one indexed scatter (``index_add_`` / ``index_reduce_``
            / indexed set).
          * "mxu" — fold duplicates with ``segment_sum`` (K3) into a flat-row
            delta and apply ONE dense add.
          * "mxu_auto" — "mxu" when the push touches >= capacity/256 keys
            (at least 32), else "scatter".
          * "sparse" — fold with ``segment_sum_rows`` (K2), then one dense add.
          * "auto" — "scatter" (callers that know the device pass
            ``DenseTable.push_via`` explicitly).
        """
        b, o = self.partitioner.locate(keys)
        mode = self.update_fn.scatter_mode
        if via == "auto":
            via = "scatter"
        elif via == "mxu_auto":
            dense_enough = keys.shape[0] >= max(32, self.config.capacity // 256)
            via = "mxu" if mode == "add" and dense_enough else "scatter"
        if via in ("mxu", "sparse"):
            if mode != "add":
                raise ValueError(f"via={via!r} requires an additive update fn")
            fold = segment_sum if via == "mxu" else segment_sum_rows
            n = keys.shape[0]
            folded = fold(deltas.reshape(n, -1).float(),
                          self._flat_index(b, o).reshape(-1), self.num_rows)
            arr.add_(folded.reshape(arr.shape).to(arr.dtype))  # in place
        elif via == "scatter":
            flat = arr.view(self.num_rows, *self.value_shape)
            idx, ok = self._in_bounds(b.reshape(-1), o.reshape(-1))
            d = deltas.reshape(-1, *self.value_shape).to(arr.dtype)[ok]
            if mode == "add":
                flat.index_add_(0, idx, d)
            elif mode == "min":
                flat.index_reduce_(0, idx, d, "amin")
            elif mode == "max":
                flat.index_reduce_(0, idx, d, "amax")
            elif mode == "set":
                flat[idx] = d
            else:
                raise ValueError(f"unknown scatter_mode {mode!r}")
        else:
            raise ValueError(f"unknown push route {via!r}")
        if self.update_fn.post is not None:
            # apply-time invariant on the touched entries only
            self._post_touched(arr, b, o)
        return arr

    def _pad_to_storage(self, values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """[capacity, *vshape] in key order -> storage layout (range tables)."""
        pad = self.num_rows - self.config.capacity
        v = values.to(dtype)
        if pad:
            v = torch.cat([v, torch.zeros((pad, *self.value_shape), dtype=dtype,
                                          device=v.device)])
        return v.reshape(self.storage_shape)

    def push_all(self, arr: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
        """Dense full-model push of a ``[capacity, *value_shape]`` delta into
        every key, IN PLACE; returns ``arr``."""
        mode = self.update_fn.scatter_mode
        if not self._is_range():
            return self.push(arr, self._all_keys(arr.device), deltas)
        if mode == "set":
            return self.write_all(arr, deltas)
        d = self._pad_to_storage(deltas, arr.dtype)
        if mode == "add":
            arr.add_(d)
        elif mode == "min":
            torch.minimum(arr, d, out=arr)
        elif mode == "max":
            torch.maximum(arr, d, out=arr)
        else:
            raise ValueError(f"unknown scatter_mode {mode!r}")
        if self.update_fn.post is not None:
            arr.copy_(self.update_fn.post(arr))  # every entry is touched here
        return arr

    def write_all(self, arr: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        """Overwrite the whole table from ``[capacity, *value_shape]`` in key
        order, IN PLACE; returns ``arr``."""
        if self._is_range():
            arr.copy_(self._pad_to_storage(values, self.dtype))
            return arr
        b, o = self.partitioner.locate(self._all_keys(arr.device))
        arr[b.long(), o.long()] = values.to(self.dtype)
        return arr


class DenseTable:
    """Host-side handle on one device: serialised steps and host accessors.

    Every write (a step's commit, multi_update, multi_put, write_all) and every
    host read happens under ``_lock``; storage writes bump ``data_version``."""

    def __init__(self, spec: TableSpec, device: DeviceLike = None,
                 arr: Optional[torch.Tensor] = None) -> None:
        self.spec = spec
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        if arr is None:
            arr = spec.init_array(self.device)
        elif tuple(arr.shape) != spec.storage_shape:
            raise ValueError(
                f"storage shape {tuple(arr.shape)} != {spec.storage_shape}")
        self._arr = arr.to(self.device, spec.dtype).contiguous()
        self._data_version = 0

    @property
    def array(self) -> torch.Tensor:
        """The live storage. Steps update it in place: a host reader that needs
        a stable value copies it under the table lock (multi_get, pull_array)."""
        with self._lock:
            return self._arr

    @property
    def data_version(self) -> int:
        """Monotonic count of storage writes."""
        with self._lock:
            return self._data_version

    def commit(self, new_arr: torch.Tensor) -> None:
        """Install the post-step storage (a step that updated in place hands
        back the same tensor) and count the write."""
        with self._lock:
            if (tuple(new_arr.shape) != self.spec.storage_shape
                    or new_arr.dtype != self.spec.dtype
                    or new_arr.device != self._arr.device):
                raise ValueError("commit: storage shape, dtype or device changed")
            self._arr = new_arr
            self._data_version += 1

    def apply_step(self, step_fn: Callable, *extra):
        """Run ``step_fn(arr, *extra) -> (new_arr, aux)`` and commit its result,
        both under the table lock, so no host accessor sees a half-applied
        step. Returns ``aux``."""
        with self._lock:
            new_arr, aux = step_fn(self._arr, *extra)
            self.commit(new_arr)
        return aux

    def apply_step_with(self, local: "DenseTable", step_fn: Callable, *extra):
        """Run ``step_fn(arr, local_arr, *extra) -> ((new_arr, new_local), aux)``
        and commit both results; each table's commit runs under its own lock.
        Returns ``aux``.

        Lock order: this (the job's model) table's lock, then ``local``'s. Every
        path that holds both takes them in that order and every host accessor
        takes one, so no two threads (two jobs, or a job and a reader) can each
        hold one of the pair and wait for the other."""
        with self._lock, local._lock:
            (new_arr, new_local), aux = step_fn(self._arr, local._arr, *extra)
            self.commit(new_arr)
            local.commit(new_local)
        return aux

    def _to_device(self, x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def multi_get(self, keys: Sequence[int]) -> np.ndarray:
        """Values of ``keys`` as a host array, copied under the lock."""
        k = self._to_device(keys, torch.int32)
        with self._lock:
            return self.spec.pull(self._arr, k).cpu().numpy()

    @property
    def push_via(self) -> str:
        """Keyed-push route for this table's device: the size-gated fold
        ("mxu_auto") for additive tables on the card, the scatter on the CPU.
        ``HARMONY_PUSH_VIA`` (scatter|mxu|mxu_auto|sparse) overrides."""
        forced = env_choice("HARMONY_PUSH_VIA", PUSH_ROUTES)
        if forced:
            return forced
        return ("mxu_auto"
                if self.device.type == "cuda"
                and self.spec.update_fn.scatter_mode == "add"
                else "scatter")

    def multi_update(self, keys: Sequence[int], deltas) -> None:
        k = self._to_device(keys, torch.int32)
        d = self._to_device(deltas)
        with self._lock:
            self.spec.push(self._arr, k, d, via=self.push_via)
            self._data_version += 1

    def multi_put(self, keys: Sequence[int], values) -> None:
        """Bulk set (the bulk-load insertion path); out-of-range keys write
        nothing."""
        k = self._to_device(keys, torch.int32)
        v = self._to_device(values)
        b, o = self.spec.partitioner.locate(k)
        with self._lock:
            ok = ((b >= 0) & (b < self.spec.num_blocks)
                  & (o >= 0) & (o < self.spec.block_size))
            self._arr[b[ok].long(), o[ok].long()] = v[ok].to(self.spec.dtype)
            self._data_version += 1

    def write_all(self, values) -> None:
        """Whole-table key-order overwrite."""
        v = self._to_device(values)
        with self._lock:
            self.spec.write_all(self._arr, v)
            self._data_version += 1

    def pull_array(self) -> torch.Tensor:
        """Full table in key order, as a device tensor copied under the lock."""
        with self._lock:
            return self.spec.pull_all(self._arr).clone()
