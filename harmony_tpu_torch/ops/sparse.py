"""Sparse table kernels — batched row gather (K1) and row-granular segment-sum (K2).

Counterpart of ``harmony_tpu/ops/sparse.py``. The keyed pull of a table
(``TableSpec.pull``, multi_get) is :func:`gather_rows`; the duplicate fold of
the ``via="sparse"`` keyed push is :func:`segment_sum_rows`. On a CUDA tensor
each wrapper launches its hand-written kernel (``csrc/gather_rows.cu``,
``csrc/keyed_fold.cu``); on a CPU tensor it takes the plain PyTorch version
beside it (``*_plain``), which the tests hold against the JAX package. There
is no fallback: a CUDA tensor the kernel does not take raises.

Numerical contract (as the reference's): the gather is byte-identical on both
routes; the fold is deterministic on the card (no float atomics) and adds each
row's contributions in index order from 0.0, the order of the CPU's
``index_add_``, so on the card it gives the same bits as the plain version on
the CPU. The card's own ``index_add_`` adds with atomics, in an order that
changes from run to run: it agrees exactly for integer-valued deltas and to
float tolerance otherwise.

The fold's kernel buckets the ids by destination tile before it folds
(``csrc/keyed_fold.cu``, which owns that geometry); :func:`fold_buffers` takes
its output and its int32 scratch from one allocation.

Every launch runs under ``torch.cuda.device`` of its operands' card (the
launch goes to the current device, and the fold sets its shared-memory
attribute there; the guard takes ``get_device()``, whose -1 for a CPU tensor
changes nothing), and operands on two devices are refused (``use_kernel``). Each wrapper counts its kernel launches in ``<wrapper>.launches``, a plain
integer raised by one where it launches and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from harmony_tpu_torch.ops import cuda_lib
from harmony_tpu_torch.utils.platform import use_kernel


def _stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s card, without building a
    ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _check_kernel_operand(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous for the CUDA kernel")


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[clamp(idx, 0, R-1)]``: negative ids clamp to row 0, they do not
    wrap as Python indexing would."""
    R = table.shape[0]
    if R == 0 and idx.numel():
        raise ValueError("gather from an empty table")
    return table[idx.long().clamp(0, max(R - 1, 0))]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = table[clamp(idx[i], 0, R-1)]`` — table [R, W], idx [N] -> [N, W].

    The batched embedding gather behind ``TableSpec.pull`` / multi_get. On the
    card: a table of 2- or 4-byte elements (f32, bf16, f16, int32: the kernel
    copies bytes), idx int32, both contiguous; 1- and 8-byte elements raise."""
    if table.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"bad shapes table={tuple(table.shape)} idx={tuple(idx.shape)}")
    if not use_kernel(table, idx):
        return gather_rows_plain(table, idx)
    R, W = table.shape
    N = idx.shape[0]
    if table.element_size() not in (2, 4) or table.is_complex():
        raise TypeError(f"gather_rows kernel takes tables of 2- or 4-byte elements, "
                        f"not {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows kernel takes int32 ids, not {idx.dtype}")
    _check_kernel_operand(table, "table")
    _check_kernel_operand(idx, "idx")
    if R == 0 and N:
        raise ValueError("gather from an empty table")
    out = torch.empty((N, W), dtype=table.dtype, device=table.device)
    if N == 0 or W == 0:
        return out
    with torch.cuda.device(table.get_device()):
        cuda_lib.launch(
            "harmony_gather_rows", table.data_ptr(), idx.data_ptr(), out.data_ptr(),
            R, W, N, table.element_size(), _stream(table))
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


@functools.lru_cache(maxsize=256)
def fold_scratch_ints(n: int, width: int, num_rows: int) -> int:
    """The int32s of scratch the keyed fold takes for ``n`` ids of ``width``
    into ``num_rows`` rows. The library owns the fold's geometry and answers;
    raises ValueError for a fold it does not take."""
    ints = ctypes.c_longlong(0)
    if cuda_lib.call("harmony_fold_scratch_ints", n, width, num_rows, ctypes.byref(ints)):
        raise ValueError(
            f"the keyed fold kernel does not take {n} ids of width {width} into "
            f"{num_rows} rows")
    return ints.value


def fold_buffers(n: int, width: int, num_rows: int,
                 device: torch.device) -> Tuple[torch.Tensor, int]:
    """The fold's output [num_rows, width] f32 and the address of its int32
    scratch, from one allocation: the scratch follows the output at a 16-byte
    boundary and lives as long as the output does."""
    at = -(-num_rows * width // 4) * 4
    buf = torch.empty((at + fold_scratch_ints(n, width, num_rows),),
                      dtype=torch.float32, device=device)
    return buf.as_strided((num_rows, width), (width, 1)), buf.data_ptr() + 4 * at


def segment_sum_rows_plain(deltas: torch.Tensor, idx: torch.Tensor,
                           num_rows: int) -> torch.Tensor:
    """Masked ``index_add_`` (the reference's jnp route, sparse.py:170-174):
    out-of-range ids contribute zeros to row 0, i.e. nothing."""
    W = deltas.shape[1]
    out = torch.zeros((num_rows, W), dtype=deltas.dtype, device=deltas.device)
    if num_rows == 0:
        return out
    ok = (idx >= 0) & (idx < num_rows)
    safe = torch.where(ok, idx, torch.zeros_like(idx)).long()
    masked = torch.where(ok[:, None], deltas, torch.zeros_like(deltas))
    return out.index_add_(0, safe, masked)


def segment_sum_rows(deltas: torch.Tensor, idx: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """``out[k] = sum over i with idx[i]==k of deltas[i]`` — deltas [N, W],
    idx [N] -> [num_rows, W]. Out-of-range ids contribute nothing. The
    ``via="sparse"`` push fold (``TableSpec.push``). On the card: deltas f32,
    idx int32, both contiguous."""
    if deltas.ndim != 2 or idx.ndim != 1 or idx.shape[0] != deltas.shape[0]:
        raise ValueError(
            f"bad shapes deltas={tuple(deltas.shape)} idx={tuple(idx.shape)}")
    if not use_kernel(deltas, idx):
        return segment_sum_rows_plain(deltas, idx, num_rows)
    N, W = deltas.shape
    if deltas.dtype != torch.float32:
        raise TypeError(f"segment_sum_rows kernel takes f32 deltas, not {deltas.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"segment_sum_rows kernel takes int32 ids, not {idx.dtype}")
    _check_kernel_operand(deltas, "deltas")
    _check_kernel_operand(idx, "idx")
    if N == 0 or W == 0 or num_rows == 0:
        return torch.zeros((num_rows, W), dtype=torch.float32, device=deltas.device)
    out, scratch = fold_buffers(N, W, num_rows, deltas.device)
    with torch.cuda.device(deltas.get_device()):
        cuda_lib.launch(
            "harmony_segment_sum_rows", deltas.data_ptr(), idx.data_ptr(),
            out.data_ptr(), N, W, num_rows, scratch, _stream(deltas))
    segment_sum_rows.launches += 1
    return out


segment_sum_rows.launches = 0


def value_width(value_shape) -> int:
    """Row width of a table value (scalars are width-1 rows)."""
    return int(math.prod(value_shape)) if value_shape else 1
