"""Weighted histogram / segment reduction (K3).

Counterpart of ``harmony_tpu/ops/histogram.py``. The reference computes
``one_hot(ids)^T @ weights`` on the TPU's matrix unit in f32 at
``Precision.HIGHEST`` so that the result stays bit-comparable to a scatter. On
the card, :func:`weighted_histogram` launches the deterministic keyed fold in
``csrc/keyed_fold.cu`` (shared with K2, with its own entry point and launch
count): the one-hot product multiplies each weight by exactly 1.0, so the fold
adds each bin's weights in f32, in index order from 0.0, and nothing runs in
TF32. On a CPU tensor it takes :func:`weighted_histogram_plain`, a masked
``index_add_`` in f32, which adds in the same order: the two give the same
bits. :func:`segment_sum` is the same op named for the table's ``via="mxu"``
push, where it folds duplicate-key deltas by destination row.
"""
from __future__ import annotations

import torch

from harmony_tpu_torch.ops import cuda_lib
from harmony_tpu_torch.ops.sparse import _check_kernel_operand, _stream, fold_buffers
from harmony_tpu_torch.utils.platform import use_kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def weighted_histogram_plain(ids: torch.Tensor, weights: torch.Tensor,
                             num_bins: int) -> torch.Tensor:
    """Masked ``index_add_`` in f32: negative and out-of-range ids add nothing."""
    W = weights.shape[1]
    out = torch.zeros((num_bins, W), dtype=torch.float32, device=weights.device)
    if num_bins == 0:
        return out
    ok = (ids >= 0) & (ids < num_bins)
    safe = torch.where(ok, ids, torch.zeros_like(ids)).long()
    w = weights.float()
    return out.index_add_(0, safe, torch.where(ok[:, None], w, torch.zeros_like(w)))


def weighted_histogram(ids: torch.Tensor, weights: torch.Tensor,
                       num_bins: int) -> torch.Tensor:
    """``out[b, w] = sum over i with ids[i]==b of weights[i, w]``.

    ids [N] (negative / out-of-range ids contribute nothing), weights [N, W]
    -> [num_bins, W] float32. On the card: ids int32, weights f32, bf16 or
    f16, both contiguous."""
    if ids.ndim != 1 or weights.ndim != 2 or ids.shape[0] != weights.shape[0]:
        raise ValueError(
            f"bad shapes ids={tuple(ids.shape)} weights={tuple(weights.shape)}")
    if not use_kernel(ids, weights):
        return weighted_histogram_plain(ids, weights, num_bins)
    N, W = weights.shape
    code = _DTYPE_CODES.get(weights.dtype)
    if code is None:
        raise TypeError(
            f"weighted_histogram kernel takes f32/bf16/f16 weights, not {weights.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"weighted_histogram kernel takes int32 ids, not {ids.dtype}")
    _check_kernel_operand(ids, "ids")
    _check_kernel_operand(weights, "weights")
    if N == 0 or W == 0 or num_bins == 0:
        return torch.zeros((num_bins, W), dtype=torch.float32, device=weights.device)
    out, scratch = fold_buffers(N, W, num_bins, weights.device)
    with torch.cuda.device(weights.get_device()):
        cuda_lib.launch(
            "harmony_weighted_histogram", weights.data_ptr(), code, ids.data_ptr(),
            out.data_ptr(), N, W, num_bins, scratch, _stream(weights))
    weighted_histogram.launches += 1
    return out


weighted_histogram.launches = 0


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum rows of ``data`` [N, W] (or [N]) by ``segment_ids`` [N] ->
    [num_segments, W] (or [num_segments]): the push-aggregation primitive that
    folds duplicate-key deltas before the table's one dense add."""
    squeeze = data.ndim == 1
    if squeeze:
        data = data[:, None]
    out = weighted_histogram(segment_ids, data, num_segments)
    return out[:, 0] if squeeze else out
