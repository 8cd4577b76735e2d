"""Matrix products with bf16 operands and an f32 result.

Counterpart of ``harmony_tpu/ops/mxu.py``. The reference feeds the TPU's
matrix unit bf16 operands and accumulates in f32 (``preferred_element_type``);
the result stays f32 and is never rounded to bf16. On the card the same
contract is one cuBLAS product, ``torch.mm(a_bf16, b_bf16,
out_dtype=torch.float32)`` (a plain product, which the reference leaves to
XLA outside any Pallas kernel). On the CPU, PyTorch has no kernel for that
overload, so the plain version multiplies the bf16-rounded operands in f32:
each product of two bf16 values is exact in f32, so the two routes differ
only in the order of their f32 sums. The route follows the operands' device
(:func:`use_kernel`).

``precision="f32"`` keeps f32 operands (an exact-count product must: bf16
holds integers exactly only up to 256); on the card it depends on
``torch.backends.cuda.matmul.allow_tf32``, which the worker sets False.
"""
from __future__ import annotations

import torch

from harmony_tpu_torch.utils.platform import use_kernel


def mxu_dot(a: torch.Tensor, b: torch.Tensor, *, precision: str = "bf16") -> torch.Tensor:
    """``a @ b`` for 2-D ``a`` [M, K] and ``b`` [K, N] -> [M, N] float32.

    precision:
      * "bf16" (default) — operands rounded to bfloat16, products summed in f32.
      * "f32" — f32 operands, f32 sums.
    """
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"mxu_dot takes 2-D operands, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if precision == "f32":
        return torch.mm(a.float(), b.float())
    if precision != "bf16":
        raise ValueError(f"unknown precision {precision!r}")
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if use_kernel(a16, b16):
        return torch.mm(a16, b16, out_dtype=torch.float32)
    return torch.mm(a16.float(), b16.float())
