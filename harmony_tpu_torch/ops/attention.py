"""Attention — the blockwise streaming softmax and flash attention (K4, K5a, K5b).

Counterpart of ``harmony_tpu/ops/attention.py``. Layout ``[B, H, S, D]`` at every
public function.

  * :func:`blockwise_attention` — plain PyTorch: a loop over kv blocks carrying
    (acc, m, l), differentiable by autograd. The any-device route, and what
    ``attn="blockwise"`` selects.
  * :func:`flash_attention_lse` — a ``torch.autograd.Function`` whose forward is
    K4 (:func:`flash_forward`) and whose backward is K5a (:func:`flash_backward_dkv`)
    and K5b (:func:`flash_backward_dq`). It returns ``(out, lse)``, both
    differentiable; the LSE cotangent folds into the backward's delta,
    ``delta = rowsum(dO * O) - g_lse``, computed in f32 with plain tensor ops
    (the JAX package leaves it to XLA outside its kernels).
    :func:`flash_attention` drops the LSE.

On a CUDA tensor each kernel wrapper launches its hand-written kernel
(``csrc/flash_attention.cu``); on a CPU tensor it takes the plain PyTorch
version beside it (``*_plain``), which follows the TPU kernels' arithmetic tile
for tile: the scale on the f32 product, the finite ``-1e30`` mask, the kv tiles
above the diagonal skipped, ``l = max(l, 1e-30)``, and p rounded to v's type
before PV. There is no fallback: a CUDA tensor the kernel does not take raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from harmony_tpu_torch.ops import cuda_lib
from harmony_tpu_torch.ops.sparse import _stream
from harmony_tpu_torch.utils.platform import use_kernel

DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 256
_NEG_INF = -1e30  # finite "-inf": keeps the masked softmax NaN-free
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Plain PyTorch blockwise (the differentiable any-device route)
# ---------------------------------------------------------------------------

def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_k: int = DEFAULT_BLOCK_K,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Streaming-softmax attention over kv blocks carrying (acc, m, l).

    q [B,H,Sq,D], k/v [B,H,Sk,D] -> [B,H,Sq,D] in q's dtype; scores and the
    running state in f32."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    block_k = min(block_k, Sk)
    nk, rem = divmod(Sk, block_k)
    if rem:  # pad kv to a whole number of blocks; padded keys are masked out
        pad = block_k - rem
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        nk += 1
    qf = q.float() * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    acc = torch.zeros_like(qf)
    m = torch.full(qf.shape[:-1], _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(qf.shape[:-1], dtype=torch.float32, device=q.device)
    for i in range(nk):
        start = i * block_k
        kblk = k[:, :, start:start + block_k].float()
        vblk = v[:, :, start:start + block_k].float()
        s = qf @ kblk.transpose(-1, -2)
        kv_pos = start + torch.arange(block_k, device=q.device)[None, :]
        mask = kv_pos < Sk
        if causal:
            mask = mask & (q_pos >= kv_pos)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ vblk
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# Plain versions of the kernels, tile for tile
# ---------------------------------------------------------------------------

def _apply_causal_mask(s, iq, ik, block_q, block_k):
    """Mask one (q-block, kv-block) score tile by absolute position, row >= col.
    Shared by the forward and both backward plain versions."""
    row = iq * block_q + torch.arange(block_q, device=s.device)[:, None]
    col = ik * block_k + torch.arange(block_k, device=s.device)[None, :]
    return torch.where(row >= col, s, torch.full_like(s, _NEG_INF))


def _needed(causal, iq, ik, block_q, block_k) -> bool:
    """False for a kv block strictly above the diagonal of a q block."""
    return not causal or ik * block_k <= iq * block_q + block_q - 1


def _dot_f32(a, b):
    """The f32 product of two operands of any float type (bf16 products are
    exact in f32; TF32 stays off, as the worker sets it)."""
    return a.float() @ b.float()


def flash_forward_plain(q, k, v, causal, block_q, block_k, scale):
    """K4's arithmetic: per (q block, kv block) tile the online softmax of
    ``_fa_kernel``. q/k/v [B,H,S,D] -> (out [B,H,Sq,D] in q's dtype, lse
    [B,H,Sq] f32)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for iq in range(Sq // block_q):
        rows = slice(iq * block_q, (iq + 1) * block_q)
        qt = q[:, :, rows]
        m = torch.full((B, H, block_q, 1), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, block_q, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, block_q, D), dtype=torch.float32, device=q.device)
        for ik in range(Sk // block_k):
            if not _needed(causal, iq, ik, block_q, block_k):
                break
            cols = slice(ik * block_k, (ik + 1) * block_k)
            s = _dot_f32(qt, k[:, :, cols].transpose(-1, -2)) * scale
            if causal:
                s = _apply_causal_mask(s, iq, ik, block_q, block_k)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + _dot_f32(p.to(v.dtype), v[:, :, cols])
            m = m_new
        l = l.clamp_min(1e-30)
        out[:, :, rows] = (acc / l).to(q.dtype)
        lse[:, :, rows] = (m + torch.log(l))[..., 0]
    return out, lse


def _bwd_p_ds(qt, kt, vt, dot, lse_t, delta_t, iq, ik, causal, block_q, block_k, scale):
    """One tile's (p, ds): p the normalised softmax recomputed from the LSE,
    ds = p * (dO V^T - delta)."""
    s = _dot_f32(qt, kt.transpose(-1, -2)) * scale
    if causal:
        s = _apply_causal_mask(s, iq, ik, block_q, block_k)
    p = torch.exp(s - lse_t[..., None])
    dp = _dot_f32(dot, vt.transpose(-1, -2))
    return p, p * (dp - delta_t[..., None])


def flash_backward_dkv_plain(q, k, v, do, lse, delta, causal, block_q, block_k, scale):
    """K5a's arithmetic (``_fa_bwd_dkv_kernel``): per kv block, dV += p^T dO
    and dK += scale * ds^T Q over the q blocks it needs."""
    Sq, Sk = q.shape[2], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for ik in range(Sk // block_k):
        cols = slice(ik * block_k, (ik + 1) * block_k)
        kt, vt = k[:, :, cols], v[:, :, cols]
        dk_acc = torch.zeros(kt.shape, dtype=torch.float32, device=k.device)
        dv_acc = torch.zeros(vt.shape, dtype=torch.float32, device=v.device)
        for iq in range(Sq // block_q):
            if not _needed(causal, iq, ik, block_q, block_k):
                continue
            rows = slice(iq * block_q, (iq + 1) * block_q)
            qt, dot = q[:, :, rows], do[:, :, rows]
            p, ds = _bwd_p_ds(qt, kt, vt, dot, lse[:, :, rows], delta[:, :, rows],
                              iq, ik, causal, block_q, block_k, scale)
            dv_acc = dv_acc + _dot_f32(p.to(do.dtype).transpose(-1, -2), dot)
            dk_acc = dk_acc + scale * _dot_f32(ds.to(q.dtype).transpose(-1, -2), qt)
        dk[:, :, cols] = dk_acc.to(k.dtype)
        dv[:, :, cols] = dv_acc.to(v.dtype)
    return dk, dv


def flash_backward_dq_plain(q, k, v, do, lse, delta, causal, block_q, block_k, scale):
    """K5b's arithmetic (``_fa_bwd_dq_kernel``): per q block, dQ += scale * ds K
    over the kv blocks it needs."""
    Sq, Sk = q.shape[2], k.shape[2]
    dq = torch.empty_like(q)
    for iq in range(Sq // block_q):
        rows = slice(iq * block_q, (iq + 1) * block_q)
        qt, dot = q[:, :, rows], do[:, :, rows]
        dq_acc = torch.zeros(qt.shape, dtype=torch.float32, device=q.device)
        for ik in range(Sk // block_k):
            if not _needed(causal, iq, ik, block_q, block_k):
                break
            cols = slice(ik * block_k, (ik + 1) * block_k)
            kt = k[:, :, cols]
            _, ds = _bwd_p_ds(qt, kt, v[:, :, cols], dot, lse[:, :, rows],
                              delta[:, :, rows], iq, ik, causal, block_q, block_k, scale)
            dq_acc = dq_acc + scale * _dot_f32(ds.to(k.dtype), kt)
        dq[:, :, rows] = dq_acc.to(q.dtype)
    return dq


# ---------------------------------------------------------------------------
# Kernel wrappers: the CUDA kernel on a CUDA tensor, the plain version on a CPU one
# ---------------------------------------------------------------------------

def _kernel_operands(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Contiguous operands of a type and head dim the kernels take."""
    dtype, D = tensors[0].dtype, tensors[0].shape[-1]
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention kernels take f32 or bf16 operands, not {dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash attention kernels take head dims {KERNEL_HEAD_DIMS}, not {D}")
    return tuple(t.contiguous() for t in tensors)


def flash_forward(q, k, v, causal, block_q, block_k, scale):
    """K4: ``(out, lse)`` of flash attention for q [B,H,Sq,D], k/v [B,H,Sk,D]
    sharing one type; blocks already clamped and dividing the lengths."""
    if not use_kernel(q, k, v):
        return flash_forward_plain(q, k, v, causal, block_q, block_k, scale)
    q, k, v = _kernel_operands(q, k, v)
    B, H, Sq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    cuda_lib.launch(
        "harmony_flash_forward", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), _DTYPE_CODE[q.dtype], B * H, Sq, k.shape[2],
        D, block_k, float(scale), int(causal), _stream(q))
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0


def flash_backward_dkv(q, k, v, do, lse, delta, causal, block_q, block_k, scale):
    """K5a: ``(dk, dv)`` from the saved LSE and ``delta`` ([B,H,Sq] f32)."""
    if not use_kernel(q, k, v, do, lse, delta):
        return flash_backward_dkv_plain(q, k, v, do, lse, delta, causal, block_q,
                                        block_k, scale)
    q, k, v, do = _kernel_operands(q, k, v, do)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    B, H, Sq, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    cuda_lib.launch(
        "harmony_flash_backward_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPE_CODE[q.dtype], B * H, Sq, k.shape[2], D, float(scale), int(causal),
        _stream(q))
    flash_backward_dkv.launches += 1
    return dk, dv


flash_backward_dkv.launches = 0


def flash_backward_dq(q, k, v, do, lse, delta, causal, block_q, block_k, scale):
    """K5b: ``dq`` from the saved LSE and ``delta`` ([B,H,Sq] f32)."""
    if not use_kernel(q, k, v, do, lse, delta):
        return flash_backward_dq_plain(q, k, v, do, lse, delta, causal, block_q,
                                       block_k, scale)
    q, k, v, do = _kernel_operands(q, k, v, do)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    B, H, Sq, D = q.shape
    dq = torch.empty_like(q)
    cuda_lib.launch(
        "harmony_flash_backward_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _DTYPE_CODE[q.dtype], B * H, Sq, k.shape[2], D, float(scale), int(causal),
        _stream(q))
    flash_backward_dq.launches += 1
    return dq


flash_backward_dq.launches = 0


# ---------------------------------------------------------------------------
# The differentiable flash attention
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, scale):
        # the kernels read contiguous rows; the backward reuses these copies
        q, k, v = (t.contiguous() for t in (q, k, v))
        out, lse = flash_forward(q, k, v, causal, block_q, block_k, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, block_q, block_k, scale)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        delta = (g_out.float() * out.float()).sum(dim=-1) - g_lse.float()
        dk, dv = flash_backward_dkv(q, k, v, g_out, lse, delta, *ctx.args)
        dq = flash_backward_dq(q, k, v, g_out, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns the per-row log-sum-exp: ``(out
    [B,H,Sq,D] in q's dtype, lse [B,H,Sq] f32)``, both differentiable.

    q/k/v must share one dtype (TypeError otherwise), and Sq and Sk must divide
    by the blocks clamped to them (ValueError otherwise)."""
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"flash attention feeds its products in the operands' dtype, so "
            f"q/k/v must share one dtype (got {q.dtype}/{k.dtype}/{v.dtype}); "
            "cast the operands before the call")
    Sq, Sk = q.shape[2], k.shape[2]
    block_q, block_k = min(block_q, Sq), min(block_k, Sk)
    if Sq % block_q or Sk % block_k:
        raise ValueError(
            f"seq lens ({Sq},{Sk}) must divide by blocks ({block_q},{block_k})")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k, scale)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused attention, forward K4 and backward K5a/K5b: :func:`flash_attention_lse`
    without the LSE (a zero LSE cotangent folds to the same backward)."""
    out, _ = flash_attention_lse(q, k, v, causal, block_q, block_k, scale)
    return out
