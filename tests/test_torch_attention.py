"""harmony_tpu_torch.ops.attention against harmony_tpu.ops.attention on the CPU.

The same numpy-seeded q, k, v (and cotangents) go to the JAX package's
flash_attention / flash_attention_lse in interpret mode (as tests/test_ops.py
runs them), or its blockwise_attention, and to the port's CPU route, which
takes the plain versions of K4, K5a and K5b (flash_forward_plain,
flash_backward_dkv_plain, flash_backward_dq_plain) and launches no kernel.

Tolerances:
  * f32 operands: both sides do the same f32 arithmetic and differ only in the
    order of their sums (XLA's dot against PyTorch's), each over at most 128
    terms of order 1: 2e-5 absolute on values of order 1, 1e-5 relative.
  * bf16 operands: products are exact in f32 on both sides and p is rounded
    to bf16 at the same points, so the f32 results differ by reordering only;
    out and the gradients are then rounded to bf16, where an f32 difference
    at a rounding boundary becomes one bf16 ulp (2**-8 relative), and a p or
    ds that rounds differently moves a sum by about as much. Allowed:
    2**-7 * max|reference| (two ulps at the largest magnitude). The LSE stays
    f32: 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.ops import attention as jax_attention
from harmony_tpu_torch.ops.attention import (
    blockwise_attention,
    flash_attention,
    flash_attention_lse,
    flash_backward_dkv,
    flash_backward_dq,
    flash_forward,
)

F32_ATOL = 2e-5
BF16_REL = 2.0 ** -7


def _inputs(seed, B=1, H=2, Sq=128, Sk=128, D=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    return q, k, v


def _jax(a, dtype):
    return jnp.asarray(a, dtype=getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.as_tensor(a).to(getattr(torch, dtype))


def _assert_close(got: torch.Tensor, want, dtype, what):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=F32_ATOL, err_msg=what)
    else:
        tol = BF16_REL * np.abs(want).max()
        assert np.abs(got - want).max() <= tol, (what, np.abs(got - want).max(), tol)


def _launches():
    return (flash_forward.launches, flash_backward_dkv.launches,
            flash_backward_dq.launches)


CASES = [  # (causal, Sq, Sk, block_q, block_k)
    (True, 128, 128, 64, 32),
    (False, 128, 128, 32, 64),
    (False, 64, 128, 64, 32),    # Sq != Sk
    (True, 64, 64, 64, 64),      # one block
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,Sq,Sk,block_q,block_k", CASES)
def test_flash_out_and_lse_match_jax(causal, Sq, Sk, block_q, block_k, dtype):
    q, k, v = _inputs(Sq + Sk, Sq=Sq, Sk=Sk)
    want_out, want_lse = jax_attention.flash_attention_lse(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype), causal, block_q, block_k,
        None, True)
    before = _launches()
    out, lse = flash_attention_lse(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                                   causal, block_q, block_k)
    assert _launches() == before  # CPU tensors take the plain versions
    assert out.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    _assert_close(out, want_out, dtype, "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=F32_ATOL)
    only_out = flash_attention(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                               causal, block_q, block_k)
    assert torch.equal(only_out, out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,Sq,Sk,block_q,block_k", CASES)
def test_flash_gradients_with_lse_cotangent_match_jax(causal, Sq, Sk, block_q, block_k,
                                                      dtype):
    """Gradients of sum(out * w) + sum(lse * u): the LSE's cotangent u reaches
    the backward through delta = rowsum(dO * O) - u."""
    q, k, v = _inputs(7 + Sq, Sq=Sq, Sk=Sk)
    rng = np.random.default_rng(11)
    w = rng.standard_normal(q.shape).astype(np.float32)
    u = rng.standard_normal(q.shape[:-1]).astype(np.float32)

    def jax_loss(q, k, v):
        out, lse = jax_attention.flash_attention_lse(q, k, v, causal, block_q, block_k,
                                                     None, True)
        return jnp.sum(out.astype(jnp.float32) * w) + jnp.sum(lse * u)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype))
    tq, tk, tv = (_torch(a, dtype).requires_grad_(True) for a in (q, k, v))
    out, lse = flash_attention_lse(tq, tk, tv, causal, block_q, block_k)
    before = _launches()
    ((out.float() * torch.as_tensor(w)).sum() + (lse * torch.as_tensor(u)).sum()).backward()
    assert _launches() == before
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == getattr(torch, dtype)
        _assert_close(got, ref, dtype, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gradients_without_lse_match_jax(dtype):
    """flash_attention drops the LSE: its cotangent is zero in both packages."""
    q, k, v = _inputs(3, Sq=64, Sk=64)
    w = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)

    def jax_loss(q, k, v):
        out = jax_attention.flash_attention(q, k, v, True, 32, 32, None, True)
        return jnp.sum(out.astype(jnp.float32) * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype))
    tq, tk, tv = (_torch(a, dtype).requires_grad_(True) for a in (q, k, v))
    (flash_attention(tq, tk, tv, True, 32, 32).float() * torch.as_tensor(w)).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        _assert_close(got, ref, dtype, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,block_k", [(128, 32), (96, 64)])  # 96 % 64: the padded path
def test_blockwise_matches_jax_with_gradients(causal, S, block_k):
    q, k, v = _inputs(S + int(causal), Sq=S, Sk=S)
    w = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)

    def jax_loss(q, k, v):
        return jnp.sum(jax_attention.blockwise_attention(q, k, v, causal, block_k) * w)

    want_out = jax_attention.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                                 jnp.asarray(v), causal, block_k)
    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                                 jnp.asarray(v))
    tq, tk, tv = (torch.as_tensor(a).requires_grad_(True) for a in (q, k, v))
    out = blockwise_attention(tq, tk, tv, causal, block_k)
    _assert_close(out.detach(), want_out, "float32", "out")
    (out * torch.as_tensor(w)).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        _assert_close(got, ref, "float32", f"d{name}")


def test_flash_and_blockwise_agree_in_f32():
    q, k, v = (torch.as_tensor(a) for a in _inputs(21, Sq=128, Sk=128))
    for causal in (False, True):
        got = flash_attention(q, k, v, causal, 64, 64)
        want = blockwise_attention(q, k, v, causal, 64)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=F32_ATOL)


def test_contract_errors():
    q, k, v = (torch.as_tensor(a) for a in _inputs(0, Sq=96, Sk=96))
    with pytest.raises(TypeError, match="share one dtype"):
        flash_attention_lse(q, k.to(torch.bfloat16), v, True, 32, 32)
    with pytest.raises(ValueError, match="must divide by blocks"):
        flash_attention_lse(q, k, v, True, 64, 32)   # 96 % 64
    with pytest.raises(ValueError, match="must divide by blocks"):
        flash_attention_lse(q, k, v, True, 32, 64)
    # blocks clamp to the sequence: a block longer than S is one block
    out, lse = flash_attention_lse(q, k, v, True, 256, 256)
    assert out.shape == q.shape and lse.shape == q.shape[:-1]
