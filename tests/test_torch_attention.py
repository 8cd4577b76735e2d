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
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.ops import attention as jax_attention
from harmony_tpu_torch.ops import attention, cuda_lib
from harmony_tpu_torch.ops.attention import (
    blockwise_attention,
    flash_attention,
    flash_attention_lse,
    flash_backward_dkv,
    flash_backward_dq,
    flash_backward_dq_plain,
    flash_forward,
    flash_forward_plain,
    flash_route,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    (True, 256, 256, 128, 128),  # the LM's tile
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


ROUTES = [  # (dtype, head dim, block_k, the route or the error a CUDA call meets)
    (torch.bfloat16, 64, 128, "mma"),    # the LM's shape
    (torch.bfloat16, 64, 64, "mma"),
    (torch.bfloat16, 32, 64, "mma"),
    (torch.bfloat16, 128, 128, "mma"),
    (torch.bfloat16, 16, 32, "mma"),
    (torch.bfloat16, 64, 16, "mma"),
    (torch.bfloat16, 64, 256, "simt"),   # the wrappers' default block
    (torch.bfloat16, 64, 48, "simt"),
    (torch.bfloat16, 64, 100, "simt"),   # the bf16 LM at S = 100
    (torch.float32, 64, 128, "simt"),
    (torch.float32, 16, 64, "simt"),     # the lm preset's shape
    (torch.float32, 64, 24, "simt"),
    (torch.bfloat16, 64, 24, "simt"),
    (torch.bfloat16, 64, 8, "simt"),
    (torch.bfloat16, 48, 128, ValueError),  # a head dim no kernel takes
    (torch.float32, 256, 128, ValueError),
    (torch.float16, 64, 128, TypeError),
]


@pytest.mark.parametrize("dtype,head_dim,block_k,want", ROUTES)
def test_flash_route_is_pinned(dtype, head_dim, block_k, want):
    """bf16 at key tiles of 16-128 keys (powers of two) goes to the tensor
    cores (mma); f32, and bf16 at any other tile, to the scalar kernels (simt);
    a call no route takes raises; nothing falls back."""
    if isinstance(want, str):
        assert flash_route(dtype, head_dim, block_k) == want
    else:
        with pytest.raises(want):
            flash_route(dtype, head_dim, block_k)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_forward_rounds_p_at_the_key_tile(causal):
    """In bf16, p is rounded at each key tile's running maximum, so block_k is
    part of the result: the plain K4 at block_k 64 and at 128 differ on the same
    inputs, and each agrees with JAX at its own block far more closely than
    with JAX at the other. The kernels must walk keys in tiles of block_k."""
    rng = np.random.default_rng(3)
    shape = (1, 2, 256, 16)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) * s for s in (2.0, 2.0, 1.0))
    port, ref = {}, {}
    for block_k in (64, 128):
        port[block_k], _ = flash_forward_plain(
            *(_torch(a, "bfloat16") for a in (q, k, v)), causal, 128, block_k, 16 ** -0.5)
        want, _ = jax_attention.flash_attention_lse(
            *(_jax(a, "bfloat16") for a in (q, k, v)), causal, 128, block_k, None, True)
        ref[block_k] = torch.as_tensor(np.asarray(want.astype(jnp.float32)))
        _assert_close(port[block_k], want, "bfloat16", f"out at block_k {block_k}")

    def mismatches(a, b):
        return int((a.float() != b.float()).sum())

    assert mismatches(port[64], port[128]) > 0
    for own, other in ((64, 128), (128, 64)):
        assert 20 * mismatches(port[own], ref[own]) < mismatches(port[own], ref[other])


_DQ_BLOCKS = (32, 64, 128)


def _dq_inputs():
    rng = np.random.default_rng(4)
    shape = (1, 2, 256, 16)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) * s for s in (2.0, 2.0, 1.0))
    return q, k, v, rng.standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_bf16_dq(causal, block_k):
    """dQ of sum(out * w) by jax.grad through the JAX package's interpret-mode
    flash_attention_lse at this key tile, in f32."""
    q, k, v, w = _dq_inputs()

    def loss(q):
        out, _ = jax_attention.flash_attention_lse(
            q, _jax(k, "bfloat16"), _jax(v, "bfloat16"), causal, 128, block_k, None, True)
        return jnp.sum(out.astype(jnp.float32) * w)

    return np.asarray(jax.grad(loss)(_jax(q, "bfloat16")).astype(jnp.float32))


@pytest.mark.parametrize("block_k", _DQ_BLOCKS)
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_dq_does_not_depend_on_the_key_tile(causal, block_k):
    """Unlike K4's p, K5b's p and ds come from the final LSE and are rounded
    elementwise, so block_k changes only the order of f32 sums: the port's
    plain dQ at one block_k agrees with JAX's interpret-mode dQ at every
    other, within 2**-7 * max|ref|, and with the same LSE and delta the plain
    dQ at two key tiles differs by at most one bf16 ulp of the largest value.
    So the tensor-core K5b may stage keys in tiles of its own (64)."""
    q, k, v, w = _dq_inputs()
    tq, tk, tv = (_torch(a, "bfloat16") for a in (q, k, v))
    tq.requires_grad_(True)
    out, lse = flash_attention_lse(tq, tk, tv, causal, 128, block_k)
    (out.float() * torch.as_tensor(w)).sum().backward()
    for other in _DQ_BLOCKS:
        _assert_close(tq.grad, _jax_bf16_dq(causal, other), "bfloat16",
                      f"dq: the port at block_k {block_k}, JAX at {other}")
    do = _torch(w, "bfloat16")
    delta = (do.float() * out.detach().float()).sum(dim=-1)
    args = (tq.detach(), tk, tv, do, lse.detach(), delta, causal, 128)
    mine = flash_backward_dq_plain(*args, block_k, 16 ** -0.5).float()
    for other in _DQ_BLOCKS:
        theirs = flash_backward_dq_plain(*args, other, 16 ** -0.5).float()
        assert (mine - theirs).abs().max() <= 2.0 ** -8 * mine.abs().max()


def _dq_operands(dtype, S):
    rng = np.random.default_rng(S)
    q, k, v, do = (torch.as_tensor(rng.standard_normal((1, 2, S, 16)).astype(np.float32))
                   .to(dtype) for _ in range(4))
    lse, delta = (torch.as_tensor(rng.standard_normal((1, 2, S)).astype(np.float32))
                  for _ in range(2))
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("dtype,block_k,entry", [
    (torch.bfloat16, 128, "harmony_flash_backward_dq_mma"),   # the LM's tile
    (torch.bfloat16, 16, "harmony_flash_backward_dq_mma"),
    (torch.float32, 128, "harmony_flash_backward_dq"),        # f32 stays off TF32
    (torch.bfloat16, 100, "harmony_flash_backward_dq"),       # a tile mma does not take
    (torch.float16, 128, TypeError),                          # no route: raise, launch nothing
])
def test_dq_launches_the_kernel_its_route_names(monkeypatch, dtype, block_k, entry):
    """K5b's wiring without a card: with use_kernel forced True, the wrapper
    launches the entry point flash_route names, once, with as many arguments
    as its SIGNATURES row declares, and counts the launch by route."""
    calls = []
    monkeypatch.setattr(attention, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(attention, "_stream", lambda t: 0)
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *args: calls.append((name, args)))
    operands = _dq_operands(dtype, block_k)
    launches, by_route = flash_backward_dq.launches, dict(flash_backward_dq.launches_by_route)
    if not isinstance(entry, str):
        with pytest.raises(entry):
            flash_backward_dq(*operands, True, block_k, block_k, 0.25)
        assert calls == [] and flash_backward_dq.launches == launches
        return
    route = "mma" if entry.endswith("_mma") else "simt"
    assert flash_route(dtype, 16, block_k) == route
    dq = flash_backward_dq(*operands, True, block_k, block_k, 0.25)
    assert [name for name, _ in calls] == [entry]
    assert len(calls[0][1]) == len(cuda_lib.SIGNATURES[entry][1])
    assert dq.shape == operands[0].shape and dq.dtype == dtype
    assert flash_backward_dq.launches == launches + 1
    by_route[route] += 1
    assert flash_backward_dq.launches_by_route == by_route
