"""harmony_tpu_torch.ops.mxu against harmony_tpu.ops.mxu on the CPU.

Tolerance: both sides multiply the same operands (rounded to bf16 for
precision="bf16"; every product of two bf16 values is exact in f32) and sum
K products in f32 in their own orders. Two f32 sums of the same K terms differ
by at most 2 * K * 2**-24 * sum(|a_i b_i|), elementwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.ops.mxu import mxu_dot as jax_mxu_dot
from harmony_tpu_torch.ops import mxu
from harmony_tpu_torch.ops.mxu import mxu_dot


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _bound(a, b, precision):
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    if precision == "bf16":
        ta, tb = ta.bfloat16().double(), tb.bfloat16().double()
    abs_sum = (ta.abs().double() @ tb.abs().double()).numpy()
    return 2 * a.shape[1] * 2.0 ** -24 * abs_sum


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("m,k,n,transposed", [
    (64, 512, 32, False),     # MLR's logits at a small size
    (48, 96, 16, True),       # NMF's err.T @ l_rows: an operand read transposed
    (1, 1, 1, False),
])
def test_mxu_dot_matches_jax(precision, m, k, n, transposed):
    a, b = _operands(m, k, n, seed=m + k + n)
    if transposed:
        a = np.ascontiguousarray(a.T).T   # same values, strides of a transpose
    want = np.asarray(jax_mxu_dot(jnp.asarray(a), jnp.asarray(b), precision=precision))
    got = mxu_dot(torch.as_tensor(a), torch.as_tensor(b), precision=precision)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert np.all(np.abs(got.numpy() - want) <= _bound(a, b, precision))


def test_bf16_rounds_the_operands_but_not_the_result():
    a, b = _operands(32, 256, 16, seed=3)
    got = mxu_dot(torch.as_tensor(a), torch.as_tensor(b))
    exact = torch.as_tensor(a).double() @ torch.as_tensor(b).double()
    # the operands were rounded: far from the f32 product at 256 terms
    assert float((got.double() - exact).abs().max()) > 1e-3
    # the result was not: it carries more than bf16's 8 significant bits
    assert bool((got != got.bfloat16().float()).any())


def test_contract_errors():
    a = torch.ones((2, 3))
    with pytest.raises(ValueError, match="precision"):
        mxu_dot(a, a.T, precision="tf32")
    with pytest.raises(ValueError, match="2-D"):
        mxu_dot(torch.ones((2, 2, 3)), a.T)
    with pytest.raises(ValueError, match="2-D"):
        mxu_dot(a, torch.ones(3))


def test_the_card_route_is_one_product_of_bf16_operands_into_f32(monkeypatch):
    """The route without a card: with use_kernel forced True, mxu_dot makes one
    torch.mm call on bf16 operands with out_dtype=float32."""
    calls = []

    def fake_mm(x, y, **kw):
        calls.append((x.dtype, y.dtype, kw))
        return torch.zeros((x.shape[0], y.shape[1]), dtype=kw.get("out_dtype", x.dtype))

    monkeypatch.setattr(mxu, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(mxu.torch, "mm", fake_mm)
    out = mxu_dot(torch.ones((4, 8)), torch.ones((8, 2)))
    assert calls == [(torch.bfloat16, torch.bfloat16, {"out_dtype": torch.float32})]
    assert out.dtype == torch.float32 and out.shape == (4, 2)
