"""harmony_tpu_torch.ops.{ring,ulysses} against harmony_tpu.ops.{ring,ulysses} on the CPU.

The same numpy-seeded q, k, v go to the JAX package's ring_self_attention and
a2a_self_attention on its 8 virtual CPU devices (its flash inner in interpret
mode with ``check_vma=False``, as tests/test_ops.py runs it) and to the port's
on 8 virtual CPU slots (``DevicePool.virtual("cpu", 8)``), where the flash
inner takes the plain versions of K4, K5a and K5b. The JAX outputs are
computed once per module (each is a shard_map compile).

Tolerances: every comparison is f32, and the two sides differ only in the
order of their f32 sums. Outputs of order 1 from sums over at most 64 keys
agree to 2e-5 absolute (tests/test_ops.py's limit for the reference's own
ring against naive attention); gradients, which sum over the other chunks'
contributions once more, to 1e-4 absolute (the reference's limit for its
flash inner against its einsum inner, and for its ring gradients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.ops.ring import ring_self_attention as jax_ring
from harmony_tpu.ops.ulysses import a2a_self_attention as jax_a2a
from harmony_tpu.parallel import build_mesh as jax_build_mesh
from harmony_tpu_torch.ops import a2a_attention, a2a_self_attention, ring_attention
from harmony_tpu_torch.ops import ring as ring_mod
from harmony_tpu_torch.ops.attention import flash_attention
from harmony_tpu_torch.ops.ring import _resolve_inner, ring_self_attention
from harmony_tpu_torch.parallel.mesh import DevicePool, build_mesh

OUT_ATOL = 2e-5
GRAD_ATOL = 1e-4
SHAPE = (2, 4, 64, 16)      # [B, H, S, D] over (data 2, seq 4): chunks of 16


def _qkv(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _mesh(data=2, seq=4):
    return build_mesh(DevicePool.virtual("cpu", data * seq).slots, data=data, seq=seq, model=1)


def _jax_mesh(data=2, seq=4):
    return jax_build_mesh(jax.devices()[:8], data=data, seq=seq, model=1)


def _naive(q, k, v, causal):
    """Full attention in plain torch ops (f32), the port-side reference."""
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        S = q.shape[2]
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    return torch.softmax(s, dim=-1) @ v


def _grads(fn, arrays, out_fn=lambda o: (o ** 2).sum()):
    ts = [torch.as_tensor(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    return out.detach(), torch.autograd.grad(out_fn(out), ts)


@pytest.fixture(scope="module")
def jax_rings():
    """The reference's ring outputs: einsum causal and not, flash causal."""
    q, k, v = (jnp.asarray(a) for a in _qkv(7))
    mesh = _jax_mesh()
    kw = dict(seq_axis="seq", batch_axis="data")
    return {
        ("einsum", False): np.asarray(jax_ring(q, k, v, mesh, causal=False, inner="einsum", **kw)),
        ("einsum", True): np.asarray(jax_ring(q, k, v, mesh, causal=True, inner="einsum", **kw)),
        ("flash", True): np.asarray(jax_ring(q, k, v, mesh, causal=True, inner="flash",
                                             check_vma=False, **kw)),
    }


@pytest.mark.parametrize("inner,causal", [("einsum", False), ("einsum", True), ("flash", True)])
def test_ring_matches_the_references(jax_rings, inner, causal):
    q, k, v = (torch.as_tensor(a) for a in _qkv(7))
    out = ring_self_attention(q, k, v, _mesh(), "seq", batch_axis="data", causal=causal,
                              inner=inner)
    want = jax_rings[inner, causal]
    assert out.shape == want.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, atol=OUT_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_inner_matches_the_einsum_inner_with_gradients(causal):
    """The flash inner (K4 per chunk and the LSE merge; K5a/K5b with the LSE
    cotangent in the backward) against the einsum fold: forward and all three
    gradients, and the same bits when run again."""
    mesh = _mesh()

    def run(inner):
        return _grads(lambda q, k, v: ring_self_attention(
            q, k, v, mesh, "seq", batch_axis="data", causal=causal, inner=inner), _qkv(8))

    o_e, g_e = run("einsum")
    o_f, g_f = run("flash")
    np.testing.assert_allclose(o_f.numpy(), o_e.numpy(), atol=OUT_ATOL)
    for a, b in zip(g_f, g_e):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL)
    o_2, g_2 = run("flash")
    assert torch.equal(o_f, o_2) and all(torch.equal(a, b) for a, b in zip(g_f, g_2))


@pytest.fixture(scope="module")
def jax_plain_grads():
    """jax.grad of a plain causal attention in jnp (cheap to compile): the
    reference the ring's gradients are held to."""
    def loss(q, k, v):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
        S = q.shape[2]
        s = jnp.where(jnp.tril(jnp.ones((S, S), bool)), s, -1e30)
        return (jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v) ** 2).sum()

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in _qkv(9)))]


@pytest.mark.parametrize("inner", ["einsum", "flash"])
def test_ring_gradients_match_jax_grad_of_plain_attention(jax_plain_grads, inner):
    mesh = _mesh()
    _, grads = _grads(lambda q, k, v: ring_self_attention(
        q, k, v, mesh, "seq", batch_axis="data", causal=True, inner=inner), _qkv(9))
    for got, want in zip(grads, jax_plain_grads):
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_ATOL)


@pytest.fixture(scope="module")
def jax_a2a_outputs():
    q, k, v = (jnp.asarray(a) for a in _qkv(10, (2, 8, 64, 16)))
    mesh = jax_build_mesh(jax.devices()[:8], data=1, seq=8, model=1)
    return {causal: np.asarray(jax_a2a(q, k, v, mesh, seq_axis="seq", causal=causal))
            for causal in (False, True)}


@pytest.mark.parametrize("causal", [False, True])
def test_a2a_matches_the_references(jax_a2a_outputs, causal):
    """8 heads over an 8-slot ring: each slot attends over the whole sequence
    for its head (blockwise on the CPU, as the reference's off-TPU route)."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(10, (2, 8, 64, 16)))
    mesh = _mesh(data=1, seq=8)
    out = a2a_self_attention(q, k, v, mesh, "seq", causal=causal)
    np.testing.assert_allclose(out.numpy(), jax_a2a_outputs[causal], atol=OUT_ATOL)


def test_a2a_gradients_match_plain_attention():
    mesh = _mesh()
    arrays = _qkv(11)
    o_a, g_a = _grads(lambda q, k, v: a2a_self_attention(q, k, v, mesh, "seq",
                                                         batch_axis="data", causal=True), arrays)
    o_n, g_n = _grads(lambda q, k, v: _naive(q, k, v, True), arrays)
    np.testing.assert_allclose(o_a.numpy(), o_n.numpy(), atol=OUT_ATOL)
    for a, b in zip(g_a, g_n):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL)


def test_a2a_refuses_heads_that_do_not_divide_the_ring():
    x = torch.ones((2, 3, 64, 8))  # 3 heads over an 8-slot ring
    with pytest.raises(ValueError, match="num heads 3 must divide by axis size 8"):
        a2a_self_attention(x, x, x, _mesh(data=1, seq=8), "seq")
    with pytest.raises(ValueError, match="num heads 3 must divide by axis size 2"):
        a2a_attention([x[:, :, :32], x[:, :, 32:]], [x[:, :, :32], x[:, :, 32:]],
                      [x[:, :, :32], x[:, :, 32:]])


def test_resolve_inner(monkeypatch):
    monkeypatch.delenv("HARMONY_RING_INNER", raising=False)
    assert _resolve_inner("auto") == "einsum"
    assert _resolve_inner("auto", on_card=True) == "flash"
    assert _resolve_inner("einsum", on_card=True) == "einsum"
    monkeypatch.setenv("HARMONY_RING_INNER", "flash")
    assert _resolve_inner("auto") == "flash"
    monkeypatch.setenv("HARMONY_RING_INNER", "einsum")
    assert _resolve_inner("auto", on_card=True) == "einsum"
    monkeypatch.setenv("HARMONY_RING_INNER", "fast")   # not a choice: ignored
    assert _resolve_inner("auto") == "einsum"
    with pytest.raises(ValueError, match="unknown ring inner 'pallas'"):
        _resolve_inner("pallas")
    q = torch.zeros((1, 1, 8, 16))
    with pytest.raises(ValueError, match="unknown ring inner"):
        ring_attention([q], [q], [q], inner="pallas")


@pytest.mark.parametrize("inner", ["einsum", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_a_ring_of_one_is_flash_attention(inner, causal):
    """n = 1: one chunk, no rotation; the output is flash_attention's (the ring
    scales q before the product, flash_attention the product: f32 rounding)."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(12, (2, 4, 32, 16)))
    (out,) = ring_attention([q], [k], [v], causal=causal, inner=inner)
    np.testing.assert_allclose(out.numpy(), flash_attention(q, k, v, causal=causal).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("causal,calls", [(True, 10), (False, 16)])
def test_flash_inner_calls_and_rotations(monkeypatch, causal, calls):
    """A causal ring of n slots calls the flash kernels n(n+1)/2 times (the
    chunks above the diagonal skipped, launching nothing), a full one n^2;
    k and v rotate n - 1 times each."""
    seen, hops = [], []
    real_flash, real_ppermute = ring_mod.flash_attention_lse, ring_mod.ppermute

    def flash(q, k, v, causal_chunk, *args):
        seen.append(causal_chunk)
        return real_flash(q, k, v, causal_chunk, *args)

    def ppermute(shards, devices):
        hops.append(len(shards))
        return real_ppermute(shards, devices)

    monkeypatch.setattr(ring_mod, "flash_attention_lse", flash)
    monkeypatch.setattr(ring_mod, "ppermute", ppermute)
    q, k, v = (torch.as_tensor(a) for a in _qkv(13, (1, 2, 64, 16)))
    ring_self_attention(q, k, v, _mesh(data=1, seq=4), "seq", causal=causal, inner="flash")
    assert len(seen) == calls and seen.count(True) == (4 if causal else 0)
    assert hops == [4] * 6      # k and v, 3 rotations each


def test_ring_outputs_stay_on_their_slots():
    """ring_attention over explicit chunks returns each output on its chunk's
    device, in q's dtype."""
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16) for a in _qkv(14, (1, 2, 32, 16)))
    qs, ks, vs = (list(t.chunk(2, dim=2)) for t in (q, k, v))
    outs = ring_attention(qs, ks, vs, causal=True)
    assert [o.dtype for o in outs] == [torch.bfloat16] * 2
    full = _naive(q.float(), k.float(), v.float(), True)
    np.testing.assert_allclose(torch.cat(outs, dim=2).float().numpy(), full.numpy(),
                               atol=2.0 ** -7 * float(full.abs().max()))
