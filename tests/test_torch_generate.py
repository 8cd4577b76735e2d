"""The port's KV-cache generation against harmony_tpu's, on the CPU.

harmony_tpu_torch.models.generate and utils/prng.py::split against
harmony_tpu.models.generate and jax.random.split: the same weights (the JAX
package's ``init_numpy``, carried across) and the same numpy prompts go to
both, dense and MoE.

Tolerances: the step keys are threefry bits (exact). Prefill and decode logits
are f32 in both packages and differ in the order of their sums only: 1e-5
absolute (logits of order 1). Greedy tokens are argmaxes of such logits: equal
token for token on these seeds (two logits of a row would have to tie within
~1e-6 to part them). Tokens drawn at temperature 1.0 are argmaxes of logits
plus gumbel noise, whose two logs PyTorch and XLA may round apart in the last
bit (``utils/prng.py``): equal on the seeds tested, where no two scores lie
that close. The cache decode against the full forward: 2e-4, the reference's
own limit for that comparison (``tests/test_generate.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.models import generate as jax_gen
from harmony_tpu.models import transformer as jax_tf
from harmony_tpu_torch.convert import pytree_params_from_numpy
from harmony_tpu_torch.models import generate as gen
from harmony_tpu_torch.models import transformer as tf
from harmony_tpu_torch.utils import prng

CFG = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq=32,
           attn="blockwise")
MOE = dict(moe_experts=4, moe_every=2)
ATOL = 1e-5


def _models(**over):
    kw = {**CFG, **over}
    jm = jax_tf.TransformerLM(jax_tf.TransformerConfig(**kw))
    tm = tf.TransformerLM(tf.TransformerConfig(**kw))
    params = jm.init_numpy(seed=0)
    return jm, tm, jax.tree.map(jnp.asarray, params), pytree_params_from_numpy(params, "cpu")


def _key(seed):
    return prng.PRNGKey(torch.tensor(seed))


@pytest.mark.parametrize("seed,num", [(0, 1), (1, 8), (2**31 - 1, 512), (123456789, 33)])
def test_split_is_jax_random_split_bit_for_bit(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num)).astype(np.int64)
    np.testing.assert_array_equal(prng.split(_key(seed), num).numpy(), want)
    # a batch of keys splits key by key
    keys = torch.stack([_key(seed), _key(seed + 1)])
    np.testing.assert_array_equal(prng.split(keys, num)[1].numpy(), np.asarray(
        jax.random.split(jax.random.PRNGKey(seed + 1), num)).astype(np.int64))


@pytest.mark.parametrize("moe", [False, True])
def test_prefill_and_decode_step_match_jax(moe):
    jm, tm, jp, tp = _models(**(MOE if moe else {}))
    prompt = tf.make_lm_data(3, 5, 128, seed=5)
    jc, tc = jax_gen.init_kv_cache(jm.config, 3), gen.init_kv_cache(tm.config, 3, "cpu")
    want, jc = jax_gen.prefill(jm, jp, jc, jnp.asarray(prompt))
    got, tc = gen.prefill(tm, tp, tc, torch.as_tensor(prompt))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= ATOL
    for pos, tok in ((5, [1, 2, 3]), (6, [7, 0, 127])):
        tok = np.asarray(tok, np.int32)
        want, jc = jax_gen.decode_step(jm, jp, jc, jnp.asarray(tok), jnp.int32(pos))
        got, tc = gen.decode_step(tm, tp, tc, torch.as_tensor(tok), torch.tensor([pos]))
        assert got.shape == (3, 128) and got.dtype == torch.float32
        assert np.abs(got.numpy() - np.asarray(want)).max() <= ATOL, pos
    for name in ("k", "v"):
        assert np.abs(tc[name].numpy() - np.asarray(jc[name])).max() <= ATOL


def test_the_cache_is_written_in_place():
    _, tm, _, tp = _models()
    cache = gen.init_kv_cache(tm.config, 2, "cpu")
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    _, cache = gen.prefill(tm, tp, cache, torch.as_tensor(tf.make_lm_data(2, 4, 128, seed=1)))
    _, cache = gen.decode_step(tm, tp, cache, torch.tensor([3, 4]), torch.tensor([4]))
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert cache["k"][:, :, :, :5].abs().sum() > 0 and cache["k"][:, :, :, 5:].abs().sum() == 0


@pytest.mark.parametrize("moe", [False, True])
def test_greedy_tokens_are_the_references(moe):
    jm, tm, jp, tp = _models(**(MOE if moe else {}))
    prompt = tf.make_lm_data(2, 4, 128, seed=6)
    want = np.asarray(jax_gen.make_generate_fn(jm, 4, 12)(jp, jnp.asarray(prompt)))
    got = gen.make_generate_fn(tm, 4, 12)(tp, prompt)
    assert got.dtype == torch.int32 and got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_temperature_tokens_equal_the_references(seed):
    """Draws from jax's threefry keys: the same tokens on these seeds (see the
    module's note on the last bit of the gumbel logs). No key means
    PRNGKey(0)."""
    jm, tm, jp, tp = _models()
    prompt = tf.make_lm_data(2, 2, 128, seed=7)
    jfn = jax_gen.make_generate_fn(jm, 2, 10, temperature=1.0)
    tfn = gen.make_generate_fn(tm, 2, 10, temperature=1.0)
    want = np.asarray(jfn(jp, jnp.asarray(prompt), jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(tfn(tp, prompt, _key(seed)).numpy(), want)
    if seed == 1:
        np.testing.assert_array_equal(tfn(tp, prompt).numpy(),
                                      np.asarray(jfn(jp, jnp.asarray(prompt))))


def test_cache_decode_matches_the_full_forward():
    """Stepping a sequence through the cache reproduces the full forward's
    logits at every position (MoE at a capacity that drops no token in the
    full forward either, as decode's no-drop routing drops none)."""
    _, tm, _, tp = _models(**MOE, moe_capacity_factor=4.0)
    tokens = torch.as_tensor(tf.make_lm_data(3, 16, 128, seed=4))
    with torch.no_grad():
        full = tm.apply(tp, tokens)
        cache = gen.init_kv_cache(tm.config, 3, "cpu")
        for pos in range(16):
            logits, cache = gen.decode_step(tm, tp, cache, tokens[:, pos], torch.tensor([pos]))
            np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), rtol=2e-4,
                                       atol=2e-4)


def test_the_length_bound_and_the_prompt_length_are_checked():
    _, tm, _, tp = _models()
    with pytest.raises(ValueError, match="max_seq"):
        gen.make_generate_fn(tm, prompt_len=30, num_new=10)
    with pytest.raises(ValueError, match="expected 4"):
        gen.make_generate_fn(tm, 4, 2)(tp, tf.make_lm_data(1, 5, 128))
