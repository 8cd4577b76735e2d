"""harmony_tpu_torch.utils.prng against jax.random (threefry2x32, partitionable).

Keys, fold_in, random bits and uniforms are integer and bit arithmetic:
compared bit for bit. Gumbel draws -log(-log(u)) go through two logs, each of
which PyTorch and XLA may round differently in the last bit; the inner one's
ulp near 1 (2**-23) passes into the draw as an absolute error, so they agree
within 2**-21 * max(1, |draw|). Categorical draws are
argmaxes over logits + gumbel: equal draw for draw on these logits (a draw
could differ only where two scores tie to within that ulp).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu_torch.utils import prng


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


assert jax.config.jax_threefry_partitionable   # the mode the port reproduces

SEEDS = np.random.default_rng(0).integers(0, 2**31 - 1, 64).astype(np.int32)


def _jax_keys(seeds, epoch):
    """LDA's keys: vmap over seeds of fold_in(PRNGKey(seed), epoch)."""
    return np.asarray(_jax_fold(jnp.asarray(seeds).astype(jnp.uint32),
                                jnp.uint32(epoch))).astype(np.int64)


@jax.jit
def _jax_fold(seeds, epoch):
    return jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(s), epoch))(seeds)


@functools.partial(jax.jit, static_argnums=1)
def _jax_bits(keys, shape):
    return jax.vmap(lambda k: jax.random.bits(k, shape))(keys)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_uniform(keys, shape, lo, hi):
    return jax.vmap(lambda k: jax.random.uniform(k, shape, minval=lo, maxval=hi))(keys)


def _torch_keys(seeds, epoch):
    return prng.fold_in(prng.PRNGKey(torch.as_tensor(seeds).long() & prng.MASK),
                        torch.tensor(epoch))


@pytest.mark.parametrize("key,count,want", [
    # Random123's known answers for Threefry-2x32 (20 rounds)
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, count, want):
    out = prng.threefry_2x32(*(torch.tensor(v, dtype=torch.int64) for v in key + count))
    assert tuple(int(v) for v in out) == want


def test_prngkey_is_jax_threefry_seed():
    seeds = np.concatenate([SEEDS, [0, 1, 2**31 - 1]]).astype(np.int32)
    want = np.asarray(jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds).astype(jnp.uint32)))
    got = prng.PRNGKey(torch.as_tensor(seeds).long() & prng.MASK)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(prng.PRNGKey(torch.tensor(2**40 + 5)).numpy(), [256, 5])


@pytest.mark.parametrize("epoch", [0, 1, 11])
def test_fold_in_bits_and_uniform_are_jax_bit_for_bit(epoch):
    jkeys = _jax_keys(SEEDS, epoch)
    tkeys = _torch_keys(SEEDS, epoch)
    np.testing.assert_array_equal(tkeys.numpy(), jkeys)
    ukeys = jnp.asarray(jkeys, jnp.uint32)
    for shape in [(5, 7), (3,), ()]:
        jb = np.asarray(_jax_bits(ukeys, shape))
        np.testing.assert_array_equal(prng.random_bits(tkeys, shape).numpy(),
                                      jb.astype(np.int64))
    for lo, hi in [(0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0)]:
        ju = np.asarray(_jax_uniform(ukeys, (16, 9), lo, hi))
        tu = prng.uniform(tkeys, (16, 9), minval=lo, maxval=hi).numpy()
        np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))


def test_gumbel_within_the_logs_rounding():
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.gumbel(key, (512, 64)))
    got = prng.gumbel(prng.PRNGKey(torch.tensor(3)), (512, 64)).numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -21 * np.maximum(1.0, np.abs(want)))


def test_categorical_draws_as_jax_on_identical_logits():
    logits = np.random.default_rng(1).normal(scale=2.0, size=(4096, 64)).astype(np.float32)
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(7), jnp.asarray(logits)))
    got = prng.categorical(prng.PRNGKey(torch.tensor(7)), torch.as_tensor(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_over_a_batch_of_keys_as_ldas_vmap():
    """LDA's draw: one key a document, logits [B, L, K]."""
    logits = np.random.default_rng(2).normal(size=(64, 32, 16)).astype(np.float32)
    jkeys = jnp.asarray(_jax_keys(SEEDS, 3), jnp.uint32)
    want = np.asarray(jax.jit(jax.vmap(lambda k, lg: jax.random.categorical(k, lg, axis=-1)))(
        jkeys, jnp.asarray(logits)))
    got = prng.categorical(_torch_keys(SEEDS, 3), torch.as_tensor(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_takes_float32_logits_only():
    with pytest.raises(TypeError):
        prng.categorical(prng.PRNGKey(torch.tensor(0)), torch.zeros((2, 3), dtype=torch.float64))
