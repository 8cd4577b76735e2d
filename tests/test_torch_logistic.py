"""The logistic loss's gradient at a logit of exactly 0, against the reference (C9).

FM's and Wide&Deep's ``compute`` on pulled rows whose logits are exactly 0
(all rows zero: zero wide weights and bias, zero embeddings, no live hidden
unit), and on rows where only some examples' logits are 0 (Wide&Deep with
ReLU units dead for them): the port's deltas and losses against
``harmony_tpu.apps.widedeep``'s on the same numpy rows. The reference takes
``jnp.maximum(x, 0)``'s gradient at the tie as 0; the port's ``relu`` does
too (``torch.maximum`` would split it: 0.5). Deltas within 1e-7 absolutely
(f32 sums in another order); losses within 1e-6 (the two libraries' f32
``log1p`` differ by a few ulps at log 2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.apps import widedeep as J
from harmony_tpu_torch.apps import widedeep as T

KW = dict(vocab_size=64, num_slots=4, emb_dim=4, step_size=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def both(name, rows, ids, y, **extra):
    jt, tt = getattr(J, name)(**KW, **extra), getattr(T, name)(**KW, **extra)
    jd, jm = jt.compute(jnp.asarray(rows), (jnp.asarray(ids), jnp.asarray(y)), {"lr": 0.5})
    td, tm = tt.compute(torch.as_tensor(rows), (torch.as_tensor(ids), torch.as_tensor(y)),
                        {"lr": torch.tensor(0.5)})
    return (np.asarray(jd), float(jm["loss"])), (td.numpy(), float(tm["loss"])), tt


@pytest.mark.parametrize("name,extra", [("FMTrainer", {}), ("WideDeepTrainer", {"hidden": 8})])
def test_zero_logits_take_the_references_gradient(name, extra):
    ids, y = T.make_synthetic(32, 64, 4, seed=2)
    tt = getattr(T, name)(**KW, **extra)
    rows = np.zeros((32 * 4 + tt.num_extra_rows, tt.width), np.float32)
    (jd, jl), (td, tl), _ = both(name, rows, ids, y, **extra)
    assert abs(jl - tl) <= 1e-6 and tl == pytest.approx(np.log(2.0))
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-7)
    # the tie's gradient is 0: the bias row moves by lr * mean(y), not lr * mean(y - 0.5)
    np.testing.assert_allclose(td[32 * 4, 0], 0.5 * y.mean(), rtol=0, atol=1e-7)


def test_dead_hidden_units_for_some_examples():
    """Wide&Deep at its init: zero wide weights and bias, small embeddings,
    He-init W1 and W2 with a negative first-layer bias that kills every
    hidden unit for most examples: their logits are exactly 0."""
    ids, y = T.make_synthetic(64, 64, 4, seed=3)
    tt = T.WideDeepTrainer(**KW, hidden=8)
    rng = np.random.default_rng(4)
    emb = np.zeros((64 * 4, tt.width), np.float32)
    emb[:, 1:] = rng.normal(scale=0.1, size=(64 * 4, tt.k))
    tail = tt._init_extra_rows(np.random.default_rng(5))
    flat = tail[1:].reshape(-1)
    d_in, h = 4 * tt.k, 8
    flat[d_in * h:d_in * h + h] = -0.3          # b1: most units dead
    rows = np.concatenate([emb, tail[:1], flat.reshape(-1, tt.width)])
    (jd, jl), (td, tl), _ = both("WideDeepTrainer", rows, ids, y, hidden=8)
    w1 = flat[:d_in * h].reshape(d_in, h)
    pre = emb[:, 1:].reshape(64, -1) @ w1 - 0.3
    assert ((pre <= 0).all(axis=1)).sum() > 0    # some examples' logits are exactly 0
    assert abs(jl - tl) <= 1e-6
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-7)
