"""The port's sequence- and tensor-parallel LM steps against harmony_tpu's, on the CPU.

make_sp_train_step and make_parallel_train_step of harmony_tpu_torch.models.
transformer, on virtual CPU slots (``DevicePool.virtual("cpu", 8)``), against
the JAX package's on its 8 virtual CPU devices: the same ``init_numpy``
weights and tokens go to both, one step each. The JAX steps are computed once
per module and case (each is a shard_map compile of ~2 s).

Tolerances (the reference's own, tests/test_models.py's SP and 3-axis tests
against one-device math): the loss within 1e-5 absolute (f32, order 4, the
two packages differ in the order of their sums), the new parameters within
2e-4 absolute. Where both sides copy (targets, the TP layout) the comparison
is exact; where one package runs the same arithmetic twice (remat, donate),
bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.models import transformer as jax_tf
from harmony_tpu.parallel import build_mesh as jax_build_mesh
from harmony_tpu_torch.convert import pytree_params_from_numpy
from harmony_tpu_torch.models import transformer as tf
from harmony_tpu_torch.models.pytree_trainer import tree_leaves, tree_unflatten
from harmony_tpu_torch.parallel.mesh import DevicePool, build_mesh

LOSS_ATOL = 1e-5
PARAM_ATOL = 2e-4
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=64)
CASES = {
    "ring": dict(sp_attn="ring"),
    "a2a": dict(sp_attn="a2a"),
    "moe": dict(sp_attn="ring", moe_experts=4, moe_every=2),
}


def _mesh(data, seq, model=1):
    return build_mesh(DevicePool.virtual("cpu", data * seq * model).slots,
                      data=data, seq=seq, model=model)


def _jax_mesh(data, seq, model=1):
    return jax_build_mesh(jax.devices()[:data * seq * model], data=data, seq=seq, model=model)


def _tokens(seed, B=4, S=32):
    return tf.make_lm_data(B, S, SMALL["vocab_size"], seed=seed)


def _port_params(params):
    return pytree_params_from_numpy(params, device="cpu")


def _assemble(leaf):
    """A ModelShards joined in the test (shard order along its dim)."""
    if isinstance(leaf, tf.ModelShards):
        return torch.cat(leaf.shards, dim=leaf.dim)
    return leaf


def _check_params(got, want):
    got, want = list(tree_leaves(got)), list(tree_leaves(jax.tree.map(np.asarray, want)))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = _assemble(a).detach().numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL)


@pytest.fixture(scope="module")
def jax_sp():
    """The reference's SP step on (data 2, seq 4), computed once per case."""
    cache = {}

    def get(case):
        if case not in cache:
            model = jax_tf.TransformerLM(jax_tf.TransformerConfig(**SMALL, **CASES[case]))
            params = model.init_numpy(seed=1)
            step = jax_tf.make_sp_train_step(model, _jax_mesh(2, 4), 0.1, donate=False)
            new, loss = step(jax.tree.map(jnp.asarray, params), jnp.asarray(_tokens(2)))
            cache[case] = params, new, float(loss)
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_step_matches_the_references(jax_sp, case):
    params, want_params, want_loss = jax_sp(case)
    model = tf.TransformerLM(tf.TransformerConfig(**SMALL, **CASES[case]))
    mesh = _mesh(2, 4)
    step = tf.make_sp_train_step(model, mesh, 0.1, donate=False)
    new, loss = step(_port_params(params), torch.as_tensor(_tokens(2)))
    assert loss.shape == () and loss.device == mesh.slots[0].device
    assert abs(float(loss) - want_loss) <= LOSS_ATOL
    _check_params(new, want_params)


@pytest.fixture(scope="module")
def jax_tp():
    cache = {}

    def get(sp_attn):
        if sp_attn not in cache:
            model = jax_tf.TransformerLM(jax_tf.TransformerConfig(**SMALL, sp_attn=sp_attn))
            params = model.init_numpy(seed=3)
            step, shard = jax_tf.make_parallel_train_step(model, _jax_mesh(2, 2, 2), 0.1,
                                                          donate=False)
            new, loss = step(shard(jax.tree.map(jnp.asarray, params)),
                             jnp.asarray(_tokens(4)))
            cache[sp_attn] = params, new, float(loss)
        return cache[sp_attn]

    return get


@pytest.mark.parametrize("sp_attn", ["ring", "a2a"])
def test_parallel_step_matches_the_references(jax_tp, sp_attn):
    """(data 2, seq 2, model 2): a replicated leaf's gradient counted once per
    (data, seq) position, not once per model index (a 2x gradient fails)."""
    params, want_params, want_loss = jax_tp(sp_attn)
    model = tf.TransformerLM(tf.TransformerConfig(**SMALL, sp_attn=sp_attn))
    mesh = _mesh(2, 2, 2)
    step, shard = tf.make_parallel_train_step(model, mesh, 0.1, donate=False)
    tp_params = shard(_port_params(params))
    new, loss = step(tp_params, torch.as_tensor(_tokens(4)))
    assert loss.device == mesh.slots[0].device
    assert abs(float(loss) - want_loss) <= LOSS_ATOL
    _check_params(new, want_params)


def test_tp_layout_is_the_references():
    params = jax_tf.TransformerLM(jax_tf.TransformerConfig(**SMALL)).init_numpy(seed=5)
    want = jax_tf.to_tp_params(jax.tree.map(jnp.asarray, params))
    got = tf.to_tp_params(params)
    for a, b in zip(tree_leaves(got), tree_leaves(jax.tree.map(np.asarray, want))):
        np.testing.assert_array_equal(a, b)
    specs = tf.tp_param_specs(2, "model")
    want_specs = jax_tf.tp_param_specs(2, "model")
    assert [tuple(s) for s in tree_leaves(specs)] == [
        tuple(s) for s in jax.tree.leaves(want_specs, is_leaf=lambda s: isinstance(s, tuple))]
    mesh = _mesh(1, 2, 2)
    _, shard = tf.make_parallel_train_step(tf.TransformerLM(tf.TransformerConfig(**SMALL)), mesh)
    placed = shard(_port_params(params))
    wq = placed["layers"][0]["wq"]
    assert isinstance(wq, tf.ModelShards) and wq.dim == 1 and len(wq.shards) == 2
    assert [s.device for s in wq.shards] == [mesh.slot_at({"model": m}).device for m in (0, 1)]
    for a, b in zip(tree_leaves(placed), tree_leaves(got)):
        np.testing.assert_array_equal(_assemble(a).numpy(), b)


def _error(make):
    with pytest.raises(ValueError) as e:
        make()
    return str(e.value)


@pytest.mark.parametrize("what,cfg,shape", [
    ("moe", dict(moe_experts=4), (1, 1, 2)),
    ("heads", dict(n_heads=2), (1, 1, 4)),
    ("widths", dict(d_ff=66), (1, 1, 4)),
    ("a2a", dict(n_heads=2, sp_attn="a2a"), (1, 2, 2)),
])
def test_parallel_step_refuses_what_the_reference_refuses(what, cfg, shape):
    want = _error(lambda: jax_tf.make_parallel_train_step(
        jax_tf.TransformerLM(jax_tf.TransformerConfig(**{**SMALL, **cfg})), _jax_mesh(*shape)))
    got = _error(lambda: tf.make_parallel_train_step(
        tf.TransformerLM(tf.TransformerConfig(**{**SMALL, **cfg})), _mesh(*shape)))
    assert got == want


def test_config_refuses_an_unknown_sp_attn():
    want = _error(lambda: jax_tf.TransformerConfig(**SMALL, sp_attn="ulysses"))
    assert _error(lambda: tf.TransformerConfig(**SMALL, sp_attn="ulysses")) == want


def test_targets_and_mask_are_the_references():
    tokens = _tokens(6)
    want = jax_tf._lm_targets_and_mask(jnp.asarray(tokens))
    got = tf._lm_targets_and_mask(torch.as_tensor(tokens))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_apply_with_pos_offset_matches_the_references():
    """A sequence shard embedded from global position 16 (the second of two
    shards of 32 tokens): the logits of the reference's apply."""
    params = jax_tf.TransformerLM(jax_tf.TransformerConfig(**SMALL)).init_numpy(seed=7)
    tokens = _tokens(8)[:, 16:]
    jmodel = jax_tf.TransformerLM(jax_tf.TransformerConfig(**SMALL, attn="blockwise"))
    want = np.asarray(jmodel.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(tokens),
                                   pos_offset=16))
    model = tf.TransformerLM(tf.TransformerConfig(**SMALL, attn="blockwise"))
    got = model.apply(_port_params(params), torch.as_tensor(tokens), pos_offset=16)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5 * np.abs(want).max())
    at_zero = model.apply(_port_params(params), torch.as_tensor(tokens))
    assert not torch.equal(got, at_zero)


@pytest.mark.parametrize("kind", ["sp", "parallel"])
def test_donate_updates_in_place_and_otherwise_leaves_the_params(kind):
    model = tf.TransformerLM(tf.TransformerConfig(**SMALL))
    params = model.init(seed=9)
    tokens = torch.as_tensor(_tokens(10))
    mesh = _mesh(2, 2, 2 if kind == "parallel" else 1)

    def make(donate):
        if kind == "sp":
            return tf.make_sp_train_step(model, mesh, 0.1, donate=donate), _port_params
        step, shard = tf.make_parallel_train_step(model, mesh, 0.1, donate=donate)
        return step, lambda p: shard(_port_params(p))

    def flat(tree):
        return [_assemble(x).clone() for x in tree_leaves(tree)]

    step, place = make(False)
    kept = place(params)
    before = flat(kept)
    new_kept, loss_kept = step(kept, tokens)
    assert all(torch.equal(a, b) for a, b in zip(flat(kept), before))
    step, place = make(True)
    donated = place(params)
    objects = [id(x) for x in tree_leaves(donated)]
    new_donated, loss_donated = step(donated, tokens)
    assert [id(x) for x in tree_leaves(new_donated)] == objects
    assert torch.equal(loss_kept, loss_donated)
    assert all(torch.equal(a, b) for a, b in zip(flat(new_kept), flat(new_donated)))
    assert all(torch.equal(a, b) for a, b in zip(flat(donated), flat(new_donated)))
    assert not all(torch.equal(a, b) for a, b in zip(before, flat(donated)))


@pytest.mark.parametrize("sp_attn", ["ring", "a2a"])
def test_remat_gives_the_same_bits(sp_attn):
    params = tf.TransformerLM(tf.TransformerConfig(**SMALL)).init(seed=11)
    tokens = torch.as_tensor(_tokens(12))
    out = []
    for remat in (False, True):
        model = tf.TransformerLM(tf.TransformerConfig(**SMALL, sp_attn=sp_attn, remat=remat))
        new, loss = tf.make_sp_train_step(model, _mesh(2, 4), 0.1, donate=False)(
            _port_params(params), tokens)
        out.append((loss, list(tree_leaves(new))))
    (l0, p0), (l1, p1) = out
    assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_a_one_slot_mesh_gives_the_single_device_step():
    """On one slot the SP step is the one-device LM step: model.loss over
    tokens[:, :-1] and SGD on its gradients (the masked mean sums the same
    terms in another order)."""
    model = tf.TransformerLM(tf.TransformerConfig(**SMALL, attn="blockwise"))
    params = _port_params(model.init(seed=13))
    tokens = torch.as_tensor(_tokens(14))
    new, loss = tf.make_sp_train_step(model, _mesh(1, 1), 0.1, donate=False)(params, tokens)
    leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(params)]
    want = model.loss(tree_unflatten(params, leaves), tokens)
    grads = torch.autograd.grad(want, leaves)
    assert abs(float(loss) - float(want.detach())) <= LOSS_ATOL
    for a, p, g in zip(tree_leaves(new), leaves, grads):
        np.testing.assert_allclose(a.numpy(), (p - 0.1 * g).detach().numpy(), atol=1e-6)


def test_tokens_that_do_not_split_over_the_mesh_are_refused():
    model = tf.TransformerLM(tf.TransformerConfig(**SMALL))
    step = tf.make_sp_train_step(model, _mesh(2, 4), 0.1)
    with pytest.raises(ValueError, match="do not split over a 2 x 4 grid"):
        step(_port_params(model.init(seed=15)), torch.as_tensor(_tokens(16, B=3)))


def test_sp_steps_learn_and_rings_and_a2a_agree():
    """Three steps each: ring and a2a are both exact attention, so their losses
    agree to f32 reordering, and the loss falls."""
    params = tf.TransformerLM(tf.TransformerConfig(**SMALL)).init(seed=17)
    tokens = torch.as_tensor(_tokens(18))
    losses = {}
    for sp_attn in ("ring", "a2a"):
        model = tf.TransformerLM(dataclasses.replace(tf.TransformerConfig(**SMALL),
                                                     sp_attn=sp_attn))
        step = tf.make_sp_train_step(model, _mesh(2, 4), 0.5)
        p = _port_params(params)
        losses[sp_attn] = []
        for _ in range(3):
            p, loss = step(p, tokens)
            losses[sp_attn].append(float(loss))
    np.testing.assert_allclose(losses["ring"], losses["a2a"], atol=LOSS_ATOL)
    assert losses["ring"][-1] < losses["ring"][0]
