"""The port's MoE FFN and MoE LM against harmony_tpu's, on the CPU.

harmony_tpu_torch.models.moe and the MoE half of models/transformer.py against
harmony_tpu.models.moe and harmony_tpu.models.transformer: the same numpy
weights and tokens go to both (weights from the port's numpy init, which for
the LM is the JAX package's ``init_numpy`` byte for byte).

Tolerances: routing (each token's expert and slot, the kept set) and the
dispatched rows are exact: the router products are the same f32 sums in another
order only where no two probabilities of a token lie within a few ulps, which
these seeded inputs never give, and every non-zero term of the reference's
one-hot sums is a single product. Outputs and the aux loss agree to 1e-5
absolute (values of order 1, f32 sums in another order); gradients to 1e-5
relative to the largest magnitude in the tensor; LM losses of order 4 to 1e-5.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from harmony_tpu.models import moe as jax_moe
from harmony_tpu.models import transformer as jax_tf
from harmony_tpu_torch import cli
from harmony_tpu_torch.convert import pytree_rows_from_numpy
from harmony_tpu_torch.models import moe
from harmony_tpu_torch.models import transformer as tf
from harmony_tpu_torch.models.pytree_trainer import ravel_numpy, tree_leaves, unravel

ATOL = 1e-5
REL = 1e-5
MOE_LM = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4, d_ff=64, max_seq=64,
              moe_experts=4, moe_every=2, moe_capacity_factor=1.0)


def _close_rel(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    gap, tol = np.abs(got - want).max(), REL * max(np.abs(want).max(), 1e-30)
    assert gap <= tol, (what, gap, tol)


def _setup(E=4, d=8, f=16, T=64, cap=4.0, seed=0):
    cfg = moe.MoEConfig(num_experts=E, d_model=d, d_ff=f, capacity_factor=cap)
    rng = np.random.default_rng(seed)
    params = moe.init_moe_params(rng, cfg)
    x = rng.standard_normal((T, d)).astype(np.float32)
    return cfg, params, x


def _jax_cfg(cfg):
    return jax_moe.MoEConfig(cfg.num_experts, cfg.d_model, cfg.d_ff, cfg.capacity_factor)


@pytest.mark.parametrize("cap", [4.0, 1.0, 0.5])
def test_routing_and_dispatched_rows_are_the_references(cap):
    """Expert choice, slots and the kept set exact; the [E, C, d] buckets the
    experts see byte-identical to the reference's one-hot einsum."""
    cfg, params, x = _setup(cap=cap)
    E, C = cfg.num_experts, cfg.capacity(x.shape[0])
    disp, _, aux = jax_moe._dispatch_combine(jnp.asarray(x), jnp.asarray(params["router"]), E, C)
    disp = np.asarray(disp)                                  # [T, E, C] one-hot
    r = moe.route(torch.as_tensor(x), torch.as_tensor(params["router"]), E, C)
    kept = disp.sum(axis=(1, 2)) > 0
    np.testing.assert_array_equal(r.keep.numpy(), kept)
    t, e, c = np.nonzero(disp)
    np.testing.assert_array_equal(r.expert.numpy()[t], e)
    np.testing.assert_array_equal(r.slot.numpy()[t], c)
    assert kept.all() if cap == 4.0 else not kept.all()   # C >= T keeps every token
    want_xe = np.asarray(jnp.einsum("tec,td->ecd", disp, jnp.asarray(x)))
    np.testing.assert_array_equal(moe.dispatch(torch.as_tensor(x), r, E, C).numpy(), want_xe)
    assert abs(float(r.aux) - float(aux)) <= ATOL


@pytest.mark.parametrize("cap", [4.0, 1.0])
def test_moe_ffn_output_aux_and_gradients_match_jax(cap):
    cfg, params, x = _setup(cap=cap, seed=1)
    jcfg = _jax_cfg(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def jax_loss(p, x):
        out, aux = jax_moe.moe_ffn(p, x, jcfg)
        return jnp.sum(out ** 2) + aux

    jout, jaux = jax_moe.moe_ffn(jp, jnp.asarray(x), jcfg)
    jgrads = jax.grad(jax_loss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: torch.as_tensor(v).requires_grad_(True) for k, v in params.items()}
    tx = torch.as_tensor(x).requires_grad_(True)
    out, aux = moe.moe_ffn(tp, tx, cfg)
    assert out.dtype == torch.float32 and aux.shape == ()
    assert np.abs(out.detach().numpy() - np.asarray(jout)).max() <= ATOL
    assert abs(float(aux.detach()) - float(jaux)) <= ATOL
    ((out ** 2).sum() + aux).backward()
    for k in params:
        _close_rel(tp[k].grad, jgrads[0][k], f"d{k}")
    _close_rel(tx.grad, jgrads[1], "dx")


def test_capacity_drops_tokens():
    """Capacity 1 per expert: surplus tokens output exactly 0 (the caller's
    residual passes them through), the same rows as the reference's."""
    cfg, params, x = _setup(T=32, cap=0.125)  # C = 1
    assert cfg.capacity(32) == 1
    out, _ = moe.moe_ffn({k: torch.as_tensor(v) for k, v in params.items()},
                         torch.as_tensor(x), cfg)
    jout, _ = jax_moe.moe_ffn({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(x), _jax_cfg(cfg))
    zero = (out.abs().sum(dim=1) == 0).numpy()
    np.testing.assert_array_equal(zero, np.abs(np.asarray(jout)).sum(axis=1) == 0)
    assert zero.sum() >= 32 - cfg.num_experts and (~zero).sum() >= 1


def test_no_drop_keeps_every_token_in_ffn_apply():
    """ffn_apply(no_drop=True) lifts the capacity to every token, as decode
    routes them; without it the training capacity drops some."""
    kw = dict(MOE_LM, moe_capacity_factor=0.5)
    params = tf.TransformerLM(tf.TransformerConfig(**kw)).init(seed=2)
    layer = params["layers"][1]
    xn = np.random.default_rng(3).standard_normal((2, 16, 32)).astype(np.float32)
    jcfg, tcfg = jax_tf.TransformerConfig(**kw), tf.TransformerConfig(**kw)
    for no_drop in (False, True):
        want, waux = jax_tf.ffn_apply(jcfg, jax.tree.map(jnp.asarray, layer), jnp.asarray(xn),
                                      no_drop=no_drop)
        got, gaux = tf.ffn_apply(tcfg, jax.tree.map(torch.as_tensor, layer),
                                 torch.as_tensor(xn), no_drop=no_drop)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= ATOL
        assert abs(float(gaux) - float(waux)) <= ATOL
        dropped = (got.reshape(-1, 32).abs().sum(dim=1) == 0).sum()
        assert (dropped == 0) if no_drop else (dropped > 0)


def test_moe_lm_init_is_the_references_init_numpy():
    want = jax_tf.TransformerLM(jax_tf.TransformerConfig(**MOE_LM)).init_numpy(seed=7)
    model = tf.TransformerLM(tf.TransformerConfig(**MOE_LM))
    got = model.init(seed=7)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert "moe" in got["layers"][1] and "w1" in got["layers"][0]
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    template = jax.eval_shape(lambda: jax_tf.TransformerLM(
        jax_tf.TransformerConfig(**MOE_LM)).init(jax.random.PRNGKey(0)))
    assert [tuple(s.shape) for s in jax.tree.leaves(template)] == list(
        tree_leaves(model.param_shapes()))
    np.testing.assert_array_equal(pytree_rows_from_numpy(got, 256).reshape(-1)[:ravel_numpy(
        want).shape[0]], np.asarray(ravel_pytree(want)[0]))


@pytest.mark.parametrize("attn,remat", [("flash", False), ("blockwise", False),
                                        ("flash", True)])
def test_moe_lm_loss_and_gradients_match_jax(attn, remat):
    """The MoE LM's loss (CE + 0.01 aux) and the gradient of every parameter,
    f32, against the JAX TransformerLM from the same init_numpy weights."""
    params = jax_tf.TransformerLM(jax_tf.TransformerConfig(**MOE_LM)).init_numpy(seed=5)
    tokens = tf.make_lm_data(4, 33, 64, seed=6)
    jmodel = jax_tf.TransformerLM(jax_tf.TransformerConfig(**MOE_LM, attn=attn, remat=remat))
    want_loss, want_grads = jax.value_and_grad(jmodel.loss)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens))
    tmodel = tf.TransformerLM(tf.TransformerConfig(**MOE_LM, attn=attn, remat=remat))
    flat = torch.as_tensor(ravel_numpy(params)).requires_grad_(True)
    loss = tmodel.loss(unravel(flat, tmodel.param_shapes()), torch.as_tensor(tokens))
    (grad,) = torch.autograd.grad(loss, flat)
    assert abs(float(loss.detach()) - float(want_loss)) <= ATOL
    _close_rel(grad, ravel_pytree(want_grads)[0], f"gradients ({attn}, remat={remat})")


def test_moe_aux_joins_the_loss_at_its_weight():
    params = tf.TransformerLM(tf.TransformerConfig(**MOE_LM)).init(seed=4)
    tokens = torch.as_tensor(tf.make_lm_data(2, 17, 64, seed=4))
    model = tf.TransformerLM(tf.TransformerConfig(**MOE_LM, moe_aux_weight=0.5))
    with torch.no_grad():
        logits, aux = model._apply_with_aux(
            jax.tree.map(torch.as_tensor, params), tokens[:, :-1])
        ce = tf._next_token_ce(logits, tokens[:, 1:])
        loss = model.loss(jax.tree.map(torch.as_tensor, params), tokens)
    assert float(aux) >= 2.0 - 1e-6   # two MoE blocks, each aux >= 1
    assert torch.equal(loss, ce + 0.5 * aux)


def test_moe_trainer_compute_matches_jax_over_three_steps():
    """TransformerTrainer.compute of the MoE LM from the same table rows, three
    SGD steps, each delta folded back as the table's push folds it."""
    kw = dict(MOE_LM, row_width=256, step_size=0.05)
    jtrainer = jax_tf.TransformerTrainer(**kw)
    ttrainer = tf.TransformerTrainer(**kw)
    assert ttrainer.capacity == jtrainer.capacity and ttrainer.num_rows == jtrainer.num_rows
    model = np.zeros((jtrainer.capacity, 256), np.float32)
    model[: jtrainer.num_rows] = pytree_rows_from_numpy(jtrainer.model.init_numpy(seed=3), 256)
    jmodel, tmodel = jnp.asarray(model), torch.as_tensor(model)
    for step in range(3):
        tokens = tf.make_lm_data(4, 33, 64, seed=20 + step)
        jdelta, jm = jtrainer.compute(jmodel, (jnp.asarray(tokens),), {"lr": jnp.asarray(0.05)})
        with torch.no_grad():
            tdelta, tm = ttrainer.compute(tmodel, (torch.as_tensor(tokens),),
                                          {"lr": torch.tensor(0.05)})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= ATOL, step
        _close_rel(tdelta, jdelta, f"step {step} delta")
        jmodel, tmodel = jmodel + jdelta, tmodel + tdelta


def test_moe_forward_and_backward_are_deterministic():
    params = tf.TransformerLM(tf.TransformerConfig(**MOE_LM)).init(seed=9)
    tokens = torch.as_tensor(tf.make_lm_data(4, 33, 64, seed=9))
    model = tf.TransformerLM(tf.TransformerConfig(**MOE_LM))
    runs = []
    for _ in range(2):
        flat = torch.as_tensor(ravel_numpy(params)).requires_grad_(True)
        loss = model.loss(unravel(flat, model.param_shapes()), tokens)
        runs.append((loss.detach(), torch.autograd.grad(loss, flat)[0]))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_expert_parallelism_raises_naming_the_roadmap_item():
    """Expert parallelism, ported (ROADMAP A.9): the experts split over 2
    slots, given as the slots' lists, against the reference's
    ``moe_ffn(axis_name=...)`` under shard_map over 2 devices; on one tensor an
    ``axis_name`` is refused, naming the lists."""
    from jax.sharding import Mesh, PartitionSpec as P

    cfg, params, x = _setup(cap=1.0)
    mesh = Mesh(np.asarray(jax.devices()[:2], dtype=object).reshape(2), ("expert",))
    want, want_aux = jax.shard_map(
        lambda p, xs: (lambda o, a: (o, a[None]))(
            *jax_moe.moe_ffn(p, xs, _jax_cfg(cfg), axis_name="expert")),
        mesh=mesh, in_specs=({"router": P(), "w1": P("expert"), "w2": P("expert")},
                             P("expert")),
        out_specs=(P("expert"), P("expert")))(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    slot_params = [{"router": torch.as_tensor(params["router"]),
                    "w1": torch.as_tensor(params["w1"][i * 2:(i + 1) * 2]),
                    "w2": torch.as_tensor(params["w2"][i * 2:(i + 1) * 2])} for i in range(2)]
    outs, aux = moe.moe_ffn(slot_params, list(torch.as_tensor(x).chunk(2)), cfg)
    assert abs(torch.cat(outs).numpy() - np.asarray(want)).max() <= ATOL
    assert abs(torch.stack(aux).numpy() - np.asarray(want_aux)).max() <= 1e-6
    with pytest.raises(ValueError, match="slots' lists"):
        moe.moe_ffn({k: torch.as_tensor(v) for k, v in params.items()}, torch.as_tensor(x),
                    cfg, axis_name="expert")


def test_cli_lm_passes_the_moe_keys_through():
    ns = argparse.Namespace(job_id=None, epochs=1, batches=2, data=[],
                            set=["moe_experts=8", "moe_every=2", "moe_capacity_factor=1.5",
                                 "moe_aux_weight=0.01"])
    cfg = cli.build_config("lm", ns)
    trainer = tf.TransformerTrainer(**cfg.params.app_params)
    assert trainer.config.moe_experts == 8 and trainer.config.moe_cfg.capacity(32768) == 6144
    assert [trainer.config.is_moe_layer(i) for i in range(2)] == [False, True]
