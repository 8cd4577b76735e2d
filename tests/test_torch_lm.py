"""The port's transformer LM and its table trainer against harmony_tpu's, on the CPU.

harmony_tpu_torch.models (common, transformer, pytree_trainer) and
dolphin.optim against harmony_tpu.models and harmony_tpu.dolphin.optim: the
same numpy-seeded weights and tokens go to both. Weights come from the JAX
package's ``init_numpy`` (its ``init`` draws from jax.random, which the port
cannot reproduce) and are carried across with ``harmony_tpu_torch.convert``.

Tolerances: every comparison is in f32, and the two packages differ only in
the order of their f32 sums (XLA's CPU dots and reductions against
PyTorch's). A loss of order 4 then agrees to 1e-5 absolute (a few units of
its last place); gradients and deltas, which are differences of such sums,
to 1e-5 relative to the largest magnitude in the tensor. Where both sides
copy bytes (init, flat order, data) the comparison is exact.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from harmony_tpu.dolphin import optim as jax_optim
from harmony_tpu.models import moe as jax_moe
from harmony_tpu.models import common as jax_common
from harmony_tpu.models import transformer as jax_tf
from harmony_tpu_torch import cli
from harmony_tpu_torch.convert import pytree_params_from_numpy, pytree_rows_from_numpy
from harmony_tpu_torch.dolphin import optim
from harmony_tpu_torch.models import common
from harmony_tpu_torch.models.moe import init_moe_params, moe_ffn
from harmony_tpu_torch.models import transformer as tf
from harmony_tpu_torch.models.pytree_trainer import ravel_numpy, tree_leaves, unravel

SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq=64)
LOSS_ATOL = 1e-5
REL = 1e-5


def _close(got, want, what):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    tol = REL * max(np.abs(want).max(), 1e-30)
    gap = np.abs(got - want).max()
    assert gap <= tol, (what, gap, tol)


def _tokens(seed=0, B=4, S=65, vocab=64):
    return tf.make_lm_data(B, S, vocab, seed=seed)


def test_init_is_the_references_init_numpy():
    cfg = dict(SMALL, n_layers=3)
    want = jax_tf.TransformerLM(jax_tf.TransformerConfig(**cfg)).init_numpy(seed=7)
    got = tf.TransformerLM(tf.TransformerConfig(**cfg)).init(seed=7)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_param_shapes_match_jax_init():
    cfg = dict(SMALL, n_layers=3)
    model = tf.TransformerLM(tf.TransformerConfig(**cfg))
    template = jax.eval_shape(
        lambda: jax_tf.TransformerLM(jax_tf.TransformerConfig(**cfg)).init(jax.random.PRNGKey(0)))
    assert [tuple(s.shape) for s in jax.tree.leaves(template)] == list(
        tree_leaves(model.param_shapes()))


def test_flat_order_is_ravel_pytrees():
    params = jax_tf.TransformerLM(jax_tf.TransformerConfig(**SMALL)).init_numpy(seed=1)
    want, _ = ravel_pytree(params)
    flat = ravel_numpy(params)
    np.testing.assert_array_equal(flat, np.asarray(want))
    shapes = tf.TransformerLM(tf.TransformerConfig(**SMALL)).param_shapes()
    back = unravel(torch.as_tensor(flat), shapes)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        np.testing.assert_array_equal(a.numpy(), b)
    # sorted keys: embed, layers[i]{ln1, ln2, w1, w2, wo, wqkv}, ln_f, pos
    d, f, v = SMALL["d_model"], SMALL["d_ff"], SMALL["vocab_size"]
    np.testing.assert_array_equal(flat[:v * d], params["embed"].reshape(-1))
    np.testing.assert_array_equal(flat[v * d:v * d + d], params["layers"][0]["ln1"])
    np.testing.assert_array_equal(flat[-SMALL["max_seq"] * d:], params["pos"].reshape(-1))


def test_convert_carries_rows_and_params():
    row_width = 256
    trainer = jax_tf.TransformerTrainer(row_width=row_width, **SMALL)
    params = trainer.model.init_numpy(seed=2)
    want = np.asarray(trainer._to_rows(ravel_pytree(params)[0]))
    np.testing.assert_array_equal(pytree_rows_from_numpy(params, row_width), want)
    tree = pytree_params_from_numpy(params, device="cpu")
    for a, b in zip(tree_leaves(tree), tree_leaves(params)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 7, 32)).astype(np.float32) * 3
    w = rng.standard_normal(32).astype(np.float32)
    want = jax_common.rms_norm(jnp.asarray(x), jnp.asarray(w))
    _close(common.rms_norm(torch.as_tensor(x), torch.as_tensor(w)), want, "rms_norm")


def test_ffn_uses_the_tanh_gelu_with_gradients():
    rng = np.random.default_rng(4)
    layer = {"w1": rng.standard_normal((32, 64)).astype(np.float32) * 0.3,
             "w2": rng.standard_normal((64, 32)).astype(np.float32) * 0.3}
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    jcfg = jax_tf.TransformerConfig(**SMALL)
    tcfg = tf.TransformerConfig(**SMALL)

    def jax_fn(layer, x):
        return jnp.sum(jax_tf.ffn_apply(jcfg, layer, x)[0] ** 2)

    want_grads = jax.grad(jax_fn)(jax.tree.map(jnp.asarray, layer), jnp.asarray(x))
    tlayer = {k: torch.as_tensor(v).requires_grad_(True) for k, v in layer.items()}
    out, _ = tf.ffn_apply(tcfg, tlayer, torch.as_tensor(x))
    _close(out, jax_tf.ffn_apply(jcfg, jax.tree.map(jnp.asarray, layer), jnp.asarray(x))[0],
           "ffn")
    (out ** 2).sum().backward()
    for key in layer:
        _close(tlayer[key].grad, want_grads[key], f"d{key}")


@pytest.mark.parametrize("attn", ["flash", "blockwise"])
def test_lm_loss_and_gradients_match_jax(attn):
    """The whole model at a small size: loss and the gradient of every
    parameter, f32. On the CPU the JAX package runs its flash kernels in
    interpret mode and the port its plain versions."""
    params = jax_tf.TransformerLM(jax_tf.TransformerConfig(**SMALL)).init_numpy(seed=5)
    tokens = _tokens(seed=6)
    jmodel = jax_tf.TransformerLM(jax_tf.TransformerConfig(**SMALL, attn=attn))
    want_loss, want_grads = jax.value_and_grad(jmodel.loss)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens))
    tmodel = tf.TransformerLM(tf.TransformerConfig(**SMALL, attn=attn))
    flat = torch.as_tensor(ravel_numpy(params)).requires_grad_(True)
    loss = tmodel.loss(unravel(flat, tmodel.param_shapes()), torch.as_tensor(tokens))
    (grad,) = torch.autograd.grad(loss, flat)
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_ATOL
    _close(grad, ravel_pytree(want_grads)[0], f"gradients ({attn})")


def test_remat_gives_the_same_loss_and_gradients():
    params = tf.TransformerLM(tf.TransformerConfig(**SMALL)).init(seed=8)
    tokens = torch.as_tensor(_tokens(seed=9))
    results = []
    for remat in (False, True):
        model = tf.TransformerLM(tf.TransformerConfig(**SMALL, attn="flash", remat=remat))
        flat = torch.as_tensor(ravel_numpy(params)).requires_grad_(True)
        loss = model.loss(unravel(flat, model.param_shapes()), tokens)
        results.append((loss.detach(), torch.autograd.grad(loss, flat)[0]))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1) and torch.equal(g0, g1)  # the same ops, recomputed


@pytest.mark.parametrize("name", sorted(optim.SLOTS))
def test_optim_apply_matches_jax(name):
    rng = np.random.default_rng(10)
    p, g = (rng.standard_normal(257).astype(np.float32) for _ in range(2))
    # slot states as the optimizers leave them: sums and averages of squares
    # (adagrad, rmsprop, adam's v) are non-negative
    m, v = (rng.random(257).astype(np.float32) for _ in range(2))
    hyper = {"lr": 0.05}
    want = jax_optim.apply(name, *(jnp.asarray(a) for a in (p, g, m, v)), jnp.asarray(3.0),
                           {"lr": jnp.asarray(0.05)})
    got = optim.apply(name, *(torch.as_tensor(a) for a in (p, g, m, v)), torch.tensor(3.0),
                      {k: torch.tensor(x) for k, x in hyper.items()})
    assert optim.num_slots(name) == jax_optim.num_slots(name)
    for what, a, b in zip(("params", "m", "v"), got, want):
        _close(a, b, f"{name} {what}")


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_trainer_compute_matches_jax_over_three_steps(optimizer):
    """PyTreeTrainer.compute from the same table rows, three steps, each delta
    folded back as the table's push folds it: the losses and the delta of
    every section (params, m, v and the counter row) agree. Adam runs with
    eps = 0.1: with its default 1e-8 a gradient entry near zero, whose f32
    reordering error is as large as itself, moves its own update by up to lr
    in either package, which is Adam's conditioning, not the port's."""
    kw = dict(SMALL, row_width=256, step_size=0.05, optimizer=optimizer)
    jtrainer = jax_tf.TransformerTrainer(**kw)
    ttrainer = tf.TransformerTrainer(**kw)
    assert ttrainer.capacity == jtrainer.capacity and ttrainer.num_rows == jtrainer.num_rows
    model = np.zeros((jtrainer.capacity, 256), np.float32)
    model[: jtrainer.num_rows] = pytree_rows_from_numpy(jtrainer.model.init_numpy(seed=3), 256)
    jmodel, tmodel = jnp.asarray(model), torch.as_tensor(model)
    hyper = {"lr": 0.05, "eps": 0.1} if optimizer == "adam" else {"lr": 0.05}
    for step in range(3):
        tokens = _tokens(seed=20 + step)
        jdelta, jm = jtrainer.compute(jmodel, (jnp.asarray(tokens),),
                                      {k: jnp.asarray(x) for k, x in hyper.items()})
        with torch.no_grad():  # as the worker runs a step
            tdelta, tm = ttrainer.compute(tmodel, (torch.as_tensor(tokens),),
                                          {k: torch.tensor(x) for k, x in hyper.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL, step
        n = jtrainer.num_rows
        for i, section in enumerate(("params", "m", "v")[: 1 + ttrainer.num_state_slots]):
            _close(tdelta[i * n:(i + 1) * n], jdelta[i * n:(i + 1) * n],
                   f"step {step} {section} delta")
        if ttrainer.num_state_slots:
            np.testing.assert_array_equal(tdelta[-1].numpy(), np.asarray(jdelta[-1]))
        jmodel, tmodel = jmodel + jdelta, tmodel + tdelta


def test_trainer_evaluate_reports_the_loss():
    trainer = tf.TransformerTrainer(**SMALL, row_width=256)
    model = torch.zeros((trainer.capacity, 256))
    model[: trainer.num_rows] = trainer.rows_from_flat(
        torch.from_numpy(ravel_numpy(trainer.model.init(0))))
    tokens = torch.as_tensor(_tokens(seed=1))
    with torch.no_grad():
        loss = trainer.evaluate(model, (tokens,))["loss"]
        want = trainer.compute(model, (tokens,), {"lr": torch.tensor(0.1)})[1]["loss"]
    assert torch.equal(loss, want)


def test_config_dtypes_and_unported_options():
    assert tf.TransformerConfig(vocab_size=8, dtype="bfloat16").dtype == torch.bfloat16
    assert tf.TransformerConfig(vocab_size=8, dtype="float32").dtype == torch.float32
    assert tf.TransformerConfig(vocab_size=8, dtype=torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tf.TransformerConfig(vocab_size=8, dtype="float64")
    with pytest.raises(ValueError):
        tf.TransformerConfig(vocab_size=8, attn="ring")
    with pytest.raises(ValueError):
        tf.TransformerConfig(vocab_size=8, d_model=30, n_heads=4)
    assert tf.TransformerConfig(vocab_size=8, moe_experts=4).is_moe_layer(1)
    with pytest.raises(ValueError, match="moe_every"):
        tf.TransformerConfig(vocab_size=8, moe_experts=4, moe_every=0)
    # expert parallelism over 2 slots: each slot's tokens through the experts
    # of both, the reference's one-device FFN on that slot's tokens (its
    # capacity is a source shard's); an axis_name on one tensor is refused
    cfg = tf.TransformerConfig(vocab_size=8, d_model=8, n_heads=2, moe_experts=2).moe_cfg
    params = init_moe_params(np.random.default_rng(0), cfg)
    x = np.random.default_rng(1).standard_normal((8, 8)).astype(np.float32)
    shards = [{"router": torch.as_tensor(params["router"]),
               "w1": torch.as_tensor(params["w1"][i:i + 1]),
               "w2": torch.as_tensor(params["w2"][i:i + 1])} for i in range(2)]
    outs, _ = moe_ffn(shards, [torch.as_tensor(x[:4]), torch.as_tensor(x[4:])], cfg)
    for out, xi in zip(outs, (x[:4], x[4:])):
        want, _ = jax_moe.moe_ffn(jax.tree.map(jnp.asarray, params), jnp.asarray(xi),
                                  jax_moe.MoEConfig(2, 8, cfg.d_ff, cfg.capacity_factor))
        _close(out, want, "expert-parallel moe_ffn")
    with pytest.raises(ValueError, match="slots' lists"):
        moe_ffn({k: torch.as_tensor(v) for k, v in params.items()}, torch.zeros((4, 8)), cfg,
                axis_name="expert")


def test_resolve_attn_picks_flash_only_on_the_card_when_the_sequence_tiles():
    assert common.resolve_attn("auto", 1024, on_card=True, block=128) == "flash"
    assert common.resolve_attn("auto", 1023, on_card=True, block=128) == "blockwise"
    assert common.resolve_attn("auto", 1024, on_card=False, block=128) == "blockwise"
    assert common.resolve_attn("flash", 64, on_card=False) == "flash"
    for seq, block in [(64, 128), (256, 128), (96, 64), (1023, 128)]:
        assert common.flash_ok(seq, block) == jax_common.flash_ok(seq, block)


def test_data_is_the_references_byte_for_byte(tmp_path):
    np.testing.assert_array_equal(tf.make_lm_data(9, 33, 50, seed=4),
                                  jax_tf.make_lm_data(9, 33, 50, seed=4))
    path = tmp_path / "corpus.txt"
    path.write_bytes(bytes(range(256)) * 3)
    for kw in (dict(seq_len=17), dict(seq_len=16, num_seqs=5, vocab_size=100)):
        np.testing.assert_array_equal(tf.load_text_tokens(str(path), **kw),
                                      jax_tf.load_text_tokens(str(path), **kw))
    with pytest.raises(ValueError):
        tf.load_text_tokens(str(path), seq_len=1)


def _build(argv):
    return cli.build_config("lm", argparse.Namespace(job_id=None, epochs=1, batches=2, **argv))


def test_cli_couples_vocab_size_and_switches_to_a_text_file():
    cfg = _build(dict(set=["vocab_size=256"], data=[]))
    assert cfg.params.app_params["vocab_size"] == cfg.user["data_args"]["vocab_size"] == 256
    cfg = _build(dict(set=[], data=["vocab_size=100"]))
    assert cfg.params.app_params["vocab_size"] == 100
    with pytest.raises(SystemExit, match="conflicting vocab_size"):
        _build(dict(set=["vocab_size=256"], data=["vocab_size=100"]))
    cfg = _build(dict(set=["dtype=bfloat16"], data=["path=/x.txt"]))
    assert cfg.user["data_fn"].endswith(":load_text_tokens")
    assert cfg.params.app_params["dtype"] == "bfloat16"
    with pytest.raises(SystemExit, match="do not apply to file corpora"):
        _build(dict(set=[], data=["path=/x.txt", "seed=3"]))


def test_cli_run_lm_on_the_cpu_gives_finite_falling_losses(capsys):
    assert cli.main(["run", "lm", "--device", "cpu", "--epochs", "2", "--batches", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (worker,) = out["result"]["workers"].values()
    assert len(worker["batch_losses"]) == 4 and all(np.isfinite(worker["batch_losses"]))
    assert worker["losses"][1] < worker["losses"][0]
