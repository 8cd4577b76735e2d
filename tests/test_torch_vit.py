"""The port's Vision Transformer against harmony_tpu's, on the CPU.

harmony_tpu_torch.models.vit against harmony_tpu.models.vit: the same weights
(the JAX package's ``init``, drawn from jax.random and carried across with
``harmony_tpu_torch.convert``) and the same numpy images go to both. On the
CPU the JAX package runs its flash kernels in interpret mode and the port its
plain versions.

Tolerances: patches, synthetic data, flat order and carried rows are copies
(exact). Logits, losses and accuracies are f32 in both packages and differ in
the order of their sums only: 1e-5 absolute (logits and losses of order 1);
gradients and parameters after SGD steps 1e-5 relative to the largest
magnitude in the tensor; the worker loop's per-epoch losses, eight Adam
steps on, 1e-4 relative.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from harmony_tpu.config.params import TrainerParams as JaxTrainerParams
from harmony_tpu.dolphin import TrainerContext as JaxTrainerContext
from harmony_tpu.dolphin import TrainingDataProvider as JaxData
from harmony_tpu.dolphin import WorkerTasklet as JaxWorker
from harmony_tpu.models import common as jax_common
from harmony_tpu.models import vit as jax_vit
from harmony_tpu.parallel import build_mesh
from harmony_tpu.table import DenseTable as JaxDenseTable
from harmony_tpu.table import TableSpec as JaxTableSpec
from harmony_tpu_torch import cli
from harmony_tpu_torch.config.params import TrainerParams
from harmony_tpu_torch.convert import pytree_params_from_numpy, pytree_rows_from_numpy
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.trainer import TrainerContext
from harmony_tpu_torch.dolphin.worker import WorkerTasklet
from harmony_tpu_torch.models import common, vit
from harmony_tpu_torch.models.pytree_trainer import ravel_numpy, tree_leaves, unravel
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.parallel.mesh import build_mesh as port_build_mesh
from harmony_tpu_torch.table.table import DenseTable, TableSpec

SMALL = dict(image_size=16, patch_size=4, channels=3, num_classes=4, d_model=32, n_heads=2,
             n_layers=2, d_ff=64)
ATOL = 1e-5
REL = 1e-5


def _close_rel(got, want, what, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    gap, tol = np.abs(got - want).max(), rel * max(np.abs(want).max(), 1e-30)
    assert gap <= tol, (what, gap, tol)


def _jax_params(seed, **over):
    cfg = jax_vit.ViTConfig(**{**SMALL, **over})
    return jax.tree.map(np.asarray, jax_vit.ViT(cfg).init(jax.random.PRNGKey(seed)))


def test_patchify_is_exact():
    images, _ = vit.make_synthetic(3, **{k: SMALL[k] for k in
                                         ("image_size", "patch_size", "channels")})
    want = jax_vit.ViT(jax_vit.ViTConfig(**SMALL))._patchify(jnp.asarray(images))
    got = vit.ViT(vit.ViTConfig(**SMALL))._patchify(torch.as_tensor(images))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_layout_and_param_shapes_match_the_references():
    model = vit.ViT(vit.ViTConfig(**SMALL))
    got = model.init(seed=3)
    want = _jax_params(3)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert list(map(np.shape, tree_leaves(got))) == list(tree_leaves(model.param_shapes()))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    # ones, zeros and the scaling of each normal draw as the reference's
    np.testing.assert_array_equal(got["cls"], 0.0)
    np.testing.assert_array_equal(got["layers"][1]["ln2"], 1.0)
    assert abs(got["pos"].std() - 0.02) < 0.002
    assert abs(got["layers"][0]["w1"].std() - SMALL["d_model"] ** -0.5) < 0.01


@pytest.mark.parametrize("attn", ["flash", "blockwise"])
def test_logits_loss_accuracy_and_gradients_match_jax(attn):
    params = _jax_params(1)
    x, y = vit.make_synthetic(6, seed=2, **{k: SMALL[k] for k in
                                            ("image_size", "patch_size", "channels",
                                             "num_classes")})
    jmodel = jax_vit.ViT(jax_vit.ViTConfig(**SMALL, attn=attn))
    tmodel = vit.ViT(vit.ViTConfig(**SMALL, attn=attn))
    jp = jax.tree.map(jnp.asarray, params)
    tp = pytree_params_from_numpy(params, device="cpu")
    xi, yi = torch.as_tensor(x), torch.as_tensor(y)
    with torch.no_grad():
        logits = tmodel.apply(tp, xi)
        assert logits.dtype == torch.float32 and logits.shape == (6, SMALL["num_classes"])
        assert np.abs(logits.numpy() - np.asarray(jmodel.apply(jp, jnp.asarray(x)))).max() <= ATOL
        assert abs(float(tmodel.loss(tp, xi, yi))
                   - float(jmodel.loss(jp, jnp.asarray(x), jnp.asarray(y)))) <= ATOL
        assert float(tmodel.accuracy(tp, xi, yi)) == float(
            jmodel.accuracy(jp, jnp.asarray(x), jnp.asarray(y)))
    want = jax.grad(jmodel.loss)(jp, jnp.asarray(x), jnp.asarray(y))
    flat = torch.as_tensor(ravel_numpy(params)).requires_grad_(True)
    (grad,) = torch.autograd.grad(
        tmodel.loss(unravel(flat, tmodel.param_shapes()), xi, yi), flat)
    _close_rel(grad, ravel_pytree(want)[0], f"gradients ({attn})")


def test_make_train_step_over_three_steps():
    params = _jax_params(4)
    x, y = jax_vit.make_synthetic(16, jax_vit.ViTConfig(**SMALL), seed=5)
    jstep = jax_vit.make_train_step(jax_vit.ViT(jax_vit.ViTConfig(**SMALL)),
                                    learning_rate=0.2, donate=False)
    tstep = vit.make_train_step(vit.ViT(vit.ViTConfig(**SMALL)), learning_rate=0.2,
                                donate=False)
    jp, tp = jax.tree.map(jnp.asarray, params), pytree_params_from_numpy(params, device="cpu")
    before = [t.clone() for t in tree_leaves(tp)]
    for step in range(3):
        jp, jloss = jstep(jp, jnp.asarray(x), jnp.asarray(y))
        tp2, tloss = tstep(tp, torch.as_tensor(x), torch.as_tensor(y))
        if step == 0:  # the old tree is left as it was
            assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tp)))
        tp = tp2
        assert abs(float(tloss) - float(jloss)) <= ATOL, step
    _close_rel(torch.cat([t.reshape(-1) for t in tree_leaves(tp)]),
               ravel_pytree(jp)[0], "params after 3 steps")


def test_data_parallel_step_matches_the_references():
    """make_train_step(model, mesh) on 4 data slots against the reference's on
    4 devices, 3 steps, at tests/test_vit.py's limits for its sharded step
    (losses rtol 2e-4, parameters rtol 2e-3 and atol 2e-5); and against the
    port's one-slot step, to f32 reordering."""
    params = _jax_params(8)
    x, y = jax_vit.make_synthetic(16, jax_vit.ViTConfig(**SMALL), seed=9)
    jmesh = build_mesh(jax.devices()[:4], data=4, model=1)
    jstep = jax_vit.make_train_step(jax_vit.ViT(jax_vit.ViTConfig(**SMALL)), jmesh,
                                    learning_rate=0.2, donate=False)
    model = vit.ViT(vit.ViTConfig(**SMALL))
    mesh = port_build_mesh(DevicePool.virtual("cpu", 4).slots, data=4, model=1)
    tstep = vit.make_train_step(model, mesh, learning_rate=0.2, donate=False)
    one = vit.make_train_step(model, learning_rate=0.2, donate=False)
    jp = jax.tree.map(jnp.asarray, params)
    tp = op = pytree_params_from_numpy(params, device="cpu")
    for step in range(3):
        jp, jloss = jstep(jp, jnp.asarray(x), jnp.asarray(y))
        tp, tloss = tstep(tp, torch.as_tensor(x), torch.as_tensor(y))
        op, oloss = one(op, torch.as_tensor(x), torch.as_tensor(y))
        assert tloss.device == mesh.slots[0].device
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-4)
        np.testing.assert_allclose(float(tloss), float(oloss), rtol=1e-6)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3, atol=2e-5)
    for a, b in zip(tree_leaves(tp), tree_leaves(op)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("data", [1, 4])
def test_data_parallel_step_donates_and_is_deterministic(data):
    """donate=True updates the tree in place to donate=False's bits, and two
    runs give the same bits; a batch that does not split is refused."""
    model = vit.ViT(vit.ViTConfig(**SMALL))
    params = model.init(seed=10)
    x, y = vit.make_synthetic(8, model.cfg, seed=11)
    mesh = port_build_mesh(DevicePool.virtual("cpu", data).slots, data=data, model=1)

    def run(donate):
        step = vit.make_train_step(model, mesh, learning_rate=0.2, donate=donate)
        tp = pytree_params_from_numpy(params, device="cpu")
        objects = [id(t) for t in tree_leaves(tp)]
        new, loss = step(tp, torch.as_tensor(x), torch.as_tensor(y))
        assert ([id(t) for t in tree_leaves(new)] == objects) == donate
        return loss, list(tree_leaves(new))

    kept, donated, again = run(False), run(True), run(False)
    for a, b in ((kept, donated), (kept, again)):
        assert torch.equal(a[0], b[0]) and all(torch.equal(p, q) for p, q in zip(a[1], b[1]))
    if data > 1:
        with pytest.raises(ValueError, match="batch 6 does not split over 4 data slots"):
            vit.make_train_step(model, mesh)(pytree_params_from_numpy(params, device="cpu"),
                                              torch.as_tensor(x[:6]), torch.as_tensor(y[:6]))


def test_vit_trainer_through_the_worker_loop_matches_the_references():
    """Two epochs of 4 batches of Adam through each package's WorkerTasklet,
    both tables holding the JAX package's initial rows (its init draws from
    jax.random): the per-epoch losses, then evaluate's loss and accuracy."""
    kw = dict(SMALL, row_width=256, step_size=0.01, optimizer="adam")
    jt, tt = jax_vit.ViTTrainer(**kw), vit.ViTTrainer(**kw)
    assert (jt.capacity, jt.num_rows) == (tt.capacity, tt.num_rows)
    rows = pytree_rows_from_numpy(_jax_params(6), 256)
    x, y = vit.make_synthetic(64, tt.config, seed=7)
    mesh = build_mesh(jax.devices()[:1])
    jm = JaxDenseTable(JaxTableSpec(jt.model_table_config()), mesh)
    jm.multi_put(np.arange(jt.num_rows), rows)
    jw = JaxWorker("vit", JaxTrainerContext(
        params=JaxTrainerParams(num_epochs=2, num_mini_batches=4), model_table=jm), jt,
        JaxData([x, y], 4), mesh, global_init=False)
    jres = jw.run()
    tm = DenseTable(TableSpec(tt.model_table_config()), "cpu")
    tm.multi_put(np.arange(tt.num_rows), rows)
    tw = WorkerTasklet("vit", TrainerContext(
        params=TrainerParams(num_epochs=2, num_mini_batches=4), model_table=tm), tt,
        TrainingDataProvider([x, y], 4), global_init=False)
    tres = tw.run()
    assert len(tres["batch_losses"]) == 8
    np.testing.assert_allclose(tres["losses"], jres["losses"], rtol=1e-4)
    jev, tev = jw.evaluate((x, y)), tw.evaluate((x, y))
    np.testing.assert_allclose(tev["loss"], float(jev["loss"]), rtol=1e-4)
    assert tev["accuracy"] == pytest.approx(float(jev["accuracy"]))


def test_make_synthetic_is_byte_identical():
    for kw in (dict(image_size=16, patch_size=4, num_classes=4), dict(image_size=8,
                                                                     patch_size=2,
                                                                     num_classes=3,
                                                                     channels=1)):
        got = vit.make_synthetic(20, seed=3, **kw)
        want = jax_vit.make_synthetic(20, seed=3, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError, match="unknown"):
        vit.make_synthetic(4, image_sise=16)
    with pytest.raises(TypeError, match="either"):
        vit.make_synthetic(4, vit.ViTConfig(), image_size=16)


def test_config_validation_and_attention_resolution():
    with pytest.raises(ValueError, match="patch_size"):
        vit.ViTConfig(image_size=30, patch_size=4)
    with pytest.raises(ValueError, match="n_heads"):
        vit.ViTConfig(d_model=65, n_heads=4)
    with pytest.raises(ValueError, match="unknown attn"):
        vit.ViTConfig(attn="flsh")
    with pytest.raises(ValueError, match="unknown dtype"):
        vit.ViTConfig(dtype="float16")
    assert vit.ViTConfig(dtype="bfloat16").dtype == torch.bfloat16
    # 65 tokens (32/4), ViT-B/16's 197 (224/16), and 257 (256/16): the default
    # block of 256 takes the first two whole, and the third does not tile
    for image, patch, seq in ((32, 4, 65), (224, 16, 197), (256, 16, 257)):
        cfg = vit.ViTConfig(image_size=image, patch_size=patch)
        assert cfg.seq == jax_vit.ViTConfig(image_size=image, patch_size=patch).seq == seq
        ok = jax_common.flash_ok(seq)
        assert common.flash_ok(seq) == ok == (seq != 257)
        assert common.resolve_attn("auto", seq, on_card=True) == ("flash" if ok else "blockwise")
        assert common.resolve_attn("auto", seq, on_card=False) == "blockwise"
        assert jax_common.resolve_attn("blockwise", seq) == "blockwise"
    # the LM's 128-blocks would not tile ViT-B/16's 197 tokens
    assert not common.flash_ok(197, block=128)


def _build(argv):
    return cli.build_config("vit", argparse.Namespace(job_id=None, epochs=1, batches=2, **argv))


def test_cli_couples_the_image_keys():
    cfg = _build(dict(set=["image_size=32", "num_classes=10"], data=[]))
    for key, value in (("image_size", 32), ("num_classes", 10), ("patch_size", 4)):
        assert cfg.params.app_params[key] == cfg.user["data_args"][key] == value
    cfg = _build(dict(set=[], data=["channels=1"]))
    assert cfg.params.app_params["channels"] == 1
    with pytest.raises(SystemExit, match="conflicting patch_size"):
        _build(dict(set=["patch_size=8"], data=["patch_size=2"]))


def test_cli_run_vit_on_the_cpu_gives_finite_falling_losses(capsys):
    assert cli.main(["run", "vit", "--device", "cpu", "--epochs", "2", "--batches", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (worker,) = out["result"]["workers"].values()
    assert len(worker["batch_losses"]) == 4 and all(np.isfinite(worker["batch_losses"]))
    assert worker["losses"][1] < worker["losses"][0]
