"""The port's pipeline parallelism against harmony_tpu's, on the CPU.

parallel/pipeline.py's make_pipeline_fn and models/transformer.py's
make_pp_train_step, on virtual CPU slots (``DevicePool.virtual("cpu", n)``),
against the JAX package's on its virtual CPU devices: the same numpy weights
and inputs go to both. The JAX functions are computed once a module and case
(each is a shard_map compile of a second or two).

Tolerances (the reference's own, tests/test_pipeline.py's): a toy pipeline's
values within 1e-5 and its gradients within 1e-4 absolute (f32, values of
order 1); the LM step's loss within 1e-5 relative, its new parameters within
rtol 2e-4 and atol 2e-5. The port's schedule (which stage runs which
microbatch at which tick, and how often) is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from harmony_tpu.models import transformer as jax_tf
from harmony_tpu.parallel import pipeline as jax_pipeline
from harmony_tpu_torch.convert import pytree_params_from_numpy
from harmony_tpu_torch.models import transformer as tf
from harmony_tpu_torch.models.pytree_trainer import tree_leaves, tree_unflatten
from harmony_tpu_torch.parallel import pipeline
from harmony_tpu_torch.parallel.mesh import DevicePool, Mesh

LM = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4, d_ff=64, max_seq=32)
PIPE_CASES = [(2, 2), (4, 4), (4, 8)]
D, B = 16, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stage_mesh(S):
    return Mesh(np.asarray(DevicePool.virtual("cpu", S).slots, dtype=object).reshape(S),
                ("stage",))


def _jax_stage_mesh(S):
    return JaxMesh(np.asarray(jax.devices()[:S], dtype=object).reshape(S), ("stage",))


def _toy_params(S, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(scale=D ** -0.5, size=(S, D, D)).astype(np.float32),
            "b": rng.normal(scale=0.1, size=(S, D)).astype(np.float32)}


def _toy_input(seed=1):
    return np.random.default_rng(seed).normal(size=(B, D)).astype(np.float32)


def _port_stages(stacked, requires_grad=False):
    """The reference's stage-stacked tree as the port's list of stage trees."""
    S = stacked["w"].shape[0]
    return [{k: torch.tensor(v[s]).requires_grad_(requires_grad) for k, v in stacked.items()}
            for s in range(S)]


def _jax_stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


@pytest.fixture(scope="module")
def jax_pipe():
    """The reference pipeline's output and its gradients (of the output's sum,
    by the stage parameters and the input), once per (S, M)."""
    cache = {}

    def get(S, M):
        if (S, M) not in cache:
            params = jax.tree.map(jnp.asarray, _toy_params(S))
            x = jnp.asarray(_toy_input())
            pipe = jax_pipeline.make_pipeline_fn(_jax_stage_fn, _jax_stage_mesh(S),
                                                 num_microbatches=M)
            out = pipe(params, x)
            gp, gx = jax.grad(lambda p, x: pipe(p, x).sum(), argnums=(0, 1))(params, x)
            cache[S, M] = (np.asarray(out), jax.tree.map(np.asarray, gp), np.asarray(gx))
        return cache[S, M]

    return get


@pytest.mark.parametrize("S,M", PIPE_CASES)
def test_pipeline_fn_matches_the_references(jax_pipe, S, M):
    want, want_gp, want_gx = jax_pipe(S, M)
    stages = _port_stages(_toy_params(S), requires_grad=True)
    x = torch.tensor(_toy_input()).requires_grad_(True)
    pipe = pipeline.make_pipeline_fn(_stage_fn, _stage_mesh(S), num_microbatches=M)
    out = pipe(stages, x)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5)
    leaves = [p for stage in stages for p in (stage["b"], stage["w"])]
    grads = torch.autograd.grad(out.sum(), leaves + [x])
    for s in range(S):
        np.testing.assert_allclose(grads[2 * s].numpy(), want_gp["b"][s], atol=1e-4)
        np.testing.assert_allclose(grads[2 * s + 1].numpy(), want_gp["w"][s], atol=1e-4)
    np.testing.assert_allclose(grads[-1].numpy(), want_gx, atol=1e-4)


@pytest.mark.parametrize("S,M", PIPE_CASES)
def test_the_schedule_skips_the_bubbles_and_rematerialises_each_tick(S, M):
    """Tick by tick, the stages with a microbatch (stage s on t - s) and no
    bubble: S * M applications in the forward (the reference computes S * (M +
    S - 1), the bubbles masked), each applied once more in the backward."""
    calls = []

    def stage_fn(params, x):
        calls.append((int(params["id"]), int(x[0, 0])))
        return x @ params["w"]

    stages = [{"id": torch.tensor(s), "w": torch.ones(1, 1, requires_grad=True)}
              for s in range(S)]
    x = torch.arange(M, dtype=torch.float32).reshape(M, 1)
    out = pipeline.make_pipeline_fn(stage_fn, _stage_mesh(S), num_microbatches=M)(stages, x)
    ticks = [(s, t - s) for t in range(M + S - 1) for s in range(S) if 0 <= t - s < M]
    assert calls == ticks
    torch.autograd.grad(out.sum(), [st["w"] for st in stages])
    assert len(calls) == 2 * S * M
    assert sorted(calls[S * M:]) == sorted(ticks)


def test_pipeline_fn_refuses_what_the_reference_refuses():
    x = _toy_input()[:6]
    with pytest.raises(ValueError) as want:
        jax_pipeline.make_pipeline_fn(_jax_stage_fn, _jax_stage_mesh(2), num_microbatches=4)(
            jax.tree.map(jnp.asarray, _toy_params(2)), jnp.asarray(x))
    with pytest.raises(ValueError) as got:
        pipeline.make_pipeline_fn(_stage_fn, _stage_mesh(2), num_microbatches=4)(
            _port_stages(_toy_params(2)), torch.tensor(x))
    assert str(got.value) == str(want.value) == "batch 6 not divisible into 4 microbatches"
    assert pipeline.STAGE_AXIS == jax_pipeline.STAGE_AXIS


def _tokens(seed, B=8, S=17):
    return tf.make_lm_data(B, S, LM["vocab_size"], seed=seed)


@pytest.fixture(scope="module")
def jax_pp():
    """Two steps of the reference's make_pp_train_step, once per S."""
    cache = {}

    def get(S):
        if S not in cache:
            model = jax_tf.TransformerLM(jax_tf.TransformerConfig(**LM))
            params = model.init_numpy(seed=S)
            step, shard = jax_tf.make_pp_train_step(model, _jax_stage_mesh(S), 0.1,
                                                    donate=False)
            pp, losses = shard(jax.tree.map(jnp.asarray, params)), []
            for i in range(2):
                pp, loss = step(pp, jnp.asarray(_tokens(10 + i)))
                losses.append(float(loss))
            cache[S] = params, jax.tree.map(np.asarray, pp), losses
        return cache[S]

    return get


@pytest.mark.parametrize("S", [2, 4])
def test_pp_step_matches_the_references(jax_pp, S):
    params, want, want_losses = jax_pp(S)
    model = tf.TransformerLM(tf.TransformerConfig(**LM))
    mesh = _stage_mesh(S)
    step, shard = tf.make_pp_train_step(model, mesh, 0.1, donate=False)
    pp = shard(pytree_params_from_numpy(params, device="cpu"))
    for i in range(2):
        pp, loss = step(pp, torch.as_tensor(_tokens(10 + i)))
        assert loss.shape == () and loss.device == mesh.slots[0].device
        np.testing.assert_allclose(float(loss), want_losses[i], rtol=1e-5)
    lps = LM["n_layers"] // S
    assert len(pp["stages"]) == S and all(len(st) == lps for st in pp["stages"])
    for s, stage in enumerate(pp["stages"]):
        for j, layer in enumerate(stage):
            for key, value in layer.items():
                np.testing.assert_allclose(value.numpy(), want["stages"][key][s, j],
                                           rtol=2e-4, atol=2e-5)
    for key in ("embed", "pos", "ln_f"):
        np.testing.assert_allclose(pp[key].numpy(), want[key], rtol=2e-4, atol=2e-5)


def test_pp_layout_puts_each_stage_on_its_slot():
    """Stage s's layers on the slot at stage index s, the rest on the home
    slot (a mesh of a CPU slot and a meta slot tells the devices apart); the
    values copied (on two CPU slots)."""
    from harmony_tpu_torch.parallel.mesh import Slot

    model = tf.TransformerLM(tf.TransformerConfig(**LM))
    params = pytree_params_from_numpy(model.init(seed=3), device="cpu")
    devices = [torch.device("cpu"), torch.device("meta")]
    mesh = Mesh(np.asarray([Slot(i, d) for i, d in enumerate(devices)], dtype=object)
                .reshape(2), ("stage",))
    pp = tf.make_pp_train_step(model, mesh)[1](params)
    assert [[{t.device for t in tree_leaves(layer)} for layer in st] for st in pp["stages"]] == [
        [{devices[0]}] * 2, [{devices[1]}] * 2]
    assert {pp[k].device for k in ("embed", "pos", "ln_f")} == {devices[0]}
    pp = tf.make_pp_train_step(model, _stage_mesh(2))[1](params)
    flat = [layer for st in pp["stages"] for layer in st]
    for a, b in zip(tree_leaves(flat), tree_leaves(params["layers"])):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_pp_step_refuses_what_the_reference_refuses():
    def errors(cfg, S):
        with pytest.raises(ValueError) as want:
            jax_tf.make_pp_train_step(jax_tf.TransformerLM(jax_tf.TransformerConfig(**cfg)),
                                      _jax_stage_mesh(S))
        with pytest.raises(ValueError) as got:
            tf.make_pp_train_step(tf.TransformerLM(tf.TransformerConfig(**cfg)), _stage_mesh(S))
        return str(got.value), str(want.value)

    got, want = errors(dict(LM, moe_experts=4), 2)
    assert got == want and "MoE configs" in got
    got, want = errors(dict(LM, n_layers=3), 2)
    assert got == want == "n_layers 3 not divisible into 2 pipeline stages"


def test_pp_step_donates_and_is_deterministic():
    """donate=True updates the tree in place to the bits donate=False returns;
    two runs give the same bits; a run at M = 4 agrees with M = 2 to f32
    reordering, and the loss falls."""
    model = tf.TransformerLM(tf.TransformerConfig(**LM))
    params = model.init(seed=5)
    tokens = torch.as_tensor(_tokens(6))

    def run(donate, M=None, steps=3):
        step, shard = tf.make_pp_train_step(model, _stage_mesh(2), 0.3, num_microbatches=M,
                                            donate=donate)
        pp = shard(pytree_params_from_numpy(params, device="cpu"))
        objects = [id(p) for p in tree_leaves(pp)]
        losses = []
        for _ in range(steps):
            new, loss = step(pp, tokens)
            assert ([id(p) for p in tree_leaves(new)] == objects) == donate
            pp = new
            losses.append(loss)
        return torch.stack(losses), [p.clone() for p in tree_leaves(pp)]

    kept, donated, again = run(False), run(True), run(False)
    for a, b in ((kept, donated), (kept, again)):
        assert torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    four, _ = run(False, M=4)
    np.testing.assert_allclose(four.numpy(), kept[0].numpy(), rtol=1e-5)
    assert kept[0][-1] < kept[0][0]


def test_pp_step_is_the_single_device_step():
    """On one stage the pipeline is the one-device LM: ``model.loss`` and SGD."""
    model = tf.TransformerLM(tf.TransformerConfig(**LM))
    params = pytree_params_from_numpy(model.init(seed=7), device="cpu")
    tokens = torch.as_tensor(_tokens(8))
    step, shard = tf.make_pp_train_step(model, _stage_mesh(1), 0.1, donate=False)
    new, loss = step(shard(params), tokens)
    leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(params)]
    want = model.loss(tree_unflatten(params, leaves), tokens)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(want, leaves)))
    ref = tree_unflatten(params, [p - 0.1 * grads[id(p)] for p in leaves])
    assert float(loss) == pytest.approx(float(want.detach()), rel=1e-6)
    got = [new["embed"], new["ln_f"], new["pos"]] + list(tree_leaves(new["stages"][0]))
    exp = [ref["embed"], ref["ln_f"], ref["pos"]] + list(tree_leaves(ref["layers"]))
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=1e-6)
