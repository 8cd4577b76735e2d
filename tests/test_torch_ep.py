"""The port's expert parallelism against harmony_tpu's, on the CPU.

models/moe.py's ``moe_ffn`` over slots (each slot's tokens and params as
lists) against the reference's ``moe_ffn(axis_name=...)`` under shard_map,
and models/transformer.py's make_ep_train_step against the reference's, on
virtual CPU slots (``DevicePool.virtual("cpu", 4)``) and the JAX package's
virtual CPU devices: the same numpy weights and inputs go to both. The JAX
functions are computed once a module and case.

Tolerances: the bucket exchange moves values, so its layout is exact. Expert
outputs within 1e-5 absolute (values of order 1, f32 sums in another order)
and the aux loss within 1e-6 (the reference's test_moe.py limits); with a
capacity factor of 1.0 tokens are dropped, and the kept set is exact (the
router products of these seeded inputs never put two probabilities of a token
within a few ulps). The LM step's loss within 1e-5 absolute and its new
parameters within 2e-4 (tests/test_torch_sp.py's limits for the mesh steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from harmony_tpu.models import moe as jax_moe
from harmony_tpu.models import transformer as jax_tf
from harmony_tpu.parallel import build_mesh as jax_build_mesh
from harmony_tpu_torch.convert import pytree_params_from_numpy
from harmony_tpu_torch.models import moe
from harmony_tpu_torch.models import transformer as tf
from harmony_tpu_torch.models.pytree_trainer import tree_leaves
from harmony_tpu_torch.parallel.mesh import DevicePool, build_mesh

SLOTS = 4
CAPACITY = {"drops": 1.0, "no drops": 8.0}
LM = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4, d_ff=64, max_seq=32,
          moe_experts=8, moe_every=2)
LOSS_ATOL = 1e-5
PARAM_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _slots():
    return DevicePool.virtual("cpu", SLOTS).slots


def _jax_expert_mesh():
    return JaxMesh(np.asarray(jax.devices()[:SLOTS], dtype=object).reshape(SLOTS), ("expert",))


def _moe_inputs(cap, E=8, d=8, f=16, T=64, seed=0):
    cfg = moe.MoEConfig(num_experts=E, d_model=d, d_ff=f, capacity_factor=cap)
    rng = np.random.default_rng(seed)
    params = moe.init_moe_params(rng, cfg)
    return cfg, params, rng.standard_normal((T, d)).astype(np.float32)


def _slot_params(params, S=SLOTS):
    """Each slot's router replica and w1/w2 expert shard."""
    return [{"router": torch.tensor(params["router"]),
             "w1": torch.tensor(np.split(params["w1"], S)[i]),
             "w2": torch.tensor(np.split(params["w2"], S)[i])} for i in range(S)]


@pytest.fixture(scope="module")
def jax_ep_moe():
    """The reference's moe_ffn(axis_name) under shard_map over 4 devices: the
    tokens' outputs and each shard's aux, once per capacity."""
    cache = {}

    def get(case):
        if case not in cache:
            cfg, params, x = _moe_inputs(CAPACITY[case])
            jcfg = jax_moe.MoEConfig(cfg.num_experts, cfg.d_model, cfg.d_ff, cfg.capacity_factor)

            def local(p, xs):
                out, aux = jax_moe.moe_ffn(p, xs, jcfg, axis_name="expert")
                return out, aux[None]

            out, aux = jax.shard_map(
                local, mesh=_jax_expert_mesh(),
                in_specs=({"router": P(), "w1": P("expert"), "w2": P("expert")}, P("expert")),
                out_specs=(P("expert"), P("expert")),
            )(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
            cache[case] = np.asarray(out), np.asarray(aux)
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(CAPACITY))
def test_moe_ffn_over_slots_matches_the_references(jax_ep_moe, case):
    want_out, want_aux = jax_ep_moe(case)
    cfg, params, x = _moe_inputs(CAPACITY[case])
    xs = list(torch.tensor(x).chunk(SLOTS))
    outs, aux = moe.moe_ffn(_slot_params(params), xs, cfg)
    assert len(outs) == len(aux) == SLOTS
    np.testing.assert_allclose(torch.cat(outs).numpy(), want_out, atol=1e-5)
    np.testing.assert_allclose(torch.stack(aux).numpy(), want_aux, atol=1e-6)
    dropped = (np.abs(want_out).sum(axis=1) == 0).sum()
    assert (dropped > 0) == (case == "drops")
    # each slot's result is the one-device FFN on its own tokens (per-slot capacity)
    for i, xi in enumerate(xs):
        full = {k: torch.tensor(v) for k, v in params.items()}
        one, one_aux = moe.moe_ffn(full, xi, cfg)
        np.testing.assert_allclose(outs[i].numpy(), one.numpy(), atol=1e-6)
        assert float(aux[i]) == pytest.approx(float(one_aux), abs=1e-7)


def test_the_exchange_is_the_references_all_to_all():
    """Buckets whose every row names its (source slot, expert, bucket slot):
    each slot's expert rows and the way back, exactly the reference's
    all_to_all layout (source-major within each expert)."""
    E, C, d = 8, 3, 2
    src, e, c = np.meshgrid(np.arange(SLOTS), np.arange(E), np.arange(C), indexing="ij")
    tags = np.repeat((src * 1000 + e * 10 + c)[..., None], d, axis=-1).astype(np.float32)

    def local(xe):
        xe = xe.reshape(SLOTS, E // SLOTS, C, d)
        xe = lax.all_to_all(xe, "expert", split_axis=0, concat_axis=0, tiled=False)
        return xe.transpose(1, 0, 2, 3).reshape(E // SLOTS, SLOTS * C, d)

    want = np.asarray(jax.shard_map(local, mesh=_jax_expert_mesh(), in_specs=P("expert"),
                                    out_specs=P("expert"))(jnp.asarray(tags.reshape(-1, C, d))))
    devices = [s.device for s in _slots()]
    rows = moe.to_experts([torch.tensor(t) for t in tags], devices)
    assert [tuple(r.shape) for r in rows] == [(E // SLOTS, SLOTS * C, d)] * SLOTS
    np.testing.assert_array_equal(torch.cat(rows).numpy(), want)
    back = moe.from_experts(rows, devices)
    np.testing.assert_array_equal(torch.stack(back).numpy(), tags)


def test_moe_ffn_on_one_tensor_with_an_axis_name_names_the_slots_lists():
    cfg, params, x = _moe_inputs(1.0)
    with pytest.raises(ValueError, match="the expert axis is given as the slots' lists"):
        moe.moe_ffn({k: torch.tensor(v) for k, v in params.items()}, torch.tensor(x), cfg,
                    axis_name="expert")
    with pytest.raises(ValueError, match="must divide by the 3 slots"):
        moe.moe_ffn(_slot_params(params, 2)[:1] * 3, list(torch.tensor(x).chunk(3)), cfg)


def _tokens(seed, B=8, S=16):
    return tf.make_lm_data(B, S, LM["vocab_size"], seed=seed)


@pytest.fixture(scope="module")
def jax_ep_step():
    """Two steps of the reference's make_ep_train_step on data 4, per case."""
    cache = {}

    def get(case):
        if case not in cache:
            model = jax_tf.TransformerLM(jax_tf.TransformerConfig(
                **LM, moe_capacity_factor=CAPACITY[case]))
            params = model.init_numpy(seed=1)
            mesh = jax_build_mesh(jax.devices()[:SLOTS], data=SLOTS, model=1)
            step, shard = jax_tf.make_ep_train_step(model, mesh, 0.1, donate=False)
            p, losses = shard(jax.tree.map(jnp.asarray, params)), []
            for i in range(2):
                p, loss = step(p, jnp.asarray(_tokens(20 + i)))
                losses.append(float(loss))
            cache[case] = params, jax.tree.map(np.asarray, p), losses
        return cache[case]

    return get


def _whole(leaf):
    return torch.cat(leaf.shards, dim=leaf.dim) if isinstance(leaf, tf.ModelShards) else leaf


@pytest.mark.parametrize("case", sorted(CAPACITY))
def test_ep_step_matches_the_references(jax_ep_step, case):
    params, want, want_losses = jax_ep_step(case)
    model = tf.TransformerLM(tf.TransformerConfig(**LM, moe_capacity_factor=CAPACITY[case]))
    mesh = build_mesh(_slots(), data=SLOTS, model=1)
    step, shard = tf.make_ep_train_step(model, mesh, 0.1, donate=False)
    p = shard(pytree_params_from_numpy(params, device="cpu"))
    for i in range(2):
        p, loss = step(p, torch.as_tensor(_tokens(20 + i)))
        assert loss.shape == () and loss.device == mesh.slots[0].device
        assert abs(float(loss) - want_losses[i]) <= LOSS_ATOL
    got, exp = list(tree_leaves(p)), list(tree_leaves(want))
    assert len(got) == len(exp)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(_whole(a).numpy(), b, atol=PARAM_ATOL)


def test_ep_layout_splits_the_experts_over_the_data_slots():
    from harmony_tpu_torch.parallel.mesh import Slot

    model = tf.TransformerLM(tf.TransformerConfig(**LM))
    params = model.init(seed=2)
    devices = [torch.device("cpu"), torch.device("meta")]
    mesh = build_mesh([Slot(i, d) for i, d in enumerate(devices)], data=2, model=1)
    placed = tf.make_ep_train_step(model, mesh)[1](pytree_params_from_numpy(params, "cpu"))
    w1 = placed["layers"][1]["moe"]["w1"]
    assert isinstance(w1, tf.ModelShards) and w1.dim == 0
    assert [tuple(s.shape) for s in w1.shards] == [(4, 32, 64)] * 2
    assert [s.device for s in w1.shards] == devices
    assert {x.device for x in tree_leaves(placed) if not isinstance(x, tf.ModelShards)} == {
        devices[0]}
    placed = tf.make_ep_train_step(model, build_mesh(_slots()[:2], data=2, model=1))[1](
        pytree_params_from_numpy(params, "cpu"))
    for a, b in zip(tree_leaves(placed), tree_leaves(params)):
        np.testing.assert_array_equal(_whole(a).numpy(), b)


def test_ep_step_refuses_what_the_reference_refuses():
    def errors(cfg):
        with pytest.raises(ValueError) as want:
            jax_tf.make_ep_train_step(jax_tf.TransformerLM(jax_tf.TransformerConfig(**cfg)),
                                      jax_build_mesh(jax.devices()[:SLOTS], data=SLOTS, model=1))
        with pytest.raises(ValueError) as got:
            tf.make_ep_train_step(tf.TransformerLM(tf.TransformerConfig(**cfg)),
                                  build_mesh(_slots(), data=SLOTS, model=1))
        return str(got.value), str(want.value)

    got, want = errors(dict(LM, moe_experts=0))
    assert got == want and "needs an MoE config" in got
    got, want = errors(dict(LM, moe_experts=6))
    assert got == want == "moe_experts 6 must divide by the data axis size 4"


def test_ep_step_is_the_sp_step_on_a_data_mesh_and_deterministic():
    """make_sp_train_step on (data 4, seq 1) routes each slot's tokens at the
    same per-slot capacity with every expert local: the same objective, to f32
    reordering. donate=True gives donate=False's bits; two runs the same."""
    cfg = tf.TransformerConfig(**LM, moe_capacity_factor=1.0)
    model = tf.TransformerLM(cfg)
    params = model.init(seed=3)
    tokens = torch.as_tensor(_tokens(4))
    mesh = build_mesh(_slots(), data=SLOTS, model=1)

    def run(donate):
        step, shard = tf.make_ep_train_step(model, mesh, 0.2, donate=donate)
        p = shard(pytree_params_from_numpy(params, "cpu"))
        objects = [id(x) for x in tree_leaves(p)]
        losses = []
        for _ in range(2):
            new, loss = step(p, tokens)
            assert ([id(x) for x in tree_leaves(new)] == objects) == donate
            p = new
            losses.append(loss)
        return torch.stack(losses), [_whole(x).clone() for x in tree_leaves(p)]

    kept, donated, again = run(False), run(True), run(False)
    for a, b in ((kept, donated), (kept, again)):
        assert torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    sp = tf.make_sp_train_step(model, build_mesh(_slots(), data=SLOTS, seq=1, model=1), 0.2,
                               donate=False)
    p, sp_losses = pytree_params_from_numpy(params, "cpu"), []
    for _ in range(2):
        p, loss = sp(p, tokens)
        sp_losses.append(float(loss))
    np.testing.assert_allclose(kept[0].numpy(), sp_losses, atol=LOSS_ATOL)
    for a, b in zip(kept[1], tree_leaves(p)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
