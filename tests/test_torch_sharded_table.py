"""Tables over a mesh: harmony_tpu_torch against harmony_tpu on the CPU.

The reference's ``DenseTable(spec, build_mesh(...))`` and ``DeviceHashTable``
run on the 8 virtual CPU devices ``tests/conftest.py`` sets up; the port's
on ``DevicePool.virtual(cpu, 8)``, slot i standing for device i, with the
same mesh shape. Inputs are made once with numpy from a seed.

Tolerances. Exact against the reference wherever the arithmetic allows it:
placement (which blocks each slot holds), gathers, slot keys, block bytes,
and pushes of integer-valued deltas (any order of f32 additions of integers
below 2**24 is exact). The port's sharded table against its own one-slot
table: the same bytes for any deltas, since each shard folds its keys in
their original order. The reference's SKILL.md loop (50 steps of
``push(-0.1 * (pull - 1))``): each step's arithmetic is elementwise, so the
port's values are the reference's bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.config.params import TableConfig as JaxTableConfig
from harmony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from harmony_tpu.table.hashtable import DeviceHashTable as JaxHashTable
from harmony_tpu.table.hashtable import HashTableSpec as JaxHashSpec
from harmony_tpu.table.table import DenseTable as JaxDenseTable
from harmony_tpu.table.table import TableSpec as JaxTableSpec
from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.parallel.mesh import DevicePool, build_mesh
from harmony_tpu_torch.table import hashtable as torch_hashtable
from harmony_tpu_torch.table import table as torch_table
from harmony_tpu_torch.table.hashtable import DeviceHashTable, HashTableSpec
from harmony_tpu_torch.table.table import DenseTable, ShardedArray, TableSpec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU = torch.device("cpu")
MESHES = [(2, 4), (1, 8), (1, 4)]
SLOTS = DevicePool.virtual(CPU, 8).slots


def meshes(data, model):
    n = data * model
    return (jax_build_mesh(jax.devices()[:n], data=data, model=model),
            build_mesh(SLOTS[:n], data=data, model=model))


def dense_pair(data, model, *, ordered=False, num_blocks=16, capacity=200,
               value_shape=(3,), storage=None):
    kw = dict(table_id="t", capacity=capacity, value_shape=value_shape,
              num_blocks=num_blocks, is_ordered=ordered)
    jspec, spec = JaxTableSpec(JaxTableConfig(**kw)), TableSpec(TableConfig(**kw))
    jm, tm = meshes(data, model)
    if storage is None:
        storage = np.random.default_rng(7).integers(
            -9, 9, spec.storage_shape).astype(np.float32)
    jt = JaxDenseTable(jspec, jm, arr=jnp.asarray(storage))
    tt = DenseTable(spec, tm, arr=torch.as_tensor(storage.copy()))
    return jt, tt


def slot_contents(tt):
    """slot index -> the slot's shard as numpy (a tuple for a hash table)."""
    out = {}
    for slot, t in tt._step_state.shards.items():
        out[slot.index] = (tuple(x.numpy() for x in t) if isinstance(t, tuple)
                           else t.numpy())
    return out


def assert_placement(jarrs, tt):
    """Every slot holds exactly the block range, and bytes, that the
    reference's addressable shards put on the device of the same number."""
    got = slot_contents(tt)
    assert sorted(got) == sorted(d.id for d in jarrs[0].sharding.device_set)
    for part, jarr in enumerate(jarrs):
        for shard in jarr.addressable_shards:
            mine = got[shard.device.id]
            mine = mine[part] if isinstance(mine, tuple) else mine
            blocks = range(jarr.shape[0])[shard.index[0]]
            assert tt.sharding.slot_blocks(SLOTS[shard.device.id]) == blocks
            assert mine.tobytes() == np.asarray(shard.data).tobytes()


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("num_blocks", [16, 10])
def test_dense_placement_matches_addressable_shards(data, model, num_blocks):
    jt, tt = dense_pair(data, model, num_blocks=num_blocks)
    assert tt.sharding.spec == tuple(jt.sharding.spec)
    assert isinstance(tt.array, ShardedArray)
    assert_placement([jt.array], tt)


def int_deltas(rng, n, width=3):
    return rng.integers(-4, 5, (n, width)).astype(np.float32)


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("ordered", [True, False])
def test_dense_ops_match_the_reference(data, model, ordered):
    """pull, the keyed push on both folds and the scatter, pull_all and
    push_all, the host ops and export_blocks, with integer-valued deltas."""
    jt, tt = dense_pair(data, model, ordered=ordered)
    jspec, spec = jt.spec, tt.spec
    rng = np.random.default_rng(1)
    for via in ("mxu", "sparse", "scatter"):
        keys = rng.integers(0, 200, 300).astype(np.int32)
        deltas = int_deltas(rng, 300)
        jt.commit(jax.jit(lambda a, k, d: jspec.push(a, k, d, via=via))(
            jt.array, jnp.asarray(keys), jnp.asarray(deltas)))
        tt.apply_step(lambda a, k, d: (spec.push(a, k, d, via=via), None),
                      torch.as_tensor(keys), torch.as_tensor(deltas))
        want = np.asarray(jax.jit(jspec.pull)(jt.array, jnp.asarray(keys)))
        got = tt.apply_step(lambda a, k: (a, spec.pull(a, k)), torch.as_tensor(keys))
        assert got.numpy().tobytes() == want.tobytes(), via
    full = int_deltas(rng, 200)
    jt.commit(jax.jit(jspec.push_all)(jt.array, jnp.asarray(full)))
    tt.apply_step(lambda a, d: (spec.push_all(a, d), None), torch.as_tensor(full))
    assert tt.pull_array().numpy().tobytes() == np.asarray(jt.pull_array()).tobytes()
    probe = [0, 5, 199, 77, 5]
    d5 = int_deltas(rng, 5)
    jt.multi_update(probe, d5)
    tt.multi_update(probe, d5)
    np.testing.assert_array_equal(tt.multi_get(probe), np.asarray(jt.multi_get(probe)))
    vals = int_deltas(rng, 3)
    jt.multi_put([3, 150, 3], vals)
    tt.multi_put([3, 150, 3], vals)
    np.testing.assert_array_equal(tt.multi_get([3, 150]), np.asarray(jt.multi_get([3, 150])))
    je, te = jt.export_blocks(), tt.export_blocks()
    assert sorted(je) == sorted(te)
    assert all(te[b].tobytes() == np.asarray(je[b]).tobytes() for b in je)
    assert_placement([jt.array], tt)


@pytest.mark.parametrize("data,model", MESHES)
def test_host_multi_update_matches_the_reference(data, model):
    jt, tt = dense_pair(data, model)
    rng = np.random.default_rng(4)
    for _ in range(3):
        keys = rng.integers(0, 200, 40)
        d = int_deltas(rng, 40)
        jt.multi_update(keys, d)
        tt.multi_update(keys, d)
    assert tt.pull_array().numpy().tobytes() == np.asarray(jt.pull_array()).tobytes()


def test_skill_loop_on_a_2x4_mesh_matches_the_reference():
    """The verify recipe: 50 steps of push(-0.1 * (pull - 1)) over every key."""
    cfg = dict(table_id="m", capacity=100, value_shape=(8,), num_blocks=20)
    jspec, spec = JaxTableSpec(JaxTableConfig(**cfg)), TableSpec(TableConfig(**cfg))
    jm, tm = meshes(2, 4)
    jt, tt = JaxDenseTable(jspec, jm), DenseTable(spec, tm)
    jstep = jax.jit(lambda a, k: jspec.push(a, k, -0.1 * (jspec.pull(a, k) - 1.0)))
    keys = np.arange(100, dtype=np.int32)
    for _ in range(50):
        jt.commit(jstep(jt.array, jnp.asarray(keys)))
        tt.apply_step(lambda a, k: (spec.push(a, k, -0.1 * (spec.pull(a, k) - 1.0)), None),
                      torch.as_tensor(keys))
    got, want = tt.pull_array().numpy(), np.asarray(jt.pull_array())
    assert got.tobytes() == want.tobytes()
    assert abs(got.mean() - 1.0) < 1e-2
    assert_placement([jt.array], tt)


def test_replicated_table_receives_every_push_on_every_slot():
    """10 blocks do not divide over a model axis of 4: every slot holds every
    block (the reference's P()), every push reaches every replica."""
    jt, tt = dense_pair(1, 4, num_blocks=10)
    assert tt.sharding.spec == () and tuple(jt.sharding.spec) == ()
    spec, jspec = tt.spec, jt.spec
    rng = np.random.default_rng(2)
    for via in ("mxu", "sparse"):
        keys = rng.integers(0, 200, 120).astype(np.int32)
        d = int_deltas(rng, 120)
        tt.apply_step(lambda a, k, dd: (spec.push(a, k, dd, via=via), None),
                      torch.as_tensor(keys), torch.as_tensor(d))
        jt.commit(jax.jit(lambda a, k, dd: jspec.push(a, k, dd, via=via))(
            jt.array, jnp.asarray(keys), jnp.asarray(d)))
    shards = list(slot_contents(tt).values())
    assert len(shards) == 4 and all(s.shape == spec.storage_shape for s in shards)
    assert all(s.tobytes() == shards[0].tobytes() for s in shards)
    assert_placement([jt.array], tt)


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("num_blocks", [16, 10])
def test_sharded_table_is_the_bits_of_the_one_slot_table(data, model, num_blocks):
    """Float deltas, duplicate keys, out-of-range keys: every route, the
    host ops and the block bytes equal the one-slot table's, and every
    replica along data holds the same bytes."""
    rng = np.random.default_rng(3)
    _, tt = dense_pair(data, model, num_blocks=num_blocks)
    one = DenseTable(tt.spec, CPU, arr=torch.as_tensor(
        np.random.default_rng(7).integers(-9, 9, tt.spec.storage_shape).astype(np.float32)))
    spec = tt.spec
    for step in range(6):
        via = ("mxu", "sparse", "scatter")[step % 3]
        keys = torch.as_tensor(rng.integers(-5, 210, 256), dtype=torch.int32)
        keys[:64] = keys[64:128]
        d = torch.as_tensor(rng.standard_normal((256, 3)), dtype=torch.float32)
        outs = [t.apply_step(lambda a, k, dd: (spec.push(a, k, dd, via=via), spec.pull(a, k)),
                             keys, d) for t in (one, tt)]
        assert outs[0].numpy().tobytes() == outs[1].numpy().tobytes()
    for t in (one, tt):
        t.multi_update([1, 1, 2], np.full((3, 3), 0.1, np.float32))
    assert one.pull_array().numpy().tobytes() == tt.pull_array().numpy().tobytes()
    a, b = one.export_blocks(), tt.export_blocks()
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    sh = tt.sharding
    for slot, t in tt.array.shards.items():
        twin = sh.row_slots(0)[sh.shard_of(slot)]
        assert t.numpy().tobytes() == tt.array.shards[twin].numpy().tobytes()
    for r in range(sh.data_rows):   # a read by any data row gives the same rows
        rows = spec.pull_all(tt.array.at_row(r))
        assert rows.numpy().tobytes() == one.pull_array().numpy().tobytes()


def test_import_blocks_restores_every_replica():
    _, tt = dense_pair(2, 4)
    one = DenseTable(tt.spec, CPU, arr=tt.array.whole())
    blocks = {b: np.full((tt.spec.block_size, 3), b, np.float32) for b in (0, 5, 15)}
    tt.import_blocks(blocks)
    one.import_blocks(blocks)
    assert one.pull_array().numpy().tobytes() == tt.pull_array().numpy().tobytes()
    for slot, t in tt.array.shards.items():
        for b in tt.sharding.slot_blocks(slot):
            if b in blocks:
                assert (t[b - tt.sharding.slot_blocks(slot).start] == b).all()


def hash_pair(data, model, num_blocks=16, capacity=4096, value_shape=(3,)):
    kw = dict(table_id="h", capacity=capacity, value_shape=value_shape,
              num_blocks=num_blocks, is_ordered=False, sparse=True)
    jm, tm = meshes(data, model)
    return (JaxHashTable(JaxHashSpec(JaxTableConfig(**kw)), jm),
            DeviceHashTable(HashTableSpec(TableConfig(**kw)), tm))


@pytest.mark.parametrize("num_blocks", [16, 10])
def test_hash_table_on_1x4_matches_the_reference(num_blocks):
    jt, tt = hash_pair(1, 4, num_blocks)
    assert tt.sharding.spec == tuple(jt.sharding[0].spec)
    jspec, spec = jt.spec, tt.spec
    rng = np.random.default_rng(5)

    def jstep(state, k, d):
        state, rows, tok = jspec.pull(state, k)
        return jspec.push(state, tok, d), rows

    jstep = jax.jit(jstep)
    for _ in range(4):
        keys = rng.integers(1, 2**31 - 3, 300).astype(np.int32)
        keys[:60] = keys[60:120]
        d = int_deltas(rng, 300)
        state, jrows = jstep(jt.state, jnp.asarray(keys), jnp.asarray(d))
        jt.commit(state)

        def step(state, k, dd):
            state, rows, tok = spec.pull(state, k)
            return spec.push(state, tok, dd), rows

        rows = tt.apply_step(step, torch.as_tensor(keys), torch.as_tensor(d))
        assert rows.numpy().tobytes() == np.asarray(jrows).tobytes()
    assert_placement(list(jt.state), tt)
    probe = np.concatenate([keys[:30], [7, 2**31 - 4]])
    np.testing.assert_array_equal(tt.multi_get(probe), np.asarray(jt.multi_get(probe)))
    assert tt.num_present() == jt.num_present()
    vals = int_deltas(rng, 4)
    assert tt.multi_put([11, 12, 13, 11], vals) == jt.multi_put([11, 12, 13, 11], vals)
    assert tt.multi_update([11, 14], vals[:2]) == jt.multi_update([11, 14], vals[:2])
    np.testing.assert_array_equal(tt.multi_get([11, 12, 13, 14]),
                                  np.asarray(jt.multi_get([11, 12, 13, 14])))
    je, te = jt.export_blocks(), tt.export_blocks()
    for b in je:
        assert te[b][0].tobytes() == np.asarray(je[b][0]).tobytes()
        assert te[b][1].tobytes() == np.asarray(je[b][1]).tobytes()


@pytest.mark.parametrize("data,model", [(1, 4), (2, 4), (1, 8)])
def test_hash_table_sharded_is_the_bits_of_one_slot(data, model):
    _, tt = hash_pair(data, model)
    one = DeviceHashTable(tt.spec, CPU)
    spec = tt.spec
    rng = np.random.default_rng(6)

    def step(state, k, dd):
        state, rows, tok = spec.pull(state, k)
        return spec.push(state, tok, dd), (rows, tok[2].sum())

    for _ in range(4):
        keys = torch.as_tensor(rng.integers(-3, 2**31 - 1, 400), dtype=torch.int32)
        d = torch.as_tensor(rng.standard_normal((400, 3)), dtype=torch.float32)
        (ra, oa), (rb, ob) = (t.apply_step(step, keys, d) for t in (one, tt))
        assert ra.numpy().tobytes() == rb.numpy().tobytes() and int(oa) == int(ob)
    a, b = one.export_blocks(), tt.export_blocks()
    assert all(a[k][0].tobytes() == b[k][0].tobytes()
               and a[k][1].tobytes() == b[k][1].tobytes() for k in a)
    assert one.items().keys() == tt.items().keys()


class Spy:
    """Counts calls of a kernel wrapper, and the device of each call."""

    def __init__(self, monkeypatch, module, name):
        self.calls = []
        real = getattr(module, name)

        def spy(*args, **kw):
            self.calls.append(args[0].device)
            return real(*args, **kw)

        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("data,model", [(1, 4), (2, 4)])
@pytest.mark.parametrize("via", ["mxu", "sparse"])
def test_one_gather_and_one_fold_a_shard_a_step(monkeypatch, data, model, via):
    """A keyed step gathers once on each shard of its row and folds once on
    each slot (every replica); a replicated table gathers once."""
    _, tt = dense_pair(data, model)
    spec = tt.spec
    gather = Spy(monkeypatch, torch_table, "gather_rows")
    folds = {"mxu": Spy(monkeypatch, torch_table, "segment_sum"),
             "sparse": Spy(monkeypatch, torch_table, "segment_sum_rows")}
    keys = torch.as_tensor(np.random.default_rng(0).integers(0, 200, 64), dtype=torch.int32)
    for _ in range(3):
        tt.apply_step(lambda a, k: (spec.push(a, k, spec.pull(a, k) * 0.5, via=via), None),
                      keys)
    assert len(gather.calls) == 3 * model
    assert len(folds[via].calls) == 3 * data * model
    assert not folds["sparse" if via == "mxu" else "mxu"].calls
    _, rep = dense_pair(1, 4, num_blocks=10)
    gather.calls.clear()
    rep.apply_step(lambda a, k: (a, rep.spec.pull(a, k)), keys)
    assert len(gather.calls) == 1


def test_hash_step_folds_once_a_slot(monkeypatch):
    _, tt = hash_pair(2, 4)
    spec = tt.spec
    gather = Spy(monkeypatch, torch_hashtable, "gather_rows")
    fold = Spy(monkeypatch, torch_hashtable, "segment_sum_rows")
    keys = torch.as_tensor(np.random.default_rng(0).integers(1, 10**6, 100), dtype=torch.int32)

    def step(state, k):
        state, rows, tok = spec.pull(state, k)
        return spec.push(state, tok, rows * 0 + 1.0), None

    tt.apply_step(step, keys)
    assert len(gather.calls) == 4          # the read: the row's 4 shards
    assert len(fold.calls) == 8            # the push: every slot
    gather.calls.clear()
    tt.multi_get([1, 2, 3])
    assert len(gather.calls) == 4


def test_autotune_times_one_shard(monkeypatch):
    """The push route is measured on one shard's rows, on its slot."""
    from harmony_tpu_torch.table import autotune

    _, tt = dense_pair(1, 4)
    seen = []

    def timer(fn):
        before = [s.clone() for s in tt.array.shards.values()]
        fn()
        seen.append([s.equal(b) for s, b in zip(tt.array.shards.values(), before)])
        return 1.0

    autotune.reset()
    route = autotune.choose_push_route(tt.spec, CPU, 64, table=tt, timer=timer)
    assert route == "mxu" and len(seen) == 2 and all(all(s) for s in seen)
    (sig,) = autotune.measurements()
    assert sig[-1] == tt.spec._rows_per_shard(tt.sharding) == 4 * tt.spec.block_size
    autotune.reset()


def test_concurrent_writers_on_a_sharded_table_lose_no_update():
    """Stress: 8 threads push integer deltas into one (2, 4) table through
    ``multi_update`` and steps while others read, the interpreter switching
    threads every 10 us; the final table is the sum of every delta, exactly,
    and every replica holds it."""
    import sys
    import threading

    _, tt = dense_pair(2, 4)
    spec = tt.spec
    start = tt.pull_array().numpy().copy()
    rng = np.random.default_rng(8)
    work = [(rng.integers(0, 200, 32), int_deltas(rng, 32)) for _ in range(64)]
    want = start.copy()
    for keys, d in work:
        np.add.at(want, keys, d)
    errors = []

    def writer(i):
        try:
            for j, (keys, d) in enumerate(work[i::8]):
                if j % 2:
                    tt.multi_update(keys, d)
                else:
                    tt.apply_step(lambda a, k, dd: (spec.push(a, k, dd, via="sparse"), None),
                                  torch.as_tensor(keys, dtype=torch.int32), torch.as_tensor(d))
                tt.multi_get(keys[:4])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    np.testing.assert_array_equal(tt.pull_array().numpy(), want)
    for r in range(tt.sharding.data_rows):
        np.testing.assert_array_equal(spec.pull_all(tt.array.at_row(r)).numpy(), want)
