"""harmony_tpu_torch.table.hashtable against harmony_tpu.table.hashtable on the CPU.

tests/test_hashtable.py's cases, with the same numpy keys and values given to
the JAX DeviceHashTable (one-device CPU mesh) and to the port's. Tolerances:

* Slot keys, admission masks, overflow counts and present-key counts: exact
  (integer hashing, an integer min-claim whose winner does not depend on the
  order of its writes). Slot keys are compared byte for byte.
* Values: exact for integer-valued deltas (any order of f32 additions of
  integers below 2**24 is exact), for min, max, set and put (no arithmetic),
  and for lazy inits (the same uint32 hash and f32 steps). With float deltas
  the port folds a slot's duplicates from 0.0 and adds the fold once where the
  reference adds them one after another onto the stored value: the two sums
  differ in order only, within 4 f32 ulps of the largest magnitude here
  (atol 1e-5 at |v| < 20).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.config.params import TableConfig as JaxTableConfig
from harmony_tpu.parallel import build_mesh
from harmony_tpu.table.hashtable import DeviceHashTable as JaxHashTable
from harmony_tpu.table.hashtable import HashTableSpec as JaxHashSpec
from harmony_tpu.table.hashtable import MAX_KEY as JAX_MAX_KEY
from harmony_tpu.table.hashtable import MIN_KEY as JAX_MIN_KEY
from harmony_tpu.table.hashtable import _mix32 as jax_mix32
from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.convert import hash_table_from_numpy
from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows
from harmony_tpu_torch.table import hashtable
from harmony_tpu_torch.table.hashtable import (
    EMPTY_STORED,
    MAX_KEY,
    MIN_KEY,
    DeviceHashTable,
    HashTableSpec,
    mix32,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FLOAT_ATOL = 1e-5


@pytest.fixture()
def mesh1():
    return build_mesh(jax.devices()[:1])


def make_pair(mesh, capacity=256, num_blocks=4, value_shape=(4,), update_fn="add",
              max_probes=16):
    kw = dict(table_id="ht", capacity=capacity, value_shape=value_shape,
              num_blocks=num_blocks, is_ordered=False, update_fn=update_fn, sparse=True)
    jt = JaxHashTable(JaxHashSpec(JaxTableConfig(**kw), max_probes=max_probes), mesh)
    tt = DeviceHashTable(HashTableSpec(TableConfig(**kw), max_probes=max_probes), "cpu")
    return jt, tt


def sparse_keys(rng, n, lo=1, hi=2**31 - 3):
    """Distinct keys from the whole valid domain [1, MAX_KEY]."""
    return rng.choice(hi - lo, size=n, replace=False).astype(np.int32) + lo


def assert_same_state(jt, tt, *, exact=True):
    jk, jv = (np.asarray(a) for a in jt.state)
    tk, tv = (a.numpy() for a in tt.state)
    assert tk.dtype == jk.dtype == np.int32
    assert tk.tobytes() == jk.tobytes()          # every slot placement
    if exact:
        assert tv.tobytes() == jv.tobytes()
    else:
        np.testing.assert_allclose(tv, jv, rtol=0, atol=FLOAT_ATOL)
    assert tt.num_present() == jt.num_present()
    assert tt.overflow_count == jt.overflow_count


def test_constants_and_geometry_match():
    assert (MIN_KEY, MAX_KEY, EMPTY_STORED) == (JAX_MIN_KEY, JAX_MAX_KEY, 0)
    for cap, nb in ((256, 4), (400_001, 256), (32_770, 64), (16, 1), (6, 6), (3, 2)):
        kw = dict(table_id="g", capacity=cap, value_shape=(3,), num_blocks=nb,
                  is_ordered=False, sparse=True)
        js, ts = JaxHashSpec(JaxTableConfig(**kw)), HashTableSpec(TableConfig(**kw))
        assert (ts.num_blocks, ts.block_slots, ts.max_probes) == (
            js.num_blocks, js.block_slots, js.max_probes)
        assert ts.values_shape == js.values_shape and ts.keys_shape == js.keys_shape
    # bench-fm-hash's table: 256 blocks of 2,048 slots
    fm = HashTableSpec(TableConfig(table_id="fm", capacity=400_001, value_shape=(17,),
                                   num_blocks=256, is_ordered=False, sparse=True))
    assert (fm.num_slots, fm.block_slots) == (524_288, 2048)


def test_mix32_and_route_are_the_references_bits():
    rng = np.random.default_rng(0)
    keys = np.concatenate([rng.integers(-2**31, 2**31, 4000),
                           [0, 1, -1, 2**31 - 1, -2**31, MAX_KEY]]).astype(np.int32)
    for seed in (0x9E3779B9, 0x7F4A7C15, 0x94D049BB, 0x85EBCA6B, 0):
        want = np.asarray(jax_mix32(jnp.asarray(keys), seed)).astype(np.int64)
        got = mix32(hashtable.as_uint32(torch.as_tensor(keys)), seed).numpy()
        np.testing.assert_array_equal(got, want)
    kw = dict(table_id="r", capacity=1000, value_shape=(2,), num_blocks=7, is_ordered=False)
    js, ts = JaxHashSpec(JaxTableConfig(**kw)), HashTableSpec(TableConfig(**kw))
    for a, b in zip(js._route(jnp.asarray(keys)), ts._route(torch.as_tensor(keys))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


class TestBasicOps:
    def test_insert_lookup_roundtrip(self, mesh1):
        jt, tt = make_pair(mesh1)
        rng = np.random.default_rng(0)
        keys = sparse_keys(rng, 60)
        deltas = rng.standard_normal((60, 4)).astype(np.float32)
        assert jt.multi_update(keys, deltas) == tt.multi_update(keys, deltas) == 0
        np.testing.assert_array_equal(tt.multi_get(keys), jt.multi_get(keys))
        np.testing.assert_allclose(tt.multi_get(keys), deltas, atol=1e-6)
        assert tt.num_present() == 60
        assert_same_state(jt, tt)

    def test_get_or_init_admits_and_persists(self, mesh1):
        jt, tt = make_pair(mesh1)
        keys = [7, 123456789, 2**30 + 17]
        np.testing.assert_array_equal(tt.multi_get_or_init(keys), jt.multi_get_or_init(keys))
        assert tt.num_present() == 3
        jt.multi_update(keys, np.ones((3, 4), np.float32))
        tt.multi_update(keys, np.ones((3, 4), np.float32))
        np.testing.assert_array_equal(tt.multi_get(keys), np.ones((3, 4)))
        assert_same_state(jt, tt)

    def test_lookup_does_not_insert(self, mesh1):
        jt, tt = make_pair(mesh1, update_fn="min")
        got = tt.multi_get([5, 6, 7])
        np.testing.assert_array_equal(got, jt.multi_get([5, 6, 7]))
        assert tt.num_present() == 0
        # the min fn's +inf init reads clamped to float32's largest value
        assert (got == np.finfo(np.float32).max).all()
        assert_same_state(jt, tt)

    def test_duplicate_keys_fold_additively(self, mesh1):
        jt, tt = make_pair(mesh1)
        keys = np.asarray([42, 42, 42, 99], np.int32)
        deltas = np.asarray([[1, 0, 0, 0], [2, 0, 0, 0], [3, 0, 0, 0], [5, 0, 0, 0]],
                            np.float32)
        jt.multi_update(keys, deltas)
        tt.multi_update(keys, deltas)
        np.testing.assert_array_equal(tt.multi_get([42, 99]), [[6, 0, 0, 0], [5, 0, 0, 0]])
        assert tt.num_present() == 2
        assert_same_state(jt, tt)

    @pytest.mark.parametrize("integer_valued", [True, False])
    def test_accumulation_across_batches_matches(self, mesh1, integer_valued):
        jt, tt = make_pair(mesh1, capacity=512, num_blocks=8)
        rng = np.random.default_rng(1)
        universe = sparse_keys(rng, 100)
        model = {}
        for _ in range(5):
            keys = universe[rng.integers(0, 100, 40)]   # duplicates within a batch
            if integer_valued:
                deltas = rng.integers(-8, 8, (40, 4)).astype(np.float32)
            else:
                deltas = rng.standard_normal((40, 4)).astype(np.float32)
            jt.multi_update(keys, deltas)
            tt.multi_update(keys, deltas)
            for k, d in zip(keys, deltas):
                model[int(k)] = model.get(int(k), np.zeros(4, np.float32)) + d
        items = tt.items()
        assert set(items) == set(model)
        for k, v in model.items():
            np.testing.assert_allclose(items[k], v, atol=1e-4)
        assert_same_state(jt, tt, exact=integer_valued)

    def test_out_of_domain_keys_rejected(self, mesh1):
        """Key 0 (reserved), negative keys and keys above MAX_KEY drop."""
        jt, tt = make_pair(mesh1)
        keys = [-1, 0, -5, 3, MAX_KEY + 1, 2**31 - 1, MAX_KEY]
        d = np.ones((len(keys), 4), np.float32)
        assert tt.multi_update(keys, d) == jt.multi_update(keys, d) == 5
        assert tt.num_present() == 2
        np.testing.assert_array_equal(tt.multi_get([3, MAX_KEY]), np.ones((2, 4)))
        assert tt.overflow_count == 5
        assert_same_state(jt, tt)


class TestCollisionsAndOverflow:
    def test_collision_heavy_single_block(self, mesh1):
        jt, tt = make_pair(mesh1, capacity=64, num_blocks=1, max_probes=64)
        rng = np.random.default_rng(2)
        keys = sparse_keys(rng, 48)
        deltas = rng.integers(-9, 9, (48, 4)).astype(np.float32)
        jt.multi_update(keys, deltas)
        tt.multi_update(keys, deltas)
        assert tt.num_present() == 48
        np.testing.assert_array_equal(tt.multi_get(keys), deltas)
        assert_same_state(jt, tt)

    def test_overflow_is_observable_not_corrupting(self, mesh1):
        """ensure on a 16-slot table with 40 keys: the same 16 admitted, the
        same slots, the same ok mask."""
        jt, tt = make_pair(mesh1, capacity=16, num_blocks=1, max_probes=16)
        keys = sparse_keys(np.random.default_rng(3), 40)
        jstate, (jb, js, jok) = jt.spec.ensure(jt.state, jnp.asarray(keys, jnp.int32))
        tstate, (tb, ts, tok) = tt.spec.ensure(tt.state, torch.as_tensor(keys))
        for a, b in ((jb, tb), (js, ts), (jok, tok)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert int(tok.sum()) == 16
        jt.commit(jstate)
        tt.commit(tstate)
        assert np.isfinite(tt.multi_get(keys[tok.numpy()])).all()
        assert_same_state(jt, tt)

    def test_overflow_counted_on_host_surface(self, mesh1):
        jt, tt = make_pair(mesh1, capacity=16, num_blocks=1, max_probes=16)
        keys = sparse_keys(np.random.default_rng(8), 40)
        d = np.ones((40, 4), np.float32)
        assert tt.multi_update(keys, d) == jt.multi_update(keys, d) == 24
        assert tt.overflow_count == 24
        np.testing.assert_array_equal(tt.multi_get_or_init(keys), jt.multi_get_or_init(keys))
        assert tt.overflow_count == 48
        assert_same_state(jt, tt)

    def test_exhausted_probes_with_a_small_budget(self, mesh1):
        """A probe budget below the block size: keys drop while slots are
        still free, the same keys in both packages."""
        jt, tt = make_pair(mesh1, capacity=64, num_blocks=2, max_probes=2)
        keys = sparse_keys(np.random.default_rng(9), 60)
        d = np.full((60, 4), 2.0, np.float32)
        dropped = tt.multi_update(keys, d)
        assert dropped == jt.multi_update(keys, d) and 0 < dropped
        assert tt.num_present() < 64
        assert_same_state(jt, tt)

    def test_batch_race_for_one_empty_slot(self, mesh1):
        """Distinct keys whose probe sequences collide, several of them
        repeated in the batch: every key lands where the reference puts it."""
        jt, tt = make_pair(mesh1, capacity=32, num_blocks=1, max_probes=32)
        keys = np.arange(0, 24, dtype=np.int32) * 7919 + 13
        keys = np.concatenate([keys, keys[::3], keys[5:9]])
        d = np.ones((len(keys), 4), np.float32)
        jt.multi_update(keys, d)
        tt.multi_update(keys, d)
        assert tt.num_present() == 24
        assert_same_state(jt, tt)

    def test_pull_with_duplicates_and_races(self, mesh1):
        """spec.pull on a batch of duplicates and racing keys, twice: the
        values, the tokens and the state."""
        jt, tt = make_pair(mesh1, capacity=64, num_blocks=2, update_fn="max")
        rng = np.random.default_rng(11)
        base = sparse_keys(rng, 30)
        for _ in range(2):
            keys = base[rng.integers(0, 30, 50)]
            jstate, jv, jtok = jt.spec.pull(jt.state, jnp.asarray(keys))
            tstate, tv, ttok = tt.spec.pull(tt.state, torch.as_tensor(keys))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            for a, b in zip(jtok, ttok):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            jt.commit(jstate)
            tt.commit(tstate)
            assert_same_state(jt, tt)


class TestUpdateModes:
    @pytest.mark.parametrize("update_fn", ["add", "add_nonneg", "min", "max", "assign"])
    @pytest.mark.parametrize("value_shape", [(), (3,)])
    def test_push_modes_match(self, mesh1, update_fn, value_shape):
        """Every scatter mode, with (add_nonneg) and without a post invariant,
        on batches with duplicates and refused keys: exact."""
        jt, tt = make_pair(mesh1, capacity=64, num_blocks=2, value_shape=value_shape,
                           update_fn=update_fn)
        rng = np.random.default_rng(12)
        universe = np.concatenate([sparse_keys(rng, 40), [0, -3]]).astype(np.int32)
        for _ in range(4):
            keys = universe[rng.integers(0, len(universe), 30)]
            deltas = rng.integers(-6, 6, (30, *value_shape)).astype(np.float32)
            assert tt.multi_update(keys, deltas) == jt.multi_update(keys, deltas)
            assert_same_state(jt, tt)

    def test_min_mode(self, mesh1):
        jt, tt = make_pair(mesh1, update_fn="min", value_shape=())
        for t in (jt, tt):
            t.multi_update([10, 20, 10], np.asarray([5.0, 7.0, 3.0], np.float32))
            t.multi_update([10], np.asarray([9.0], np.float32))   # larger: no change
        np.testing.assert_array_equal(tt.multi_get([10, 20]), [3.0, 7.0])
        assert_same_state(jt, tt)

    def test_assign_mode_last_wins(self, mesh1):
        jt, tt = make_pair(mesh1, update_fn="assign")
        for t in (jt, tt):
            t.multi_update([5, 5], np.asarray([[1] * 4, [2] * 4], np.float32))
        np.testing.assert_array_equal(tt.multi_get([5])[0], [2, 2, 2, 2])
        assert_same_state(jt, tt)

    def test_assign_exact_across_magnitudes(self, mesh1):
        jt, tt = make_pair(mesh1, update_fn="assign", value_shape=())
        for t in (jt, tt):
            t.multi_update([5], np.asarray([1e8], np.float32))
            t.multi_update([5], np.asarray([1.0], np.float32))
        np.testing.assert_array_equal(tt.multi_get([5]), [1.0])
        assert_same_state(jt, tt)

    def test_exact_set_stores_the_references_zero(self, mesh1):
        """The reference's exact set is (cur - cur) + new: a -0.0 is stored as
        +0.0. Byte-compared, so the sign of a zero counts."""
        jt, tt = make_pair(mesh1, update_fn="assign", value_shape=(2,))
        vals = np.asarray([[-0.0, 1.5], [0.0, -0.0]], np.float32)
        for t in (jt, tt):
            t.multi_update([3, 4], vals)
            t.multi_put([5], np.asarray([[-0.0, -2.0]], np.float32))
        assert_same_state(jt, tt)
        assert not np.signbit(tt.multi_get([3, 4, 5])[:, 0]).any()

    def test_post_invariant_only_on_touched(self, mesh1):
        jt, tt = make_pair(mesh1, update_fn="add_nonneg")
        for t in (jt, tt):
            t.multi_update([1, 2], np.asarray([[1] * 4, [2] * 4], np.float32))
            t.multi_update([1, 1], np.full((2, 4), -5.0, np.float32))
        got = tt.multi_get([1, 2])
        np.testing.assert_array_equal(got, [[0] * 4, [2] * 4])
        assert_same_state(jt, tt)

    def test_put_overwrites_whatever_the_update_fn(self, mesh1):
        jt, tt = make_pair(mesh1)
        rng = np.random.default_rng(10)
        keys = sparse_keys(rng, 40)
        vals = rng.standard_normal((40, 4)).astype(np.float32)
        for t in (jt, tt):
            assert t.multi_put(keys, vals) == 0
            t.multi_put(keys[:5], np.zeros((5, 4), np.float32))
        np.testing.assert_array_equal(tt.multi_get(keys[5:]), vals[5:])
        np.testing.assert_array_equal(tt.multi_get(keys[:5]), np.zeros((5, 4)))
        assert_same_state(jt, tt)


def test_pull_push_step_launches_k1_once_and_k2_once(mesh1):
    """The train-step pattern (pull, compute, token push) as one apply_step,
    on the CPU: the kernels' plain versions, and the same state as the JAX
    step; K1 and K2 count launches only on the card."""
    jt, tt = make_pair(mesh1, capacity=256, num_blocks=4)
    rng = np.random.default_rng(5)
    keys = sparse_keys(rng, 32)
    keys = np.concatenate([keys, keys[:8]])
    grads = rng.integers(-4, 4, (40, 4)).astype(np.float32)

    def jstep(state, k, g):
        state, vals, token = jt.spec.pull(state, k)
        return jt.spec.push(state, token, -0.5 * g + 0.0 * vals), vals

    def tstep(state, k, g):
        state, vals, token = tt.spec.pull(state, k)
        return tt.spec.push(state, token, -0.5 * g + 0.0 * vals), vals

    jv = jt.apply_step(jax.jit(jstep), jnp.asarray(keys), jnp.asarray(grads))
    counts = (gather_rows.launches, segment_sum_rows.launches)
    tv = tt.apply_step(tstep, torch.as_tensor(keys), torch.as_tensor(grads))
    assert counts == (gather_rows.launches, segment_sum_rows.launches)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert_same_state(jt, tt)


def test_a_converted_table_reads_as_the_jax_table(mesh1):
    jt, _ = make_pair(mesh1)
    rng = np.random.default_rng(6)
    keys = sparse_keys(rng, 50)
    jt.multi_update(keys, rng.standard_normal((50, 4)).astype(np.float32))
    sk, v = (np.asarray(a) for a in jt.state)
    tt = hash_table_from_numpy(HashTableSpec(TableConfig(
        table_id="ht", capacity=256, value_shape=(4,), num_blocks=4, is_ordered=False,
        sparse=True)), sk, v, device="cpu")
    np.testing.assert_array_equal(tt.multi_get(keys), jt.multi_get(keys))
    assert tt.items().keys() == jt.items().keys()
    with pytest.raises(ValueError, match="int32"):
        hash_table_from_numpy(tt.spec, sk.astype(np.int64), v, device="cpu")


def test_drop_and_the_ops_not_ported():
    """``reshard`` moves the table across meshes as the reference's does:
    the same slot keys byte for byte and the same values on every layout,
    reads and writes going on in between; ``addressable_blocks`` (the pod's)
    stays refused, naming ROADMAP A item 3; a dropped table refuses reads."""
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.parallel.mesh import build_mesh as port_mesh

    kw = dict(table_id="d", capacity=256, value_shape=(2,), num_blocks=8,
              is_ordered=False, sparse=True)
    jt = JaxHashTable(JaxHashSpec(JaxTableConfig(**kw)), build_mesh(jax.devices()[:2], data=1))
    slots = DevicePool.virtual("cpu", 4).slots
    tt = DeviceHashTable(HashTableSpec(TableConfig(**kw)), port_mesh(slots[:2], data=1))
    rng = np.random.default_rng(8)
    keys = sparse_keys(rng, 60)
    for n in (3, 4, 1, 2):   # 3 owners replicate the 8 blocks, 1, 2 and 4 shard them
        d = rng.integers(-4, 5, size=(60, 2)).astype(np.float32)
        jt.multi_update(keys, d)
        tt.multi_update(keys, d)
        jt.reshard(build_mesh(jax.devices()[:n], data=1))
        tt.reshard(port_mesh(slots[:n], data=1))
        assert tt.mesh.size == n
        jk, jv = (np.asarray(a) for a in jt.state)
        with tt._lock:
            st = tt.state
            tk, tv = ((st.whole(0), st.whole(1)) if tt.mesh.size > 1 else st)
        assert tk.numpy().tobytes() == jk.tobytes()
        assert tv.numpy().tobytes() == jv.tobytes()
        np.testing.assert_array_equal(tt.multi_get(keys), jt.multi_get(keys))
    with pytest.raises(NotImplementedError, match="ROADMAP A item 3"):
        tt.addressable_blocks()
    tt.drop()
    with pytest.raises(RuntimeError, match="dropped"):
        tt.multi_get([1])


def test_master_creates_a_hash_table_and_the_min_key_rule():
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    m = ETMaster(DevicePool(["cpu"]))
    m.add_executors(1)
    cfg = TableConfig(table_id="s-emb", capacity=256, value_shape=(4,), num_blocks=4,
                      is_ordered=False, sparse=True)
    table = m.create_table(cfg, m.executor_ids())
    dense = m.create_table(cfg.replace(table_id="d-emb", sparse=False), m.executor_ids())
    assert isinstance(table, DeviceHashTable)
    keys = sparse_keys(np.random.default_rng(10), 40)
    vals = np.random.default_rng(11).standard_normal((40, 4)).astype(np.float32)
    table.multi_put(keys, vals)
    np.testing.assert_array_equal(table.multi_get(keys), vals)
    # the first key a hash table admits is MIN_KEY: key 0 is refused and
    # counted, where the dense table stores it
    assert MIN_KEY == 1
    assert table.multi_put([0], vals[:1]) == 1 and table.overflow_count == 1
    assert dense.multi_put([0], vals[:1]) is None
    np.testing.assert_array_equal(dense.multi_get([0]), vals[:1])
    m.drop_table("s-emb")
    assert m.table_ids() == ["d-emb"]
