"""harmony_tpu_torch.table against harmony_tpu.table on the CPU.

The same numpy keys, deltas and values go through the JAX TableSpec /
DenseTable (on a one-device CPU mesh) and through the port's. Tolerance: exact
everywhere. Partitioning is integer arithmetic; pulls copy bytes; the pushes
here carry integer-valued deltas, so every route's fold is exact whatever its
order; min, max and set are exact by nature.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.config.params import TableConfig as JaxTableConfig
from harmony_tpu.parallel import build_mesh
from harmony_tpu.table import DenseTable as JaxDenseTable
from harmony_tpu.table import TableSpec as JaxTableSpec
from harmony_tpu.table.partition import HashPartitioner as JaxHash
from harmony_tpu.table.partition import RangePartitioner as JaxRange
from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.convert import table_from_numpy
from harmony_tpu_torch.table.partition import HashPartitioner, RangePartitioner
from harmony_tpu_torch.table.table import DenseTable, TableSpec

CPU = torch.device("cpu")


@pytest.fixture()
def mesh1():
    return build_mesh(jax.devices()[:1])


def _specs(ordered, update_fn="add", capacity=50, num_blocks=7, value_shape=(3,)):
    kw = dict(table_id="t", capacity=capacity, value_shape=value_shape,
              num_blocks=num_blocks, is_ordered=ordered, update_fn=update_fn)
    return JaxTableSpec(JaxTableConfig(**kw)), TableSpec(TableConfig(**kw))


def _storage(spec, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-20, 20, size=spec.storage_shape).astype(np.float32)


def _both(arr):
    return jnp.asarray(arr), torch.as_tensor(arr.copy())


@pytest.mark.parametrize("cls", ["range", "hash"])
@pytest.mark.parametrize("capacity,num_blocks", [(50, 7), (101944, 256), (9, 9)])
def test_partitioner_locate_and_key_of_exact(cls, capacity, num_blocks):
    jcls, tcls = (JaxRange, RangePartitioner) if cls == "range" else (JaxHash, HashPartitioner)
    jp, tp = jcls(capacity, num_blocks), tcls(capacity, num_blocks)
    assert tp.block_size == jp.block_size
    # in range, negative and past-capacity keys: jnp's // and % floor
    keys = np.concatenate([np.arange(-capacity - 3, 2 * capacity + 5, max(1, capacity // 97)),
                           [-1, 0, capacity - 1, capacity, 2**31 - 1, -2**31]]).astype(np.int32)
    jb, jo = (np.asarray(a) for a in jp.locate(jnp.asarray(keys)))
    tb, to = tp.locate(torch.as_tensor(keys))
    np.testing.assert_array_equal(tb.numpy(), jb)
    np.testing.assert_array_equal(to.numpy(), jo)
    assert tb.dtype == torch.int32 and to.dtype == torch.int32
    b = np.arange(num_blocks, dtype=np.int32)[:, None]
    o = np.arange(jp.block_size, dtype=np.int32)[None, :]
    np.testing.assert_array_equal(
        tp.key_of(torch.as_tensor(b), torch.as_tensor(o)).numpy(),
        np.asarray(jp.key_of(jnp.asarray(b), jnp.asarray(o))))


@pytest.mark.parametrize("update_fn", ["add", "add_nonneg", "assign", "min", "max"])
@pytest.mark.parametrize("ordered", [True, False])
def test_init_array_matches(ordered, update_fn):
    js, ts = _specs(ordered, update_fn)
    want = np.asarray(js.init_array())
    got = ts.init_array(CPU)
    assert tuple(got.shape) == js.storage_shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("value_shape", [(), (3,), (2, 2)])
@pytest.mark.parametrize("ordered", [True, False])
def test_pull_and_pull_all_match(ordered, value_shape):
    js, ts = _specs(ordered, value_shape=value_shape)
    ja, ta = _both(_storage(js))
    keys = np.array([[0, 49, 3], [3, 7, 60]], dtype=np.int32)  # dup + out of range
    np.testing.assert_array_equal(
        ts.pull(ta, torch.as_tensor(keys)).numpy(),
        np.asarray(js.pull(ja, jnp.asarray(keys))))
    np.testing.assert_array_equal(ts.pull_all(ta).numpy(), np.asarray(js.pull_all(ja)))


PUSH_CASES = [
    # (update_fn, route): every route of an additive table; the scatter for the rest
    ("add", "auto"), ("add", "scatter"), ("add", "mxu"), ("add", "mxu_auto"),
    ("add", "sparse"), ("add_nonneg", "scatter"), ("add_nonneg", "mxu"),
    ("add_nonneg", "sparse"), ("min", "scatter"), ("max", "scatter"),
    ("assign", "scatter"),
]


@pytest.mark.parametrize("update_fn,via", PUSH_CASES)
@pytest.mark.parametrize("ordered", [True, False])
def test_push_matches_every_route(ordered, update_fn, via):
    js, ts = _specs(ordered, update_fn)
    ja, ta = _both(_storage(js))
    rng = np.random.default_rng(5)
    if update_fn == "assign":   # duplicate order of a set is unspecified
        keys = rng.permutation(js.config.capacity)[:20].astype(np.int32)
    else:                       # duplicates fold
        keys = rng.integers(0, js.config.capacity, size=40).astype(np.int32)
    deltas = rng.integers(-9, 10, size=(keys.shape[0], 3)).astype(np.float32)
    want = np.asarray(js.push(ja, jnp.asarray(keys), jnp.asarray(deltas), via=via))
    got = ts.push(ta, torch.as_tensor(keys), torch.as_tensor(deltas), via=via)
    assert got.data_ptr() == ta.data_ptr()  # updated in place
    np.testing.assert_array_equal(got.numpy(), want)


def test_update_fn_factories_resolve_only_inside_the_package():
    """A durable factory name is code-bearing input (the reference's
    update.py:56 allowlist): outside the port's package it is refused before
    any import; inside, it is imported and must return an UpdateFunction."""
    from harmony_tpu_torch.table.update import get_update_fn

    assert get_update_fn("add").scatter_mode == "add"
    with pytest.raises(PermissionError):
        get_update_fn("os.path:join")
    with pytest.raises(ModuleNotFoundError):
        get_update_fn("harmony_tpu_torch.no_such_module:factory")
    with pytest.raises(TypeError):
        get_update_fn("harmony_tpu_torch.table.update:_fill?value=1.5")
    with pytest.raises(KeyError):
        get_update_fn("no_such_fn")


def test_push_rejects_fold_routes_for_non_additive_and_unknown_routes():
    _, ts = _specs(True, "max")
    arr = ts.init_array(CPU)
    keys = torch.arange(4, dtype=torch.int32)
    for via in ("mxu", "sparse"):
        with pytest.raises(ValueError):
            ts.push(arr, keys, torch.ones((4, 3)), via=via)
    _, ts = _specs(True)
    with pytest.raises(ValueError):
        ts.push(ts.init_array(CPU), keys, torch.ones((4, 3)), via="nope")


def test_mxu_auto_gate_picks_the_fold_for_dense_pushes(monkeypatch):
    """mxu_auto folds through segment_sum (K3) at >= max(32, capacity // 256)
    keys and scatters below that (table.py:317-319)."""
    import harmony_tpu_torch.table.table as table_mod

    _, ts = _specs(False, "add", capacity=100000, num_blocks=256, value_shape=(1,))
    calls = []
    real = table_mod.segment_sum
    monkeypatch.setattr(table_mod, "segment_sum",
                        lambda *a: calls.append(len(a[1])) or real(*a))
    arr = ts.init_array(CPU)
    for n in (389, 390):  # 100000 // 256 = 390
        ts.push(arr, torch.arange(n, dtype=torch.int32), torch.ones((n, 1)),
                via="mxu_auto")
    assert calls == [390]


@pytest.mark.parametrize("update_fn", ["add", "add_nonneg", "assign", "min", "max"])
@pytest.mark.parametrize("ordered", [True, False])
def test_push_all_and_write_all_match(ordered, update_fn):
    js, ts = _specs(ordered, update_fn)
    rng = np.random.default_rng(6)
    deltas = rng.integers(-9, 10, size=(js.config.capacity, 3)).astype(np.float32)
    ja, ta = _both(_storage(js))
    np.testing.assert_array_equal(
        ts.push_all(ta, torch.as_tensor(deltas)).numpy(),
        np.asarray(js.push_all(ja, jnp.asarray(deltas))))
    ja, ta = _both(_storage(js, seed=1))
    np.testing.assert_array_equal(
        ts.write_all(ta, torch.as_tensor(deltas)).numpy(),
        np.asarray(js.write_all(ja, jnp.asarray(deltas))))


@pytest.mark.parametrize("ordered", [True, False])
def test_dense_table_host_ops_match(ordered, mesh1):
    js, ts = _specs(ordered)
    jt, tt = JaxDenseTable(js, mesh1), DenseTable(ts, "cpu")
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 50, size=30).astype(np.int32)
    values = rng.integers(-5, 5, size=(30, 3)).astype(np.float32)
    uniq = np.unique(keys)
    jt.multi_put(uniq, values[: len(uniq)])
    tt.multi_put(uniq, values[: len(uniq)])
    jt.multi_update(keys, values)
    tt.multi_update(keys, values)
    np.testing.assert_array_equal(tt.multi_get(keys), jt.multi_get(keys))
    np.testing.assert_array_equal(tt.pull_array().numpy(), np.asarray(jt.pull_array()))
    np.testing.assert_array_equal(tt.array.numpy(), np.asarray(jt.array))
    assert tt.data_version == jt.data_version == 2
    full = rng.integers(-5, 5, size=(50, 3)).astype(np.float32)
    jt.write_all(full)
    tt.write_all(full)
    np.testing.assert_array_equal(tt.pull_array().numpy(), np.asarray(jt.pull_array()))
    assert tt.data_version == jt.data_version == 3


def test_apply_step_commits_under_the_lock_and_readers_copy():
    _, ts = _specs(True)
    table = DenseTable(ts, "cpu")
    snap = table.pull_array()

    def step(arr, keys, delta):
        assert table._lock._is_owned()   # the step runs under the table lock
        return ts.push(arr, keys, delta), "aux"

    keys = torch.arange(5, dtype=torch.int32)
    assert table.apply_step(step, keys, torch.ones((5, 3))) == "aux"
    assert table.data_version == 1
    assert float(snap.abs().sum()) == 0.0          # the earlier read kept its value
    assert float(table.pull_array()[:5].sum()) == 15.0
    with pytest.raises(ValueError):
        table.commit(torch.zeros((2, 2)))


def test_push_via_by_device_and_operator_override(monkeypatch):
    monkeypatch.delenv("HARMONY_PUSH_VIA", raising=False)
    table = DenseTable(_specs(False)[1], "cpu")
    assert table.push_via == "scatter"      # the CPU: the scatter, as the reference
    table.device = torch.device("cuda")     # the rule alone; no tensor moves
    assert table.push_via == "mxu_auto"     # the card: the size-gated fold
    assert DenseTable(_specs(False, "max")[1], "cpu").push_via == "scatter"
    for forced in ("scatter", "mxu", "mxu_auto", "sparse"):
        monkeypatch.setenv("HARMONY_PUSH_VIA", forced)
        assert table.push_via == forced
    monkeypatch.setenv("HARMONY_PUSH_VIA", "bogus")
    assert table.push_via == "mxu_auto"


def test_table_from_numpy_carries_jax_storage(mesh1):
    js, ts = _specs(False)
    jt = JaxDenseTable(js, mesh1)
    jt.write_all(np.arange(150, dtype=np.float32).reshape(50, 3))
    tt = table_from_numpy(ts, np.asarray(jt.array), device="cpu")
    np.testing.assert_array_equal(tt.pull_array().numpy(), np.asarray(jt.pull_array()))
    with pytest.raises(ValueError):
        table_from_numpy(ts, np.zeros((2, 2), np.float32), device="cpu")
    with pytest.raises(ValueError):
        table_from_numpy(ts, np.zeros(ts.storage_shape, np.float64), device="cpu")


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DenseTable(_specs(True)[1])


@pytest.mark.parametrize("via", ["scatter", "mxu", "sparse"])
def test_a_negative_key_is_dropped_on_every_push_route(via, mesh1):
    """A key -1 on a range table (capacity 10, 4 blocks of 3: rows 10 and 11
    pad the last block). The port drops it on every route, as the reference's
    own folds do; the reference's scatter alone wraps it NumPy-style onto the
    last padding row, row 11. Exact: integer-valued deltas."""
    js, ts = _specs(True, capacity=10, num_blocks=4, value_shape=(2,))
    keys = np.array([-1, 3, 10, 11], np.int32)
    deltas = (np.arange(8, dtype=np.float32).reshape(4, 2) + 1)
    zeros = np.zeros(ts.storage_shape, np.float32)
    got = ts.push(torch.as_tensor(zeros.copy()), torch.as_tensor(keys), torch.as_tensor(deltas),
                  via=via).reshape(12, 2).numpy()
    want = np.zeros((12, 2), np.float32)
    want[3], want[10], want[11] = deltas[1], deltas[2], deltas[3]
    np.testing.assert_array_equal(got, want)
    ref = np.array(js.push(jnp.asarray(zeros), jnp.asarray(keys), jnp.asarray(deltas),
                           via=via)).reshape(12, 2)
    if via == "scatter":
        np.testing.assert_array_equal(ref[11], [8, 10])   # -1 wrapped onto row 11
        ref[11] -= deltas[0]
    np.testing.assert_array_equal(ref, want)


def test_apply_step_with_commits_both_tables_under_both_locks():
    """The step of a trainer with a local table: model table's lock, then the
    local table's, both held while the step runs; both storages committed."""
    _, ts = _specs(True)
    _, ls = _specs(True, update_fn="assign", capacity=8, num_blocks=2, value_shape=(2,))
    table, local = DenseTable(ts, "cpu"), DenseTable(ls, "cpu")

    def step(arr, larr, delta):
        assert table._lock._is_owned() and local._lock._is_owned()
        return (ts.push_all(arr, delta), ls.write_all(larr, torch.full((8, 2), 7.0))), "aux"

    assert table.apply_step_with(local, step, torch.ones((50, 3))) == "aux"
    assert (table.data_version, local.data_version) == (1, 1)
    assert float(table.pull_array().sum()) == 150.0
    assert float(local.pull_array().sum()) == 112.0
    assert not table._lock._is_owned() and not local._lock._is_owned()
