"""The port's data caches (harmony_tpu_torch/data/devcache.py) against
harmony_tpu's, and the job entity's dataset cache on the CPU.

* ``ByteLRU``: one sequence of put/get/contains/drop/clear through both
  packages' caches, on values made with numpy: every answer and every
  ``stats()`` equal, exactly.
* The entity (the repair of C3): a second set-up of the same data source
  (``data_fn`` and ``data_args``) calls ``data_fn`` zero times, as the
  reference's entity does.
* The device caches are read-only by contract: a cached batch's bytes, and a
  cached stack's, are unchanged after epochs that trained from them.

Every test starts and ends with both process-level caches empty.
"""
import numpy as np
import pytest
import torch

from harmony_tpu.data import devcache as jax_devcache
from harmony_tpu.jobserver.entity import DolphinJobEntity as JaxEntity
from harmony_tpu.config.params import JobConfig as JaxJobConfig
from harmony_tpu_torch.apps import mlr
from harmony_tpu_torch.config.params import JobConfig, TrainerParams
from harmony_tpu_torch.data import devcache
from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.runtime.master import ETMaster


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _empty_caches():
    devcache.clear()
    devcache.host_data.clear()
    yield
    devcache.clear()
    devcache.host_data.clear()


def _ops(rng):
    """A fixed sequence of cache operations over numpy values of 64 to 512
    bytes, in a cache of 1,000 bytes: hits, misses, evictions, a value over
    the budget, a replaced key, contains on present and absent keys, drops."""
    ops = []
    for i in range(40):
        key = f"k{int(rng.integers(0, 8))}"
        r = rng.random()
        if r < 0.45:
            n = int(rng.integers(16, 129))
            ops.append(("put", key, rng.standard_normal(n).astype(np.float32)))
        elif r < 0.8:
            ops.append(("get", key, None))
        elif r < 0.93:
            ops.append(("contains", key, None))
        else:
            ops.append(("drop", key, None))
    ops.insert(10, ("put", "huge", np.zeros(300, np.float32)))   # 1,200 bytes
    ops.insert(20, ("put", "pair", (np.zeros(8, np.int32), np.zeros(4, np.float64))))
    ops.insert(21, ("get", None, None))
    ops.insert(22, ("contains", None, None))
    ops.insert(23, ("get", "pair", None))
    return ops


def _apply(cache, op, key, value):
    if op == "put":
        return cache.put(key, value)
    if op == "get":
        got = cache.get(key)
        return None if got is None else cache._nbytes(got)
    if op == "contains":
        return cache.contains(key)
    return cache.drop(lambda k: k == key)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_byte_lru_matches_the_reference(seed):
    ops = _ops(np.random.default_rng(seed))
    mine, ref = devcache.ByteLRU(1000), jax_devcache.ByteLRU(1000)
    for op, key, value in ops:
        assert _apply(mine, op, key, value) == _apply(ref, op, key, value), (op, key)
        assert mine.stats() == ref.stats(), (op, key)
    mine.clear()
    ref.clear()
    assert mine.stats() == ref.stats() == {"hits": 0, "misses": 0, "bytes": 0,
                                           "entries": 0}


def test_contains_moves_neither_counters_nor_order():
    cache = devcache.ByteLRU(64)
    cache.put("a", np.zeros(8, np.float32))
    cache.put("b", np.zeros(8, np.float32))
    assert cache.contains("a") and not cache.contains("c")
    assert cache.stats()["hits"] == cache.stats()["misses"] == 0
    cache.put("c", np.zeros(8, np.float32))     # evicts "a", the oldest
    assert not cache.contains("a") and cache.contains("b")


def test_a_tensor_counts_its_elements_bytes():
    """A device cache entry is a tuple of tensors: numel * element_size each,
    the bytes an ndarray of the same shape and dtype counts."""
    t = (torch.zeros(3, 5, dtype=torch.float32), torch.zeros(7, dtype=torch.int64),
         torch.zeros(6, dtype=torch.bfloat16)[::2])
    assert devcache.ByteLRU._nbytes(t) == 3 * 5 * 4 + 7 * 8 + 3 * 2
    cache = devcache.ByteLRU(100)
    cache.put("t", t)                    # 128 bytes: over the budget, never kept
    assert not cache.contains("t") and cache.stats()["bytes"] == 0


def test_the_process_caches_have_the_references_budgets():
    assert devcache._device.max_bytes == jax_devcache._device.max_bytes == 2 << 30
    assert devcache.host_data.max_bytes == jax_devcache.host_data.max_bytes == 4 << 30


DATA_ARGS = {"n": 64, "num_features": 32, "num_classes": 4}


def _config(job_id, package="harmony_tpu_torch", epochs=1, data_args=None, **params):
    cfg_cls = JobConfig if package == "harmony_tpu_torch" else JaxJobConfig
    params_cls = TrainerParams
    if package != "harmony_tpu_torch":
        from harmony_tpu.config.params import TrainerParams as params_cls
    return cfg_cls(
        job_id=job_id, app_type="dolphin", trainer=f"{package}.apps.mlr:MLRTrainer",
        params=params_cls(num_epochs=epochs, num_mini_batches=4,
                          app_params={"num_classes": 4, "num_features": 32,
                                      "features_per_partition": 8}, **params),
        num_workers=1,
        user={"data_fn": f"{package}.apps.mlr:make_synthetic",
              "data_args": dict(DATA_ARGS if data_args is None else data_args)})


@pytest.fixture
def counted_make_synthetic(monkeypatch):
    calls = []
    fn = mlr.make_synthetic

    def counted(**kw):
        calls.append(kw)
        return fn(**kw)

    monkeypatch.setattr(mlr, "make_synthetic", counted)
    return calls


def _setup(config):
    master = ETMaster(DevicePool(["cpu"]))
    entity = DolphinJobEntity(config)
    entity.setup(master, [e.id for e in master.add_executors(1)])
    return entity


def test_a_second_setup_of_the_same_source_calls_data_fn_zero_times(
        counted_make_synthetic):
    """C3: the reference's entity reads its host-data cache on a second
    submission with the same data_args; the port's now does too. A job with
    other data_args generates its own."""
    first = _setup(_config("a"))
    assert len(counted_make_synthetic) == 1
    second = _setup(_config("b", epochs=3))
    assert len(counted_make_synthetic) == 1
    assert all(x is y for x, y in zip(first._data_arrays, second._data_arrays))
    assert devcache.host_data.stats()["hits"] == 1
    _setup(_config("c", data_args={**DATA_ARGS, "n": 96}))
    assert len(counted_make_synthetic) == 2
    for e in (first, second):
        e.cleanup()


def test_the_data_source_key_is_the_references():
    for args in (DATA_ARGS, {"n": 64, "flag": True, "dims": [1, 2.0]}):
        mine = DolphinJobEntity(_config("x", data_args=args))._data_source_key()
        ref = JaxEntity(_config("x", package="harmony_tpu",
                                data_args=args))._data_source_key()
        assert mine[1] == ref[1]
        assert mine[0] == "harmony_tpu_torch.apps.mlr:make_synthetic"
    assert DolphinJobEntity(_config("y", data_args={"bad": {1: 2}}))._data_source_key() is None


def test_the_worker_gets_the_references_dataset_key():
    entity = _setup(_config("k"))
    data = entity.make_worker().data
    assert data.dataset_key == (entity._data_source_key(), 0, 64, 4)
    entity.cleanup()


@pytest.mark.parametrize("fused", [True, False])
def test_cached_batches_are_unchanged_by_training(fused):
    """Two epochs from the device cache (the stack on the fused path, the
    per-batch copies on the unfused one), then the entries' bytes against
    copies taken before: equal."""
    entity = _setup(_config("r", epochs=2, fused_step=fused))
    worker = entity.make_worker()
    worker.run()
    key = worker.data.dataset_key
    if fused:
        entries = [devcache.get((key, "stacked", "cpu"))]
    else:
        entries = [devcache.get((key, i, "cpu")) for i in range(4)]
    assert all(e is not None for e in entries)
    before = [[t.clone() for t in e] for e in entries]
    entity.make_worker().run()
    for e, b in zip(entries, before):
        for t, c in zip(e, b):
            assert torch.equal(t, c)
    entity.cleanup()
