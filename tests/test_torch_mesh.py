"""harmony_tpu_torch.parallel against harmony_tpu.parallel on the CPU.

The port's meshes are over slots of ``DevicePool.virtual(cpu, n)``, the
reference's over the first n of the 8 virtual CPU devices
``tests/conftest.py`` sets up; slot i stands for device i. Exact throughout:
axis sizes, axis order, the slot order in the mesh, error messages, the
sharding rule's choice and every lease.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from harmony_tpu.parallel.mesh import DevicePool as JaxDevicePool
from harmony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from harmony_tpu.table.table import block_sharding as jax_block_sharding
from harmony_tpu_torch.parallel import dispatch
from harmony_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    DevicePool,
    Slot,
    build_mesh,
    mesh_spans_processes,
)
from harmony_tpu_torch.table.table import block_sharding


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU = torch.device("cpu")
SIZES = (None, 1, 2, 3, 4, 8)


def _outcome(fn):
    try:
        return fn(), None
    except ValueError as e:
        return None, str(e)


def _layout(mesh, index):
    return (tuple(mesh.axis_names), tuple(mesh.devices.shape),
            [index(d) for d in mesh.devices.flat])


@pytest.mark.parametrize("n", range(1, 9))
def test_build_mesh_sizes_order_and_errors_match(n):
    """Every data/model/seq combination, given or left out: the same mesh
    shape, axis names and slot order, or the same ValueError."""
    jdevs = jax.devices()[:n]
    slots = DevicePool.virtual(CPU, n).slots
    for data, model, seq in itertools.product(SIZES, SIZES, SIZES):
        want, werr = _outcome(lambda: jax_build_mesh(jdevs, data=data, model=model, seq=seq))
        got, gerr = _outcome(lambda: build_mesh(slots, data=data, model=model, seq=seq))
        assert gerr == werr, (data, model, seq)
        if want is not None:
            assert _layout(got, lambda s: s.index) == _layout(want, lambda d: d.id)
            assert got.shape == dict(want.shape)


def test_mesh_names_and_single_controller():
    mesh = build_mesh(DevicePool.virtual(CPU, 8).slots, data=2, seq=2)
    assert (DATA_AXIS, SEQ_AXIS, MODEL_AXIS) == mesh.axis_names
    assert mesh.shape == {"data": 2, "seq": 2, "model": 2} and mesh.size == 8
    assert not mesh_spans_processes(mesh)
    # torch devices stand for one slot each
    one = build_mesh([CPU])
    assert one.slots == [Slot(0, CPU)] and one.shape == {"data": 1, "model": 1}


@pytest.mark.parametrize("n,data", [(1, 1), (4, 1), (4, 2), (8, 1), (8, 2), (8, 4), (6, 2)])
@pytest.mark.parametrize("num_blocks", [1, 3, 8, 10, 16, 64, 256])
def test_block_sharding_choice_matches(n, data, num_blocks):
    want = jax_block_sharding(jax_build_mesh(jax.devices()[:n], data=data), num_blocks)
    got = block_sharding(build_mesh(DevicePool.virtual(CPU, n).slots, data=data), num_blocks)
    assert got.spec == tuple(want.spec)
    # each slot holds the blocks the reference's sharding gives its device
    idx = want.devices_indices_map((num_blocks,))
    for slot in got.mesh.slots:
        (sl,) = idx[jax.devices()[slot.index]]
        assert got.slot_blocks(slot) == range(num_blocks)[sl]


def _script(pool, idx):
    """One sequence of leases, grants and releases; every observable step."""
    out = []

    def grab(fn):
        try:
            return [idx(d) for d in fn()]
        except RuntimeError as e:
            return str(e)

    out.append(grab(lambda: pool.lease("a", 3)))
    out.append(grab(lambda: pool.lease("b", 2)))
    out.append(grab(lambda: pool.lease("c", 4)))            # too few free
    out.append(grab(lambda: pool.lease_all("shared")))
    out.append(sorted(pool.overlapping_jobs("a")))
    out.append(sorted(pool.overlapping_jobs("b")))
    pool.release("a")
    out.append(grab(lambda: pool.lease("c", 4)))
    out.append(grab(lambda: pool.lease_of("c")))
    out.append(sorted(pool.overlapping_jobs("c")))
    pool.release("shared")
    out.append(sorted(pool.overlapping_jobs("c")))
    out.append(grab(lambda: pool.lease_of("gone")))
    out.append(len(pool))
    return out


@pytest.mark.parametrize("kind", ["virtual", "distinct"])
def test_pool_leases_like_the_reference(kind):
    want = _script(JaxDevicePool(jax.devices()[:8]), lambda d: d.id)
    if kind == "virtual":
        pool = DevicePool.virtual(CPU, 8)
    else:  # distinct "devices": slots of eight devices, as a pool of cards has
        pool = DevicePool([Slot(i, torch.device("cuda", i)) for i in range(8)])
    assert _script(pool, lambda s: s.index) == want
    assert [s.index for s in pool.slots] == list(range(8))


def test_pool_refuses_repeated_devices_and_empty_virtual():
    with pytest.raises(ValueError, match="distinct devices"):
        DevicePool([CPU, CPU])
    with pytest.raises(ValueError, match="at least one slot"):
        DevicePool.virtual(CPU, 0)
    assert DevicePool([CPU]).devices == [CPU]
    assert DevicePool.virtual(CPU, 3).devices == [CPU] * 3


def test_dispatch_scope_orders_multi_slot_work_only():
    """A mesh of several slots takes the process-wide lock; one slot, or no
    mesh, takes nothing."""
    many = build_mesh(DevicePool.virtual(CPU, 4).slots)
    with dispatch.dispatch_scope(build_mesh([CPU])):
        assert dispatch._LOCK.acquire(blocking=False)   # not held: free
        dispatch._LOCK.release()
    with dispatch.dispatch_scope(many):
        assert dispatch._LOCK._is_owned()
        with dispatch.dispatch_scope(many):              # re-entrant
            pass
    assert not dispatch._LOCK._is_owned()
    with dispatch.dispatch_scope(None):
        assert not dispatch._LOCK._is_owned()


def test_virtual_slots_are_distinct_places():
    a, b = DevicePool.virtual(CPU, 2).slots
    assert a != b and a.device == b.device and len({a, b}) == 2
    assert np.asarray(build_mesh([a, b], model=2).devices).shape == (1, 2)
