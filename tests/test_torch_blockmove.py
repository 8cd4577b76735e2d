"""harmony_tpu_torch.table.blockmove against harmony_tpu.table.blockmove, on the CPU.

The planner (``axis0_bounds``, ``process_blocks``, ``block_owners``,
``plan_moves``, ``_contiguous_runs``) on the same layouts in both packages:
the reference's stand-in shardings (devices with a process index mapped to
block ranges, as tests/test_blockmove.py builds them) given to both, and the
port's ``BlockSharding`` against the reference's ``block_sharding``
NamedSharding on equal meshes. The frame codec: the port's frames for f32,
int32 and bf16 blocks are the reference's bytes, and each package decodes
the other's. All exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.parallel import build_mesh as jax_mesh
from harmony_tpu.table import blockmove as J
from harmony_tpu.table.table import block_sharding as jax_block_sharding
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.parallel.mesh import build_mesh as port_mesh
from harmony_tpu_torch.table import blockmove as T
from harmony_tpu_torch.table.table import block_sharding


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Dev:
    def __init__(self, pid):
        self.process_index = pid


class _Sharding:
    """The reference's planner stand-in: devices mapped to axis-0 slices."""

    def __init__(self, dev_slices):
        self._m = {d: (sl,) for d, sl in dev_slices}

    def devices_indices_map(self, shape):
        return self._m


def _sh(*pid_ranges):
    return _Sharding([(_Dev(pid), slice(a, b)) for pid, a, b in pid_ranges])


def same_plan(a, b):
    return (a.sends == b.sends and a.recvs == b.recvs
            and a.block_nbytes == b.block_nbytes and a.total_moves == b.total_moves)


@pytest.mark.parametrize("old,new", [
    (((0, 0, 6), (1, 6, 12)), ((0, 0, 12),)),
    (((0, 0, 12),), ((0, 0, 6), (1, 6, 12))),
    (((0, 0, 6), (1, 6, 12)), ((0, 0, 6), (1, 6, 12))),
    (((0, 0, 6), (1, 6, 12)), ((0, 0, 12), (1, 0, 12), (2, 0, 12))),
    (((0, 0, 12), (1, 0, 12)), ((2, 0, 12),)),
])
def test_the_reference_planner_cases(old, new):
    shape = (12, 4, 3)
    o, n = _sh(*old), _sh(*new)
    assert same_plan(T.plan_moves(o, n, shape, 4), J.plan_moves(o, n, shape, 4))
    assert T.block_owners(o, shape) == J.block_owners(o, shape)
    assert T.process_blocks(n, shape) == J.process_blocks(n, shape)


def test_an_uncovered_layout_is_refused_as_the_reference_refuses_it():
    o, n = _sh((0, 0, 6)), _sh((1, 0, 12))
    with pytest.raises(ValueError, match="no owner"):
        J.plan_moves(o, n, (12, 4), 8)
    with pytest.raises(ValueError, match="no owner"):
        T.plan_moves(o, n, (12, 4), 8)


def test_random_layouts_plan_the_references_moves():
    rng = np.random.default_rng(11)
    for _ in range(200):
        nb = int(rng.choice([6, 12, 24]))
        nprocs = int(rng.integers(1, 6))

        def layout():
            dev_slices = []
            for p in range(nprocs):
                a = int(rng.integers(nb))
                b = int(rng.integers(a + 1, nb + 1))
                dev_slices.append((p, a, b))
            for blk in range(nb):
                if not any(a <= blk < b for _, a, b in dev_slices):
                    dev_slices.append((int(rng.integers(nprocs)), blk, blk + 1))
            return _sh(*dev_slices)

        o, n = layout(), layout()
        assert same_plan(T.plan_moves(o, n, (nb, 4), 4), J.plan_moves(o, n, (nb, 4), 4))
        assert T.block_owners(o, (nb, 4)) == J.block_owners(o, (nb, 4))


def test_axis0_bounds_and_contiguous_runs():
    for idx in ((), (slice(None),), (slice(3, 7),), (slice(None, 5),), (slice(2, None),)):
        assert T.axis0_bounds(idx, 12) == J.axis0_bounds(idx, 12)
    rng = np.random.default_rng(2)
    for _ in range(50):
        blocks = list(rng.choice(40, size=int(rng.integers(0, 20)), replace=False))
        assert T._contiguous_runs(blocks) == J._contiguous_runs(blocks)


LAYOUTS = [(n, d) for n in (1, 2, 3, 4) for d in (1, 2) if n % d == 0]


def slot_map(sharding, nb, key):
    return {key(d): T.axis0_bounds(idx, nb)
            for d, idx in sharding.devices_indices_map((nb, 4)).items()}


@pytest.mark.parametrize("n,data", LAYOUTS)
@pytest.mark.parametrize("nb", [12, 16])
def test_block_sharding_places_blocks_as_the_references_named_sharding(n, data, nb):
    """The port's BlockSharding on (data, n / data) slots against the
    reference's block_sharding on as many devices: each slot i holds the
    blocks device i holds (16 blocks over 3 model coordinates replicate)."""
    ours = block_sharding(port_mesh(DevicePool.virtual("cpu", 4).slots[:n], data=data), nb)
    ref = jax_block_sharding(jax_mesh(jax.devices()[:n], data=data), nb)
    assert slot_map(ours, nb, lambda s: s.index) == slot_map(ref, nb, lambda d: d.id)


@pytest.mark.parametrize("old", LAYOUTS)
@pytest.mark.parametrize("new", LAYOUTS)
def test_slot_level_plans_are_the_references_on_equal_layouts(old, new):
    """Plans by slot (the port's in-process move) against the reference's
    planner over the same layouts, each device standing for its own process."""
    nb, slots = 12, DevicePool.virtual("cpu", 4).slots

    def ours(n, d):
        return block_sharding(port_mesh(slots[:n], data=d), nb)

    def ref(n, d):
        sh = jax_block_sharding(jax_mesh(jax.devices()[:n], data=d), nb)
        return _Sharding([(_Dev(dev.id), idx[0] if idx else slice(None))
                          for dev, idx in sh.devices_indices_map((nb, 4)).items()])

    got = T.plan_moves(ours(*old), ours(*new), (nb, 4), 4, unit=lambda s: s.index)
    want = J.plan_moves(ref(*old), ref(*new), (nb, 4), 4)
    assert same_plan(got, want)


CASES = {
    "f32": (np.float32, torch.float32),
    "int32": (np.int32, torch.int32),
    "bf16": (jnp.bfloat16, torch.bfloat16),
}


def frame_of(parts):
    head, body = parts
    return bytes(head) + bytes(body)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_frames_are_the_references_bytes_both_ways(kind):
    np_dt, t_dt = CASES[kind]
    rng = np.random.default_rng(4)
    host = (rng.standard_normal((16, 3)) * 100).astype(np.float32)
    ref_arr = host.astype(np_dt)
    ours = torch.as_tensor(host).to(t_dt) if kind != "int32" else torch.as_tensor(ref_arr)
    mine, theirs = frame_of(T._frame_parts(7, ours)), frame_of(J._frame_parts(7, ref_arr))
    assert mine == theirs
    # the port decodes the reference's frame, and the reference the port's
    b, t = T._unpack_frame(theirs)
    assert b == 7 and t.dtype == t_dt and t.shape == (16, 3)
    assert t.view(torch.int16 if kind == "bf16" else t.dtype).numpy().tobytes() == \
        ref_arr.tobytes()
    b, a = J._unpack_frame(mine)
    assert b == 7 and a.dtype == ref_arr.dtype and a.tobytes() == ref_arr.tobytes()
    # a host array goes through the port's codec as through the reference's
    if kind != "bf16":
        assert frame_of(T._frame_parts(7, ref_arr)) == theirs


def test_a_big_endian_frame_decodes_to_native_values():
    a = np.arange(12, dtype=">f4").reshape(3, 4)
    b, t = T._unpack_frame(frame_of(J._frame_parts(2, a)))
    np.testing.assert_array_equal(t.numpy(), a.astype("<f4"))


def test_a_truncated_frame_is_refused():
    frame = frame_of(T._frame_parts(1, torch.ones(4, 2)))
    for cut in (2, 10, len(frame) - 3):
        with pytest.raises(OSError, match="truncated"):
            T._unpack_frame(frame[:cut])
