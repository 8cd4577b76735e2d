"""Block moves between the processes of a pod (``table/blockmove.py``'s
cross-process route, ``table/table.py::reshard_array``) on the CPU.

* The plan by process is the reference's ``plan_moves`` on the reference's
  cases (``tests/test_blockmove.py``), on slots of several processes, and on
  random layouts: exact.
* Frames cross the packages on the wire: the port's sender into the
  reference's ``_TcpReceiver`` and the reference's ``_send_frame`` into the
  port's receiver, for f32, bf16, f16 and int32 (blocks, shapes and bytes
  exact).
* The transports' failure paths, as the reference's tests have them: a
  receiver times out naming the blocks it misses, a sender dying mid-frame
  fails within the timeout, stale staging is overwritten, and a staging
  failure on a source is a transport error in every process.
* The TCP legs, as the reference's ``tests/test_state_movement.py`` has
  them: parallel legs deliver the serial legs' bytes with the same wire
  count, a leg over ``_LEG_SPLIT_BYTES`` is striped over several streams
  (``_leg_streams`` partitions each destination's frames), a leg that fails
  once on a pool thread is retried, and one that gives up raises
  ``MigrationTransportError``; ``_run_pooled`` keeps item order, raises the
  first failure and skips what was queued behind it.
* Two and three processes over a gloo world on a ``FileStore``, several CPU
  slots each (``SCRIPT``), with both transports: a 24-block dense table and
  a hash table's (slot_keys, values) pair move between layouts that differ
  by 4 blocks a process, and a table drains onto one process's executor and
  grows back over every process (``TableHandle.move_blocks`` and
  ``rebalance``). After every move each process's own shards are the
  one-slot table's bytes (compared by SHA-256), and each process's wire
  bytes are its moved blocks times ``block_nbytes``, as
  ``tests/test_multihost.py`` expects of the reference. No
  ``harmony-move-*`` directory is left behind.

Every child process has a deadline and is killed in a ``finally``; each pod
runs once a module.
"""
import glob
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from harmony_tpu.table import blockmove as J
from harmony_tpu_torch.parallel.mesh import Slot, build_mesh
from harmony_tpu_torch.table import blockmove as T
from harmony_tpu_torch.table.table import BlockSharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 180


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the plan by process ---------------------------------------------------


class _Dev:
    def __init__(self, pid):
        self.process_index = pid


class _Sharding:
    def __init__(self, dev_slices):
        self._m = {d: (sl,) for d, sl in dev_slices}

    def devices_indices_map(self, shape):
        return self._m


def _sh(*pid_ranges):
    return _Sharding([(_Dev(pid), slice(a, b)) for pid, a, b in pid_ranges])


def same_plan(a, b):
    return (a.sends == b.sends and a.recvs == b.recvs
            and a.block_nbytes == b.block_nbytes and a.total_moves == b.total_moves)


CASES = {
    "shrink": (((0, 0, 6), (1, 6, 12)), ((0, 0, 12),)),
    "grow": (((0, 0, 12),), ((0, 0, 6), (1, 6, 12))),
    "covered": (((0, 0, 6), (1, 6, 12)), ((0, 0, 6), (1, 6, 12))),
    "replicated-target": (((0, 0, 6), (1, 6, 12)), ((0, 0, 12), (1, 0, 12), (2, 0, 12))),
    "lowest-pid-owner": (((0, 0, 12), (1, 0, 12)), ((2, 0, 12),)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_plan_by_process_is_the_references(case):
    old, new = CASES[case]
    shape = (12, 4, 3)
    o, n = _sh(*old), _sh(*new)
    assert same_plan(T.plan_moves(o, n, shape, 4), J.plan_moves(o, n, shape, 4))
    assert T.block_owners(o, shape) == J.block_owners(o, shape)


def test_an_uncovered_old_layout_raises_as_the_references():
    o, n = _sh((0, 0, 6)), _sh((1, 0, 12))
    for planner in (J, T):
        with pytest.raises(ValueError, match="no owner"):
            planner.plan_moves(o, n, (12, 4), 8)


def _pod_slots(counts):
    """Global slots: ``counts[p]`` CPU slots in process p."""
    cpu = torch.device("cpu")
    procs = [p for p, c in enumerate(counts) for _ in range(c)]
    return [Slot(i, cpu, p) for i, p in enumerate(procs)]


def _as_reference(sharding: BlockSharding):
    return _sh(*[(s.process_index, r[0].start, r[0].stop)
                 for s, r in sharding.devices_indices_map((sharding.num_blocks,)).items()])


@pytest.mark.parametrize("counts,old_take,new_take", [
    ((4, 4), slice(None), slice(0, 6)),
    ((2, 2, 2), slice(None), slice(2, None)),
    ((4, 4), slice(0, 4), slice(None)),
    ((2, 2, 2), slice(0, 3), slice(3, 6)),
])
def test_plans_over_slots_of_several_processes_are_the_references(counts, old_take, new_take):
    slots = _pod_slots(counts)
    for nb in (12, 24):
        old = BlockSharding(build_mesh(slots[old_take], data=1), nb)
        new = BlockSharding(build_mesh(slots[new_take], data=1), nb)
        shape = (nb, 4)
        assert same_plan(T.plan_moves(old, new, shape, 4),
                         J.plan_moves(_as_reference(old), _as_reference(new), shape, 4))
        assert T.spans_processes(old, new)


def test_random_layouts_by_process_plan_the_references_moves():
    rng = np.random.default_rng(23)
    for _ in range(200):
        nb = int(rng.choice([6, 12, 24]))
        nprocs = int(rng.integers(1, 6))

        def layout():
            dev_slices = []
            for p in range(nprocs):
                a = int(rng.integers(nb))
                dev_slices.append((p, a, int(rng.integers(a + 1, nb + 1))))
            for blk in range(nb):
                if not any(a <= blk < b for _, a, b in dev_slices):
                    dev_slices.append((int(rng.integers(nprocs)), blk, blk + 1))
            return _sh(*dev_slices)

        o, n = layout(), layout()
        assert same_plan(T.plan_moves(o, n, (nb, 4), 4), J.plan_moves(o, n, (nb, 4), 4))


# -- frames on the wire, across the packages ---------------------------------


DTYPES = {"f32": (torch.float32, np.float32), "f16": (torch.float16, np.float16),
          "int32": (torch.int32, np.int32), "bf16": (torch.bfloat16, None)}


def _block(kind, b):
    tdt, _ = DTYPES[kind]
    g = torch.Generator().manual_seed(b)
    x = torch.randn((4, 3), generator=g) * 100
    return x.to(tdt)


def _as_numpy(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _raw(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


@pytest.mark.parametrize("kind", sorted(DTYPES))
def test_the_ports_frames_land_in_the_references_receiver(kind):
    blocks = {b: _block(kind, b) for b in (3, 5, 9)}
    rx = J._TcpReceiver(set(blocks))
    try:
        with socket.create_connection(("127.0.0.1", rx.port), timeout=10) as s:
            for b, t in blocks.items():
                T._send_frame(s, b, t)
        got = rx.wait(time.monotonic() + 30)
    finally:
        rx.close()
    assert sorted(got) == sorted(blocks)
    for b, t in blocks.items():
        assert tuple(got[b].shape) == tuple(t.shape)
        assert got[b].tobytes() == _raw(t)
        if kind == "bf16":
            assert got[b].dtype.name == "bfloat16"


@pytest.mark.parametrize("kind", sorted(DTYPES))
def test_the_references_frames_land_in_the_ports_receiver(kind):
    blocks = {b: _block(kind, b) for b in (0, 7, 8)}
    rx = T._TcpReceiver(set(blocks))
    try:
        with socket.create_connection(("127.0.0.1", rx.port), timeout=10) as s:
            for b, t in blocks.items():
                J._send_frame(s, b, _as_numpy(t))
        got = rx.wait(time.monotonic() + 30)
    finally:
        rx.close()
    assert sorted(got) == sorted(blocks)
    for b, t in blocks.items():
        assert got[b].dtype == t.dtype and tuple(got[b].shape) == tuple(t.shape)
        assert _raw(got[b]) == _raw(t)


# -- the transports' failure paths -------------------------------------------


def test_the_receiver_times_out_naming_the_missing_blocks(monkeypatch):
    monkeypatch.setenv("HARMONY_POD_MOVE_TIMEOUT", "1")
    rx = T._TcpReceiver({1, 2, 3})
    try:
        with socket.create_connection(("127.0.0.1", rx.port), timeout=10) as s:
            T._send_frame(s, 2, torch.zeros(2, 2))
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match=r"2 inbound blocks missing.*\[1, 3\]"):
            rx.wait(time.monotonic() + 1.0)
        assert time.monotonic() - t0 < 5
        assert sorted(rx.blocks) == [2]
    finally:
        rx.close()


def test_a_sender_dying_mid_frame_fails_within_the_timeout(monkeypatch):
    rx = T._TcpReceiver({0, 1})
    rx.ERR_GRACE = 0.5
    try:
        s = socket.create_connection(("127.0.0.1", rx.port), timeout=10)
        T._send_frame(s, 0, torch.ones(3))
        head, body = T._frame_parts(1, torch.ones(64))
        s.sendall(head + bytes(body)[:10])   # half a frame, then the sender dies
        s.close()
        t0 = time.monotonic()
        with pytest.raises(OSError, match="truncated block 1"):
            rx.wait(time.monotonic() + 20)
        assert time.monotonic() - t0 < 5
    finally:
        rx.close()


def test_stale_staging_is_overwritten_and_removed(monkeypatch, tmp_path):
    """A crashed earlier move left files under the same names: the source
    writes over them, the reader gets the new bytes, and the staging is
    removed (one process plays source and reader, its fences trivial)."""
    monkeypatch.setenv("HARMONY_POD_STAGE_ROOT", str(tmp_path))
    monkeypatch.setattr(T, "_fence", lambda union, failed: int(failed))
    stage = tmp_path / "harmony-move-t0"
    stage.mkdir()
    (stage / "b4.blk").write_bytes(b"stale bytes")
    (stage / "b4.blk.writing-0").write_bytes(b"stale")
    fresh = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    plan = T.MovePlan({0: [(4, 0)]}, {0: {4}}, 24)
    got, written = T._file_exchange(plan, {4: fresh}, {4}, "t0", (0,), [0])
    assert written == 24 and torch.equal(got[4], fresh)
    assert not glob.glob(str(tmp_path / "harmony-move-*"))


def test_a_failed_source_is_a_transport_error_and_the_staging_goes(monkeypatch, tmp_path):
    """A source whose writes fail reports through the fence: every process
    raises, and the lowest one removes the staging."""
    monkeypatch.setenv("HARMONY_POD_STAGE_ROOT", str(tmp_path))
    monkeypatch.setenv("HARMONY_RETRY_MAX_ATTEMPTS", "2")
    monkeypatch.setenv("HARMONY_RETRY_BASE_DELAY", "0.01")
    monkeypatch.setattr(T, "_fence", lambda union, failed: 1)   # a peer failed too

    def broken(block, arr):
        raise OSError("disk gone")

    monkeypatch.setattr(T, "_frame_parts", broken)
    plan = T.MovePlan({0: [(1, 1)]}, {1: {1}}, 8)
    with pytest.raises(T.MigrationTransportError, match="disk gone"):
        T._file_exchange(plan, {1: torch.zeros(2)}, set(), "t1", (0, 1), [0])
    assert not glob.glob(str(tmp_path / "harmony-move-*"))
    # a process whose own writes went well learns of the peer's failure
    monkeypatch.setattr(T, "_frame_parts", J._frame_parts)
    with pytest.raises(T.MigrationTransportError, match="failed on a source process"):
        T._file_exchange(T.MovePlan({1: [(1, 0)]}, {0: {1}}, 8), {}, {1}, "t2", (0, 1), [0])
    assert not glob.glob(str(tmp_path / "harmony-move-*"))


def test_the_tcp_transport_needs_the_pods_store():
    with pytest.raises(RuntimeError, match="HARMONY_POD_BLOCKMOVE=file"):
        T._tcp_exchange(T.MovePlan({}, {}, 4), {}, set(), "t", [], [0])


# -- the legs: striping and the pool ----------------------------------------

def _payload(b, rows=16, dim=8):
    return torch.arange(rows * dim, dtype=torch.float32).reshape(rows, dim) + 31 * b


def _multi_peer_exchange(monkeypatch, parallel, tag, nb=12):
    """Process 0 sends ``nb`` frames, even ones to process 1 and odd ones to
    process 2, whose receivers run in this process with their addresses in an
    in-process store. Returns ({dst: {frame: tensor}}, wire bytes, legs,
    retries)."""
    from harmony_tpu_torch.parallel import multihost

    monkeypatch.setenv("HARMONY_MOVE_PARALLEL", str(parallel))
    store = torch.distributed.HashStore()
    monkeypatch.setattr(multihost, "store", lambda: store)
    expected = {1: {b for b in range(nb) if b % 2 == 0}, 2: {b for b in range(nb) if b % 2 == 1}}
    rxs = {dst: T._TcpReceiver(frames) for dst, frames in expected.items()}
    for dst, rx in rxs.items():
        store.set(f"harmony/blockmove/{tag}/{dst}", f"127.0.0.1:{rx.port}")
    outgoing = {b: _payload(b) for b in range(nb)}
    plan = T.MovePlan({0: [(b, 1 + b % 2) for b in range(nb)]}, expected,
                      outgoing[0].numel() * 4)
    legs, retries = [], [0]
    try:
        _, sent = T._tcp_exchange(plan, outgoing, set(), tag, legs, retries)
        got = {dst: dict(rx.wait(time.monotonic() + 20)) for dst, rx in rxs.items()}
    finally:
        for rx in rxs.values():
            rx.close()
    return got, sent, legs, retries[0]


def _all_bytes(nb=12):
    return sum(_payload(b).numel() * 4 for b in range(nb))


def test_parallel_legs_deliver_the_serial_legs_bytes(monkeypatch):
    serial, sent_1, legs_1, _ = _multi_peer_exchange(monkeypatch, 1, "serial")
    parallel, sent_4, legs_4, _ = _multi_peer_exchange(monkeypatch, 4, "parallel")
    assert sent_1 == sent_4 == _all_bytes()
    assert sorted(leg["dst"] for leg in legs_1) == sorted(leg["dst"] for leg in legs_4) == [1, 2]
    assert serial.keys() == parallel.keys() == {1, 2}
    for dst in serial:
        assert serial[dst].keys() == parallel[dst].keys()
        for b, t in serial[dst].items():
            assert torch.equal(t, parallel[dst][b]) and torch.equal(t, _payload(b))


def test_an_oversized_leg_is_striped_over_several_streams(monkeypatch):
    """With the split threshold forced to a byte, each destination's leg fans
    out over four connections; the receiver reassembles by frame id."""
    monkeypatch.setattr(T, "_LEG_SPLIT_BYTES", 1)
    got, sent, legs, _ = _multi_peer_exchange(monkeypatch, 4, "striped")
    for dst, frames in got.items():
        assert sorted(frames) == [b for b in range(12) if b % 2 == dst - 1]
        for b, t in frames.items():
            assert torch.equal(t, _payload(b))
    assert sent == _all_bytes()
    for dst in (1, 2):
        mine = [leg for leg in legs if leg["dst"] == dst]
        assert len(mine) == 4 and sum(leg["frames"] for leg in mine) == 6


def test_leg_streams_partition_each_destinations_frames():
    nbytes = {b: 32 for b in range(8)}
    by_dst = {2: [0, 1, 2, 3], 5: [4, 5, 6, 7]}
    # serial: one stream a destination, in destination order
    assert T._leg_streams(by_dst, nbytes, 1) == [(2, [0, 1, 2, 3]), (5, [4, 5, 6, 7])]
    # under the split threshold a leg stays whole at any parallelism
    assert T._leg_streams(by_dst, nbytes, 3) == [(2, [0, 1, 2, 3]), (5, [4, 5, 6, 7])]
    old = T._LEG_SPLIT_BYTES
    T._LEG_SPLIT_BYTES = 1
    try:
        legs = T._leg_streams(by_dst, nbytes, 3)
    finally:
        T._LEG_SPLIT_BYTES = old
    for dst, frames in by_dst.items():
        stripes = [fs for d, fs in legs if d == dst]
        assert len(stripes) == 3
        assert sorted(f for st in stripes for f in st) == frames


def _flaky_connections(monkeypatch, fail):
    """``socket.create_connection`` as blockmove calls it, raising for the
    calls ``fail(n)`` picks (n counts every call from 0)."""
    real = socket.create_connection
    calls = [0]
    lock = threading.Lock()

    def connect(*args, **kwargs):
        with lock:
            n = calls[0]
            calls[0] += 1
        if fail(n):
            raise ConnectionResetError("injected link flap")
        return real(*args, **kwargs)

    monkeypatch.setattr(T.socket, "create_connection", connect)


def test_a_leg_that_fails_once_on_a_pool_thread_is_retried(monkeypatch):
    monkeypatch.setenv("HARMONY_RETRY_MAX_ATTEMPTS", "3")
    monkeypatch.setenv("HARMONY_RETRY_BASE_DELAY", "0.001")
    monkeypatch.setenv("HARMONY_RETRY_MAX_DELAY", "0.002")
    _flaky_connections(monkeypatch, lambda n: n == 0)
    got, sent, legs, retries = _multi_peer_exchange(monkeypatch, 4, "flap")
    assert retries == 1 and len(legs) == 2
    for dst, frames in got.items():
        for b, t in frames.items():
            assert torch.equal(t, _payload(b))
    assert sent == _all_bytes()      # the frames' bytes, not the retransmits


def test_a_leg_that_gives_up_on_a_pool_thread_raises_the_transport_error(monkeypatch):
    from harmony_tpu_torch.parallel import multihost

    monkeypatch.setenv("HARMONY_MOVE_PARALLEL", "4")
    monkeypatch.setenv("HARMONY_RETRY_MAX_ATTEMPTS", "2")
    monkeypatch.setenv("HARMONY_RETRY_BASE_DELAY", "0.001")
    monkeypatch.setenv("HARMONY_RETRY_MAX_DELAY", "0.002")
    store = torch.distributed.HashStore()
    monkeypatch.setattr(multihost, "store", lambda: store)
    for dst in (1, 2):
        store.set(f"harmony/blockmove/down/{dst}", "127.0.0.1:9")
    _flaky_connections(monkeypatch, lambda n: True)
    payload = torch.ones(2, 2)
    plan = T.MovePlan({0: [(0, 1), (1, 2)]}, {1: {0}, 2: {1}}, 16)
    t0 = time.monotonic()
    with pytest.raises(T.MigrationTransportError, match="injected link flap") as err:
        T._tcp_exchange(plan, {0: payload, 1: payload}, set(), "down", [], [0])
    assert err.value.infra_suspect and time.monotonic() - t0 < 10


def test_the_pool_keeps_item_order_raises_the_first_failure_and_skips_the_rest():
    assert T._run_pooled(list(range(9)), lambda i: i * i, 4, "t") == [i * i for i in range(9)]
    ran = []
    lock = threading.Lock()

    def fn(i):
        with lock:
            ran.append(i)
        if i == 1:
            raise ValueError("item 1")
        time.sleep(0.05)
        if i == 3:
            raise ValueError("item 3")
        return i

    with pytest.raises(ValueError, match="item 1"):
        T._run_pooled(list(range(40)), fn, 2, "t")
    assert len(ran) < 40                  # the queued items were skipped
    ran.clear()
    with pytest.raises(ValueError, match="item 1"):
        T._run_pooled(list(range(40)), fn, 1, "t")
    assert ran == [0, 1]                  # serial: in order, stopping at the failure


# -- moves between processes ------------------------------------------------


# Each process of a gloo world on a FileStore, ``per`` CPU slots each.
SCRIPT = r'''
import hashlib, json, sys
import numpy as np, torch
torch.set_num_threads(1)
from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.parallel import multihost
from harmony_tpu_torch.parallel.mesh import DevicePool, build_mesh, is_local
from harmony_tpu_torch.runtime.master import ETMaster
from harmony_tpu_torch.table import blockmove
from harmony_tpu_torch.table.hashtable import DeviceHashTable, HashTableSpec
from harmony_tpu_torch.table.table import DenseTable, ShardedArray, TableSpec

store, n, pid, per = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
assert multihost.initialize_distributed(store, n, pid, devices=["cpu"] * per)
slots = multihost.global_slots()
cpu = torch.device("cpu")


def digest(t):
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return hashlib.sha256(raw.contiguous().numpy().tobytes()).hexdigest()


def held(table, state):
    """slot -> parts of this process's shards."""
    if isinstance(state, ShardedArray):
        return {s: v if isinstance(v, tuple) else (v,) for s, v in state.shards.items()}
    (s,) = table.mesh.slots
    return {s: state if isinstance(state, tuple) else (state,)} if is_local(s) else {}


def check(table, state, ref, errors, tag):
    """Every shard this process holds is the one-slot table's blocks, by
    SHA-256; returns the blocks held."""
    blocks = set()
    for s, parts in held(table, state).items():
        r = table.sharding.slot_blocks(s)
        for part, whole in zip(parts, ref):
            if digest(part) != digest(whole[r.start:r.stop]):
                errors.append(f"{tag}: slot {s.index} blocks {r.start}-{r.stop}")
        blocks.update(r)
    return sorted(blocks)


out = {"pid": pid, "transport": blockmove._transport_mode()}
errors = []
# a 24-block dense table between layouts that differ by 4 blocks a process
# (the reference's blockstats phase), then a hash table's pair the same way
mesh_a = build_mesh(slots, data=1)
mesh_b = build_mesh(slots[2:] if n == 3 else slots[:6], data=1)
cfg = TableConfig(table_id="bstats", capacity=96, value_shape=(5,), num_blocks=24)
keys = np.arange(96)
vals = np.arange(5, dtype=np.float32)[None, :] + keys[:, None] * 10.0
t = DenseTable(TableSpec(cfg), mesh_a)
t.multi_put(keys, vals)
one = DenseTable(TableSpec(cfg), cpu)
one.multi_put(keys, vals)
ref = (one.array,)
out["block_bytes"] = 4 * 5 * 4
out["table_bytes"] = 24 * out["block_bytes"]
check(t, t.array, ref, errors, "before")
t.reshard(mesh_b)
out["shrink"] = dict(blockmove.last_move_stats)
out["shrink_blocks"] = check(t, t.array, ref, errors, "shrunk")
t.reshard(mesh_a)
out["grow"] = dict(blockmove.last_move_stats)
out["grow_blocks"] = check(t, t.array, ref, errors, "regrown")
hcfg = TableConfig(table_id="bshash", capacity=256, value_shape=(2,), num_blocks=8, sparse=True)
hkeys = np.arange(1, 41, dtype=np.int64)
hvals = np.stack([[k * 2.0, k * 3.0] for k in hkeys]).astype(np.float32)
ht = DeviceHashTable(HashTableSpec(hcfg), mesh_a)
ht.multi_put(hkeys, hvals)
hone = DeviceHashTable(HashTableSpec(hcfg), cpu)
hone.multi_put(hkeys, hvals)
href = hone.state
ht.reshard(mesh_b)
out["hash_shrink"] = dict(blockmove.last_move_stats)
out["hash_shrink_blocks"] = check(ht, ht.state, href, errors, "hash shrunk")
if pid in mesh_b.processes:
    if not np.array_equal(ht.multi_get(hkeys), hvals):
        errors.append("hash shrunk: a lookup differs")
ht.reshard(mesh_a)
out["hash_grow_blocks"] = check(ht, ht.state, href, errors, "hash regrown")
if not np.array_equal(ht.multi_get(hkeys), hvals):
    errors.append("hash regrown: a lookup differs")
# the reference's reshard phase: drain every executor onto the first (the
# table ends on process 0 alone), then grow back over every executor
master = ETMaster(DevicePool(slots))
execs = [e.id for e in master.add_executors(len(slots))]
dcfg = TableConfig(table_id="pdense", capacity=96, value_shape=(3,), num_blocks=12)
dvals = np.stack([np.arange(3, dtype=np.float32) + k * 10.0 for k in range(96)])
table = master.create_table(dcfg, execs)
table.multi_put(np.arange(96), dvals)
done = DenseTable(TableSpec(dcfg), cpu)
done.multi_put(np.arange(96), dvals)
handle = master.table_handle(table.spec.table_id)
moved = 0
for e in execs[1:]:
    k = handle.block_manager.block_counts().get(e, 0)
    if k:
        handle.move_blocks(e, execs[0], k)
        moved += k
out["moved"] = moved
out["owners_after"] = len(handle.owning_executors())
out["drained_blocks"] = check(table, table.array, (done.array,), errors, "drained")
handle.rebalance(execs)
out["owners_regrown"] = len(handle.owning_executors())
out["regrown_blocks"] = check(table, table.array, (done.array,), errors, "regrown")
out["drain_transport"] = blockmove.last_move_stats.get("transport")
out["ok"] = not errors
out["errors"] = errors[:5]
multihost.shutdown_distributed()
print("RESULT " + json.dumps(out), flush=True)
'''


def _run(tmp, n, per, env):
    full = dict(os.environ, OMP_NUM_THREADS="1", HARMONY_POD_UNIT_TIMEOUT="60",
                HARMONY_POD_MOVE_TIMEOUT="60", **env)
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT, f"file://{tmp}/store", str(n),
                               str(p), str(per)],
                              cwd=REPO, env=full, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for p in range(n)]
    outs = []
    try:
        deadline = time.monotonic() + DEADLINE
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, err[-3000:]
            lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert lines, out[-2000:]
            outs.append(json.loads(lines[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return sorted(outs, key=lambda r: r["pid"])


@pytest.fixture(scope="module", params=["tcp", "file"])
def two(request, tmp_path_factory):
    """SCRIPT on 2 processes x 4 slots over the transport."""
    tmp = tmp_path_factory.mktemp(f"two-{request.param}")
    stage = tmp / "stage"
    stage.mkdir()
    env = {"HARMONY_POD_BLOCKMOVE": request.param}
    if request.param == "file":
        env["HARMONY_POD_STAGE_ROOT"] = str(stage)
    return request.param, _run(str(tmp), 2, 4, env), str(stage)


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    """SCRIPT on 3 processes x 2 slots over TCP."""
    tmp = tmp_path_factory.mktemp("three")
    return _run(str(tmp), 3, 2, {"HARMONY_POD_BLOCKMOVE": "tcp"})


def test_two_processes_move_a_dense_table_byte_exact_with_only_the_moved_bytes(two):
    transport, results, stage = two
    for r in results:
        assert r["ok"], r
    bb, table_bytes = results[0]["block_bytes"], results[0]["table_bytes"]
    # mesh_a: process 0 blocks 0-11, process 1 12-23; mesh_b (6 slots):
    # process 0 0-15, process 1 16-23: 4 blocks cross each way
    for direction in ("shrink", "grow"):
        for r in results:
            st = r[direction]
            assert st["transport"] == transport and st["block_nbytes"] == bb, st
            assert st["total_moves"] == 4, st
            assert st["bytes_sent"] + st["bytes_received"] == 4 * bb, st
            assert st["bytes_sent"] + st["bytes_received"] < table_bytes / 4, st
        senders = [r["pid"] for r in results if r[direction]["bytes_sent"]]
        receivers = [r["pid"] for r in results if r[direction]["bytes_received"]]
        assert len(senders) == 1 and len(receivers) == 1 and senders != receivers
    assert results[0]["shrink_blocks"] == list(range(16))
    assert results[1]["shrink_blocks"] == list(range(16, 24))
    assert not glob.glob(os.path.join(stage, "harmony-move-*"))


def test_two_processes_move_a_hash_tables_pair_over_the_same_transport(two):
    transport, results, _ = two
    for r in results:
        assert r["ok"], r
        st = r["hash_shrink"]
        assert st["transport"] == transport, st
        # 8 blocks over 6 slots replicate: each process takes the other's
        # 4 blocks, the slot keys and values of each in one exchange
        assert st["total_moves"] == 8 and st["blocks_received"] == 4, st
        assert st["bytes_received"] == 4 * st["block_nbytes"], st
        assert r["hash_shrink_blocks"] == list(range(8))
        assert r["hash_grow_blocks"] == list(range(4 * r["pid"], 4 * r["pid"] + 4))


def test_a_table_drains_onto_one_process_and_grows_back_byte_exact(two):
    transport, results, stage = two
    for r in results:
        assert r["ok"], r
        assert r["moved"] > 0 and r["owners_after"] == 1 and r["owners_regrown"] == 8, r
        assert r["drain_transport"] == transport
    # after the drain only process 0 holds blocks, every one of them
    assert results[0]["drained_blocks"] == list(range(12))
    assert results[1]["drained_blocks"] == []
    # after the grow every process holds the blocks again (12 blocks over 8
    # owners: replicated on every slot, as the reference's block_sharding)
    assert all(r["regrown_blocks"] == list(range(12)) for r in results)
    assert not glob.glob(os.path.join(stage, "harmony-move-*"))


def test_three_processes_move_follower_to_follower(three):
    for r in three:
        assert r["ok"], r
    by = {r["pid"]: r for r in three}
    bb = three[0]["block_bytes"]
    # mesh_a (6 slots): process 0 blocks 0-7, 1 8-15, 2 16-23; mesh_b (the
    # slots of processes 1 and 2): 1 0-11, 2 12-23
    sh = {p: by[p]["shrink"] for p in range(3)}
    assert all(s["total_moves"] == 12 for s in sh.values()), sh
    assert sh[0]["bytes_sent"] == 8 * bb and sh[0]["bytes_received"] == 0
    assert sh[1]["bytes_sent"] == 4 * bb and sh[1]["bytes_received"] == 8 * bb
    assert sh[2]["bytes_sent"] == 0 and sh[2]["bytes_received"] == 4 * bb
    assert sh[1]["blocks_sent"] == 4 and sh[1]["blocks_received"] == 8
    gr = {p: by[p]["grow"] for p in range(3)}
    assert gr[0]["bytes_received"] == 8 * bb and gr[0]["bytes_sent"] == 0
    assert gr[1]["bytes_sent"] == 8 * bb and gr[1]["bytes_received"] == 4 * bb
    assert gr[2]["bytes_sent"] == 4 * bb and gr[2]["bytes_received"] == 0
    assert by[0]["shrink_blocks"] == []
    assert sum(s["bytes_sent"] for s in sh.values()) == 12 * bb < three[0]["table_bytes"]


def test_a_collectives_result_reaches_the_host_only_once_delivered():
    """NCCL hands a host tensor's all-gather back from the card: that copy
    must block, or a barrier (``mesh_sum``, the file transport's fences)
    reads the result before the collective has delivered it. A copy onto a
    card stays asynchronous, ordered on its stream."""
    from harmony_tpu_torch.parallel import collectives

    class FromCard:
        device = torch.device("cuda", 0)

        def __init__(self):
            self.calls = []

        def to(self, device, non_blocking=False):
            self.calls.append((device.type, non_blocking))
            return self

    got = FromCard()
    collectives._back(got, torch.device("cpu"))
    collectives._back(got, torch.device("cuda", 1))
    assert got.calls == [("cpu", False), ("cuda", True)]
    host = torch.zeros(2)
    assert collectives._back(host, torch.device("cpu")) is host
