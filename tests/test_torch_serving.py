"""harmony_tpu_torch's serving plane against harmony_tpu's, on the CPU.

The same numpy values (from a seed) go into a table of each package, and
the same framed lookups go to each package's ``ServingEndpoint``: the rows
and their metadata must be equal byte for byte, in each of the four arms
(batch window 0 or 5 ms, cache off or on) and in pinned mode over a chain
written by either package. The two packages' frames are byte-identical, and
their decoders refuse the same broken streams with the same errors. The
port's own cases follow the reference's ``tests/test_serving.py``:
coalescing, no blending of per-request rows, the cache's hits and its
invalidation, the pin's roll-forward, busy frames, and error frames that
keep the connection. Where the two packages differ on purpose (a hash
table's pinned reads, a hash table's data version) both behaviours are
pinned here. Every socket binds port 0 and has a timeout; fixtures stop
every endpoint. Exact comparisons throughout: serving moves bytes.
"""
import socket
import struct
import threading
import time

import jax
import numpy as np
import pytest
import torch

from harmony_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from harmony_tpu.config.params import TableConfig as JaxTableConfig
from harmony_tpu.parallel import DevicePool as JaxDevicePool
from harmony_tpu.parallel import build_mesh
from harmony_tpu.runtime import ETMaster as JaxETMaster
from harmony_tpu.serving import ServingEndpoint as JaxEndpoint
from harmony_tpu.serving import protocol as jax_protocol
from harmony_tpu.table.hashtable import DeviceHashTable as JaxHashTable
from harmony_tpu.table.hashtable import HashTableSpec as JaxHashSpec
from harmony_tpu.table.table import DenseTable as JaxDenseTable
from harmony_tpu.table.table import TableSpec as JaxTableSpec
from harmony_tpu_torch.checkpoint import CheckpointManager
from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.runtime.master import ETMaster, TableHandle
from harmony_tpu_torch.serving import ServingEndpoint, protocol
from harmony_tpu_torch.serving import service
from harmony_tpu_torch.table.hashtable import DeviceHashTable, HashTableSpec
from harmony_tpu_torch.table.table import DenseTable, TableSpec

TIMEOUT = 20.0
CAPACITY, WIDTH, BLOCKS = 64, 4, 4


@pytest.fixture()
def mesh1():
    return build_mesh(jax.devices()[:1])


def _dense_pair(mesh, seed=0, table_id="srv-t"):
    """A dense table of each package holding the same values."""
    kw = dict(table_id=table_id, capacity=CAPACITY, value_shape=(WIDTH,),
              num_blocks=BLOCKS)
    keys = np.arange(CAPACITY, dtype=np.int32)
    vals = np.random.default_rng(seed).standard_normal((CAPACITY, WIDTH)).astype(np.float32)
    ref = JaxDenseTable(JaxTableSpec(JaxTableConfig(**kw)), mesh)
    ref.multi_put(keys, vals)
    mine = DenseTable(TableSpec(TableConfig(**kw)), "cpu")
    mine.multi_put(keys, vals)
    return mine, ref, keys


def _hash_pair(mesh, seed=0):
    """A hash table of each package with the same keys inserted in the same
    order (so the same slots), from the whole int32 key domain."""
    kw = dict(table_id="srv-h", capacity=512, value_shape=(WIDTH,), num_blocks=4,
              is_ordered=False, update_fn="add", sparse=True)
    rng = np.random.default_rng(seed)
    keys = (rng.choice(2**31 - 4, size=200, replace=False) + 1).astype(np.int32)
    vals = rng.standard_normal((200, WIDTH)).astype(np.float32)
    ref = JaxHashTable(JaxHashSpec(JaxTableConfig(**kw)), mesh)
    ref.multi_put(keys, vals)
    mine = DeviceHashTable(HashTableSpec(TableConfig(**kw)), "cpu")
    mine.multi_put(keys, vals)
    return mine, ref, keys


class Endpoints:
    """Started endpoints, stopped at the end of the test."""

    def __init__(self):
        self.started = []

    def start(self, ep):
        ep.start()
        self.started.append(ep)
        return ep

    def stop(self):
        for ep in self.started:
            if isinstance(ep, JaxEndpoint) and ep._sock is not None:
                # wake the reference's accept loop, or its stop waits out a
                # 5 s join (the port's stop does this itself)
                ep._sock.shutdown(socket.SHUT_RDWR)
            ep.stop()


@pytest.fixture()
def endpoints():
    eps = Endpoints()
    yield eps
    eps.stop()


def _conn(port):
    sock = protocol.connect(("127.0.0.1", port), timeout=TIMEOUT)
    sock.settimeout(TIMEOUT)
    return sock


def _lookup(sock, rid, job, keys, mode="live"):
    protocol.send_arrays(sock, {"op": "lookup", "r": rid, "job": job, "mode": mode},
                         (np.asarray(keys),))
    return protocol.recv_frame(sock)


def _raw_lookup(port, rid, job, keys, mode="live"):
    sock = _conn(port)
    try:
        return _lookup(sock, rid, job, keys, mode)
    finally:
        sock.close()


def _same_frame(a, b):
    """Two decoded frames: equal headers, and payloads equal byte for byte."""
    ha = {k: v for k, v in a.items() if k != "data"}
    hb = {k: v for k, v in b.items() if k != "data"}
    assert ha == hb
    da, db = a.get("data", ()), b.get("data", ())
    assert len(da) == len(db)
    for x, y in zip(da, db):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


# -- the wire ------------------------------------------------------------------


def _wire_bytes(send):
    """The bytes ``send(sock)`` puts on a socket."""
    a, b = socket.socketpair()
    a.settimeout(TIMEOUT)
    b.settimeout(TIMEOUT)
    out = bytearray()
    try:
        reader = threading.Thread(target=lambda: out.extend(_drain(b)), daemon=True)
        reader.start()
        send(a)
        a.shutdown(socket.SHUT_WR)
        reader.join(TIMEOUT)
        assert not reader.is_alive()
    finally:
        a.close()
        b.close()
    return bytes(out)


def _drain(sock):
    chunks = []
    while True:
        c = sock.recv(1 << 20)
        if not c:
            return b"".join(chunks)
        chunks.append(c)


_RNG = np.random.default_rng(7)
MESSAGES = [
    ("ping", {"op": "ping"}, None),
    ("stats", {"op": "stats", "stats": {"port": 1, "tenants": {"j": {"p99_ms": 0.5}}}}, None),
    ("error", {"op": "error", "r": 3, "error": "LookupError: no live table for job 'x'"}, None),
    ("busy", {"op": "busy", "r": 9, "retry_after_ms": 120}, None),
    ("lookup", {"op": "lookup", "r": 1, "job": "j1", "mode": "live"},
     (np.array([3, 1, 2], np.int32),)),
    ("rows f32", {"op": "rows", "r": 1, "mode": "live", "layout_version": 0},
     (_RNG.standard_normal((5, 17)).astype(np.float32),)),
    ("rows f16 3-d", {"op": "rows", "r": 2, "mode": "pinned", "epoch": 4, "chkp": "j:m-1"},
     (_RNG.standard_normal((3, 2, 4)).astype(np.float16),)),
    ("two arrays", {"op": "rows", "r": 5}, (np.arange(4, dtype=np.int64),
                                            np.zeros((0, 3), np.float32))),
    # past IO_CHUNK: the sendmsg gather path
    ("large", {"op": "rows", "r": 8}, (_RNG.standard_normal((20000, 17)).astype(np.float32),)),
]


@pytest.mark.parametrize("name, header, arrays", MESSAGES, ids=[m[0] for m in MESSAGES])
def test_frames_are_byte_identical_to_the_references(name, header, arrays):
    def send(mod):
        if arrays is None:
            return lambda s: mod.send_msg(s, header)
        return lambda s: mod.send_arrays(s, header, arrays)

    mine = _wire_bytes(send(protocol))
    assert mine == _wire_bytes(send(jax_protocol))
    # and each package decodes the other's frame to the same message
    for enc, dec in ((protocol, jax_protocol), (jax_protocol, protocol)):
        a, b = socket.socketpair()
        a.settimeout(TIMEOUT)
        b.settimeout(TIMEOUT)
        try:
            threading.Thread(target=send(enc), args=(a,), daemon=True).start()
            got = dec.recv_frame(b)
        finally:
            a.close()
            b.close()
        want = dict(header)
        if arrays is not None:
            assert len(got["data"]) == len(arrays)
            for x, y in zip(got["data"], arrays):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
            want = {k: v for k, v in got.items() if k != "data"}
            assert {k: v for k, v in want.items() if k != "arrays"} == header
        else:
            assert got == want


def _head(obj):
    raw = obj if isinstance(obj, bytes) else __import__("json").dumps(
        obj, separators=(",", ":")).encode()
    return struct.pack("<I", len(raw)) + raw


BROKEN = [
    ("truncated payload", _head({"op": "rows", "arrays": [
        {"dtype": "<f4", "shape": [4], "n": 16}]}) + b"\x00" * 8),
    ("oversized header", struct.pack("<I", (1 << 20) + 1)),
    ("truncated header", struct.pack("<I", 40) + b"{}"),
    ("unparseable header", _head(b"{not json")),
    ("bad array header", _head({"op": "rows", "arrays": [{"dtype": "<f4"}]})),
    ("size mismatch", _head({"op": "rows", "arrays": [
        {"dtype": "<f4", "shape": [4], "n": 12}]}) + b"\x00" * 12),
    ("petabyte claim", _head({"op": "rows", "arrays": [
        {"dtype": "|u1", "shape": [1 << 50], "n": 1 << 50}]})),
    ("bad dtype", _head({"op": "rows", "arrays": [
        {"dtype": "nope", "shape": [1], "n": 4}]})),
]


@pytest.mark.parametrize("name, raw", BROKEN, ids=[b[0] for b in BROKEN])
def test_decode_errors_are_the_references(name, raw):
    errors = []
    for mod in (protocol, jax_protocol):
        a, b = socket.socketpair()
        b.settimeout(TIMEOUT)
        try:
            a.sendall(raw)
            a.shutdown(socket.SHUT_WR)
            with pytest.raises(mod.ProtocolError) as e:
                mod.recv_frame(b)
            assert isinstance(e.value, OSError)
            errors.append(str(e.value))
        finally:
            a.close()
            b.close()
    assert errors[0] == errors[1]


def test_clean_eof_before_a_header_is_none():
    a, b = socket.socketpair()
    b.settimeout(TIMEOUT)
    a.close()
    try:
        assert protocol.recv_frame(b) is None
    finally:
        b.close()


# -- live reads against the reference's endpoint ----------------------------------

ARMS = [(0.0, 0), (0.0, 8), (5.0, 0), (5.0, 8)]
ARM_IDS = ["window0-nocache", "window0-cache", "window5-nocache", "window5-cache"]


def _storm(port, job, key_sets, threads=4):
    """``threads`` readers on connections of their own, each sending its
    share of ``key_sets`` in order; returns the frames by key-set index."""
    out = [None] * len(key_sets)
    errors = []

    def reader(t):
        try:
            sock = _conn(port)
            try:
                for i in range(t, len(key_sets), threads):
                    out[i] = _lookup(sock, i + 1, job, key_sets[i])
            finally:
                sock.close()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    ts = [threading.Thread(target=reader, args=(t,), daemon=True) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    assert all(f is not None for f in out)
    return out


def _key_sets(rng, keys, n=24, per=6):
    """Reads of ``per`` keys, most from a hot head of 8 (cache hits)."""
    hot = keys[:8]
    return [np.concatenate([rng.choice(hot, per - 2), rng.choice(keys, 2)]).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("kind", ["dense", "hash"])
@pytest.mark.parametrize("window_ms, cache_mb", ARMS, ids=ARM_IDS)
def test_live_rows_and_meta_are_the_references(mesh1, endpoints, kind, window_ms, cache_mb):
    mine, ref, keys = (_dense_pair if kind == "dense" else _hash_pair)(mesh1)
    eps = [endpoints.start(cls(table_fn=lambda j, t=t: t if j == "j1" else None,
                               cache_mb=cache_mb, window_ms=window_ms))
           for cls, t in ((ServingEndpoint, mine), (JaxEndpoint, ref))]
    sets = _key_sets(np.random.default_rng(3), keys)
    if kind == "hash":  # absent keys read as init on both
        sets.append(np.array([5, 7, keys[0]], np.int32))
    got, want = (_storm(ep.port, "j1", sets) for ep in eps)
    for g, w, ks in zip(got, want, sets):
        assert g["op"] == "rows" and g["mode"] == "live" and g["layout_version"] == 0
        _same_frame(g, w)
        assert g["data"][0].tobytes() == mine.multi_get(ks).tobytes()
    s_mine, s_ref = (ep.stats() for ep in eps)
    assert set(s_mine) == set(s_ref)
    assert s_mine["errors"] == s_ref["errors"] == 0
    assert s_mine["tenants"]["j1"]["requests"] == len(sets)
    assert (s_mine["cache"] is None) == (cache_mb == 0)


def test_concurrent_lookups_coalesce_into_fewer_gathers(mesh1, endpoints):
    mine, _, keys = _dense_pair(mesh1)
    # a wide window: the 8 readers meet in it even on a loaded host
    ep = endpoints.start(ServingEndpoint(table_fn=lambda j: mine, cache_mb=0,
                                         window_ms=200.0))
    calls = []
    orig = mine.multi_get

    def counting(ks):
        calls.append(len(ks))
        return orig(ks)

    mine.multi_get = counting
    barrier = threading.Barrier(8)
    frames = [None] * 8

    def reader(i):
        sock = _conn(ep.port)
        try:
            barrier.wait(TIMEOUT)
            frames[i] = _lookup(sock, i, "j1", np.array([i, i + 8], np.int32))
        finally:
            sock.close()

    ts = [threading.Thread(target=reader, args=(i,), daemon=True) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in ts)
    for i, f in enumerate(frames):
        assert f["data"][0].tobytes() == orig([i, i + 8]).tobytes()
    assert len(calls) < 8                     # coalesced
    assert sum(calls) >= 16
    assert ep.stats()["batch_occupancy"] > 1.0


def test_a_batch_never_blends_per_request_rows(mesh1):
    """More threads than cores and a short switch interval: every lookup gets
    its own rows, and the batcher counts every request (no lost update)."""
    import sys

    mine, _, keys = _dense_pair(mesh1)
    ep = ServingEndpoint(table_fn=lambda j: mine, cache_mb=0, window_ms=2.0)
    rng = np.random.default_rng(11)
    sets = [rng.choice(keys, size=int(rng.integers(1, 9))).astype(np.int32) for _ in range(32)]
    out = [None] * len(sets)

    def call(i):
        for _ in range(4):
            out[i] = ep.lookup("j1", sets[i])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=call, args=(i,), daemon=True) for i in range(len(sets))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    for ks, (rows, meta) in zip(sets, out):
        assert rows.tobytes() == mine.multi_get(ks).tobytes()
        assert meta == {"mode": "live", "layout_version": 0}
    (batcher,) = ep._batchers.values()
    assert batcher.requests == 4 * len(sets)
    assert ep.stats()["tenants"]["j1"]["requests"] == 4 * len(sets)


def test_bucketed_gather_pads_with_the_first_key_and_returns_the_rows(mesh1):
    mine, _, _ = _dense_pair(mesh1)
    seen = []
    orig = mine.multi_get
    mine.multi_get = lambda ks: (seen.append(np.asarray(ks)), orig(ks))[1]
    ks = np.array([5, 9, 2], np.int32)
    rows = service._bucketed_multi_get(mine, ks)
    assert rows.tobytes() == orig(ks).tobytes()
    assert len(seen[0]) == 16 and (seen[0][3:] == 5).all()
    rows = service._bucketed_multi_get(mine, np.arange(32, dtype=np.int32))
    assert len(seen[1]) == 32 and rows.shape == (32, WIDTH)


# -- the cache -----------------------------------------------------------------


def test_repeat_lookups_hit_the_cache(mesh1):
    mine, _, _ = _dense_pair(mesh1)
    ep = ServingEndpoint(table_fn=lambda j: mine, cache_mb=8, window_ms=0.0)
    ks = np.array([1, 2, 3], np.int32)
    first, _ = ep.lookup("j1", ks)
    hits = ep.stats()["cache"]["hits"]
    again, _ = ep.lookup("j1", ks)
    assert again.tobytes() == first.tobytes()
    assert ep.stats()["cache"]["hits"] == hits + 3


@pytest.mark.parametrize("kind", ["dense", "hash"])
def test_a_training_write_retires_cached_rows(mesh1, kind):
    mine, _, keys = (_dense_pair if kind == "dense" else _hash_pair)(mesh1)
    ep = ServingEndpoint(table_fn=lambda j: mine, cache_mb=8, window_ms=0.0)
    ks = keys[:3].astype(np.int32)
    before, _ = ep.lookup("j1", ks)
    mine.multi_update(ks, np.ones((3, WIDTH), np.float32))
    after, _ = ep.lookup("j1", ks)
    assert after.tobytes() == mine.multi_get(ks).tobytes()
    np.testing.assert_array_equal(after, before + 1.0)


def test_the_references_hash_table_keeps_cached_rows_across_a_write(mesh1):
    """The reference's hash table has no ``data_version``: its endpoint keys
    cached rows by version 0 forever, so a cached row outlives a training
    write (a fault of the reference, not fixed there; ROADMAP C). The port's
    hash table counts its writes (the test above)."""
    _, ref, keys = _hash_pair(mesh1)
    assert not hasattr(ref, "data_version")
    ep = JaxEndpoint(table_fn=lambda j: ref, cache_mb=8, window_ms=0.0)
    ks = keys[:3].astype(np.int32)
    before, _ = ep.lookup("j1", ks)
    ref.multi_update(ks, np.ones((3, WIDTH), np.float32))
    stale, _ = ep.lookup("j1", ks)
    assert stale.tobytes() == before.tobytes()
    assert np.asarray(ref.multi_get(ks)).tobytes() != stale.tobytes()


@pytest.mark.parametrize("kind", ["dense", "hash"])
def test_a_layout_announcement_drops_the_jobs_live_rows(mesh1, kind):
    mine, _, keys = (_dense_pair if kind == "dense" else _hash_pair)(mesh1)
    ep = ServingEndpoint(table_fn=lambda j: mine, cache_mb=8, window_ms=0.0)
    ks = keys[:4].astype(np.int32)
    ep.lookup("j1", ks)
    assert ep.cache.stats()["entries"] == 4
    mine.announce_reshard(None)
    assert mine.layout_version == 1
    assert ep.cache.stats()["entries"] == 0
    rows, meta = ep.lookup("j1", ks)
    assert meta["layout_version"] == 1
    assert rows.tobytes() == mine.multi_get(ks).tobytes()
    ep.stop()   # unhooks its listener
    assert mine._layout_listeners == []


def test_layout_announcer_matches_the_references(mesh1):
    mine, ref, _ = _dense_pair(mesh1)
    for t in (mine, ref):
        seen = []
        bad = lambda target: 1 / 0  # noqa: E731 - a failing listener
        t.add_layout_listener(bad)
        t.add_layout_listener(seen.append)
        t.announce_reshard("target")
        t.remove_layout_listener(bad)
        t.remove_layout_listener(bad)
        t.announce_reshard("again")
        assert seen == ["target", "again"] and t.layout_version == 2


@pytest.mark.parametrize("window_ms", [0.0, 5.0])
def test_a_resubmitted_job_id_reads_its_new_table(mesh1, window_ms):
    """A job id submitted again gets a new table whose layout and data
    versions restart: the endpoint reads the new table, never the cached
    rows or the batcher of the dropped one, and moves its layout listener."""
    first, _, keys = _dense_pair(mesh1, seed=0)
    second, _, _ = _dense_pair(mesh1, seed=1)
    current = [first]
    ep = ServingEndpoint(table_fn=lambda j: current[0], cache_mb=8, window_ms=window_ms)
    ks = keys[:5]
    before, _ = ep.lookup("j1", ks)
    assert before.tobytes() == first.multi_get(ks).tobytes()
    assert (first.layout_version, first.data_version) == (
        second.layout_version, second.data_version)
    current[0] = second
    after, meta = ep.lookup("j1", ks)
    assert meta == {"mode": "live", "layout_version": 0}
    assert after.tobytes() == second.multi_get(ks).tobytes() != before.tobytes()
    assert first._layout_listeners == [] and len(second._layout_listeners) == 1
    assert len(ep._batchers) == 1
    again, _ = ep.lookup("j1", ks)
    assert again.tobytes() == after.tobytes()
    ep.stop()
    assert second._layout_listeners == []


def test_the_references_endpoint_reads_a_resubmitted_job_through_its_dropped_table(mesh1):
    """The reference keys its live batcher, listener and cached rows by the
    job id alone, so a job id submitted again is read from the earlier run's
    cached rows (a fault of the reference, not fixed there; ROADMAP C). The
    port's endpoint keys them by the table as well (the test above)."""
    _, first, keys = _dense_pair(mesh1, seed=0)
    _, second, _ = _dense_pair(mesh1, seed=1)
    current = [first]
    ep = JaxEndpoint(table_fn=lambda j: current[0], cache_mb=8, window_ms=0.0)
    ks = keys[:5]
    before, _ = ep.lookup("j1", ks)
    current[0] = second
    stale, _ = ep.lookup("j1", ks)
    assert stale.tobytes() == before.tobytes()
    assert np.asarray(second.multi_get(ks)).tobytes() != stale.tobytes()
    ep.stop()


# -- the read ordering -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "hash"])
def test_a_read_beside_a_step_gives_the_bytes_of_the_two_in_sequence(mesh1, kind):
    """A multi_get started while a step holds the table gives exactly the
    bytes a multi_get after the step gives: never a half-applied step."""
    mine, _, keys = (_dense_pair if kind == "dense" else _hash_pair)(mesh1)
    twin = (_dense_pair if kind == "dense" else _hash_pair)(mesh1)[0]
    ks = keys[:16].astype(np.int32)
    inside = threading.Event()

    def step(state, k):
        # two halves with a pause between: a reader that did not wait for the
        # lock would see the first half applied and not the second
        if kind == "dense":
            mine.spec.push(state, k[:8], torch.ones(8, WIDTH))
            inside.set()
            time.sleep(0.2)
            mine.spec.push(state, k[8:], torch.ones(8, WIDTH))
            return state, None
        state, tok = mine.spec.ensure(state, k)
        inside.set()
        time.sleep(0.2)
        return mine.spec.push(state, tok, torch.ones(16, WIDTH)), None

    def twin_step(state, k):
        if kind == "dense":
            return twin.spec.push(state, k, torch.ones(16, WIDTH)), None
        state, tok = twin.spec.ensure(state, k)
        return twin.spec.push(state, tok, torch.ones(16, WIDTH)), None

    got = {}
    t = threading.Thread(target=lambda: mine.apply_step(step, torch.as_tensor(ks)), daemon=True)
    t.start()
    assert inside.wait(TIMEOUT)
    got["rows"] = mine.multi_get(ks)   # concurrent with the step
    t.join(TIMEOUT)
    assert not t.is_alive()
    twin.apply_step(twin_step, torch.as_tensor(ks))
    assert got["rows"].tobytes() == twin.multi_get(ks).tobytes()
    assert mine.data_version == twin.data_version


def test_the_lock_is_not_held_while_the_rows_come_back(mesh1):
    """multi_get enqueues its gather under the lock and materialises it
    outside: the lock is free while the rows are copied to the host."""
    mine, _, _ = _dense_pair(mesh1)
    held = []

    class Probe(torch.Tensor):
        pass

    orig_pull = mine.spec.pull

    def pull(arr, k):
        rows = orig_pull(arr, k)
        probe = rows.as_subclass(Probe)
        probe.cpu = lambda: (held.append(mine._lock._is_owned()), rows.cpu())[1]
        return probe

    mine.spec.pull = pull
    mine.multi_get([1, 2])
    assert held == [False]


# -- pinned reads --------------------------------------------------------------


def _port_chain(root, job, epochs=2, seed=0):
    """A committed chain written by the port: entry e holds ``snapshots[e]``."""
    master = ETMaster(DevicePool([torch.device("cpu")]))
    ex = [e.id for e in master.add_executors(1)]
    cfg = TableConfig(table_id=f"{job}:m", capacity=32, value_shape=(2,), num_blocks=8)
    table = master.create_table(cfg, ex)
    mgr = CheckpointManager.for_job(root, job)
    rng = np.random.default_rng(seed)
    snaps = []
    for e in range(epochs):
        table.multi_update(list(range(32)), rng.standard_normal((32, 2)).astype(np.float32))
        snaps.append(table.multi_get(list(range(32))))
        mgr.checkpoint(TableHandle(master, table, ex), commit=True,
                       app_meta={"epoch": float(e)})
    return mgr, TableHandle(master, table, ex), snaps


def _ref_chain(root, job, epochs=2, seed=0):
    """The same chain written by the reference."""
    master = JaxETMaster(JaxDevicePool(jax.devices()[:2]))
    exs = master.add_executors(2)
    cfg = JaxTableConfig(table_id=f"{job}:m", capacity=32, value_shape=(2,), num_blocks=8)
    h = master.create_table(cfg, [e.id for e in exs])
    mgr = JaxCheckpointManager.for_job(root, job)
    rng = np.random.default_rng(seed)
    snaps = []
    for e in range(epochs):
        h.table.multi_update(list(range(32)), rng.standard_normal((32, 2)).astype(np.float32))
        snaps.append(np.asarray(h.table.multi_get(list(range(32)))))
        mgr.checkpoint(h, commit=True, app_meta={"epoch": float(e)})
    return mgr, h, snaps


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_pinned_reads_are_the_newest_committed_entrys_bits(tmp_path, endpoints, writer):
    _, h, snaps = (_port_chain if writer == "port" else _ref_chain)(str(tmp_path), "pj")
    # the live table moves on without a checkpoint: pinned must not see it
    h.table.multi_update(list(range(32)), np.ones((32, 2), np.float32))
    eps = [endpoints.start(cls(chkp_root=str(tmp_path), window_ms=0.0))
           for cls in (ServingEndpoint, JaxEndpoint)]
    keys = np.array([0, 7, 31, 7], np.int32)
    got, want = (_raw_lookup(ep.port, 1, "pj", keys, mode="pinned") for ep in eps)
    assert got["op"] == "rows" and got["mode"] == "pinned" and got["epoch"] == 1
    assert got["chkp"].startswith("pj:m-")
    _same_frame(got, want)
    assert got["data"][0].tobytes() == snaps[1][keys].tobytes()
    assert eps[0].stats()["tenants"]["pj"]["pinned_epoch"] == 1


def test_an_uncommitted_entry_never_pins(tmp_path, endpoints):
    mgr, h, snaps = _port_chain(str(tmp_path), "uj")
    h.table.multi_update(list(range(32)), np.ones((32, 2), np.float32))
    mgr.checkpoint(h, commit=False, app_meta={"epoch": 2.0})
    ep = endpoints.start(ServingEndpoint(chkp_root=str(tmp_path), window_ms=0.0))
    frame = _raw_lookup(ep.port, 1, "uj", np.array([0, 5], np.int32), mode="pinned")
    assert frame["epoch"] == 1       # the staged epoch 2 is invisible
    assert frame["data"][0].tobytes() == snaps[1][[0, 5]].tobytes()


def test_the_pin_rolls_forward_after_a_new_commit(tmp_path, endpoints, monkeypatch):
    mgr, h, _ = _port_chain(str(tmp_path), "rj")
    ep = endpoints.start(ServingEndpoint(chkp_root=str(tmp_path), window_ms=0.0))
    k = np.array([4], np.int32)
    assert _raw_lookup(ep.port, 1, "rj", k, mode="pinned")["epoch"] == 1
    h.table.multi_update(list(range(32)), np.ones((32, 2), np.float32))
    newest = h.table.multi_get(list(range(32)))
    mgr.checkpoint(h, commit=True, app_meta={"epoch": 2.0})
    # within the pin's TTL the resolved view stays
    assert _raw_lookup(ep.port, 2, "rj", k, mode="pinned")["epoch"] == 1
    monkeypatch.setattr(service, "_PIN_TTL_S", 0.0)
    frame = _raw_lookup(ep.port, 3, "rj", k, mode="pinned")
    assert frame["epoch"] == 2
    assert frame["data"][0].tobytes() == newest[4:5].tobytes()


def test_no_chain_is_an_error_frame(tmp_path, endpoints):
    ep = endpoints.start(ServingEndpoint(chkp_root=str(tmp_path), window_ms=0.0))
    frame = _raw_lookup(ep.port, 1, "ghost", np.array([0], np.int32), mode="pinned")
    assert frame["op"] == "error" and "no committed pinned epoch" in frame["error"]


def _sparse_chains(root, job, mesh):
    """The same hash table's chain, one entry, written by each package."""
    mine, ref, keys = _hash_pair(mesh)
    master = ETMaster(DevicePool([torch.device("cpu")]))
    ex = [e.id for e in master.add_executors(1)]
    cfg = mine.spec.config.replace(table_id=f"{job}:h")
    table = master.create_table(cfg, ex)
    table.import_blocks(mine.export_blocks())
    CheckpointManager.for_job(root + "/port", job).checkpoint(
        TableHandle(master, table, ex), commit=True, app_meta={"epoch": 0.0})
    jm = JaxETMaster(JaxDevicePool(jax.devices()[:1]))
    jex = [e.id for e in jm.add_executors(1)]
    h = jm.create_table(JaxTableConfig(
        table_id=f"{job}:h", capacity=cfg.capacity, value_shape=tuple(cfg.value_shape),
        num_blocks=cfg.num_blocks, is_ordered=False, update_fn=cfg.update_fn,
        sparse=True), jex)
    h.table.import_blocks(ref.export_blocks())
    JaxCheckpointManager.for_job(root + "/ref", job).checkpoint(
        h, commit=True, app_meta={"epoch": 0.0})
    return mine, keys


def test_pinned_reads_of_a_hash_chain_are_refused_where_the_reference_misreads(
        tmp_path, endpoints, mesh1):
    """A hash block is one packed uint8 array (slot keys, then values). The
    port refuses a pinned lookup on such a chain with an error frame naming
    the reason, whichever package wrote the chain. The reference reads the
    packed bytes as rows at (key % blocks, key // blocks): a large key runs
    past the block (an IndexError frame that names no reason), and a small
    key gets the packed bytes cast to floats, not the table's row (a fault
    of the reference, not fixed there; ROADMAP C)."""
    from harmony_tpu.checkpoint.manager import _read_block as jax_read_block

    mine, keys = _sparse_chains(str(tmp_path), "hj", mesh1)
    ks = keys[:3].astype(np.int32)
    for sub in ("port", "ref"):
        ep = endpoints.start(ServingEndpoint(chkp_root=f"{tmp_path}/{sub}", window_ms=0.0))
        frame = _raw_lookup(ep.port, 1, "hj", ks, mode="pinned")
        assert frame["op"] == "error"
        assert "hash table" in frame["error"] and "refused" in frame["error"]
        assert ep.stats()["errors"] == 1
    ref_ep = endpoints.start(JaxEndpoint(chkp_root=f"{tmp_path}/ref", window_ms=0.0))
    frame = _raw_lookup(ref_ep.port, 1, "hj", ks, mode="pinned")
    assert frame["op"] == "error" and frame["error"].startswith("IndexError: index")
    small = np.array([1, 6], np.int32)     # absent keys: the table reads zeros
    frame = _raw_lookup(ref_ep.port, 2, "hj", small, mode="pinned")
    assert frame["op"] == "rows"
    view = ref_ep._resolve_pinned("hj")
    packed = [jax_read_block(view.dir, int(k) % 4).reshape(-1, WIDTH)[int(k) // 4]
              for k in small]
    np.testing.assert_array_equal(frame["data"][0], np.stack(packed).astype(np.float32))
    assert frame["data"][0].tobytes() != mine.multi_get(small).tobytes()


# -- admission and errors --------------------------------------------------------


class _SheddingOverload:
    def __init__(self):
        self.shed_actions = []

    def shedding(self):
        return True

    def retry_after_ms(self):
        return 120

    def count_shed(self, action):
        self.shed_actions.append(action)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_an_overloaded_lookup_sheds_with_the_same_busy_frame(mesh1, endpoints, package):
    mine, ref, _ = _dense_pair(mesh1)
    ov = _SheddingOverload()
    cls, table = (ServingEndpoint, mine) if package == "port" else (JaxEndpoint, ref)
    ep = endpoints.start(cls(table_fn=lambda j: table, overload=ov, window_ms=0.0))
    frame = _raw_lookup(ep.port, 4, "j1", np.array([1], np.int32))
    assert frame == {"op": "busy", "r": 4, "retry_after_ms": 120}
    assert ov.shed_actions == ["serving_lookup"]
    assert ep.stats()["shed"] == 1


def _error_cases(keys):
    return [
        ("unknown job", "ghost", keys[:2], "live"),
        ("bad mode", "j1", keys[:2], "sideways"),
        ("empty keys", "j1", keys[:0], "live"),
        ("over the key bound", "j1", np.zeros(service._MAX_KEYS + 1, np.int32), "live"),
    ]


@pytest.mark.parametrize("case", range(4), ids=["unknown-job", "bad-mode", "empty-keys",
                                                "over-bound"])
def test_bad_lookups_are_the_references_error_frames_not_disconnects(
        mesh1, endpoints, case):
    mine, ref, keys = _dense_pair(mesh1)
    _, job, ks, mode = _error_cases(keys)[case]
    frames = []
    for cls, t in ((ServingEndpoint, mine), (JaxEndpoint, ref)):
        ep = endpoints.start(cls(table_fn=lambda j, t=t: t if j == "j1" else None,
                                 window_ms=0.0))
        sock = _conn(ep.port)
        try:
            frames.append(_lookup(sock, 7, job, ks, mode))
            # the same connection still answers
            protocol.send_msg(sock, {"op": "ping"})
            assert protocol.recv_frame(sock) == {"op": "pong"}
            ok = _lookup(sock, 8, "j1", keys[:2])
            assert ok["op"] == "rows"
        finally:
            sock.close()
        assert ep.stats()["errors"] == 1
    assert frames[0]["op"] == "error" and frames[0]["r"] == 7
    assert frames[0] == frames[1]


def test_an_unknown_op_and_the_max_key_lookup(mesh1, endpoints):
    mine, _, _ = _dense_pair(mesh1)
    ep = endpoints.start(ServingEndpoint(table_fn=lambda j: mine, window_ms=0.0))
    sock = _conn(ep.port)
    try:
        protocol.send_msg(sock, {"op": "frobnicate"})
        assert protocol.recv_frame(sock) == {"op": "error",
                                             "error": "unknown op 'frobnicate'"}
        ks = (np.arange(service._MAX_KEYS) % CAPACITY).astype(np.int32)
        frame = _lookup(sock, 1, "j1", ks)
        assert frame["data"][0].tobytes() == mine.multi_get(ks).tobytes()
        protocol.send_msg(sock, {"op": "stats"})
        stats = protocol.recv_frame(sock)["stats"]
        assert stats["requests"] == {"frobnicate": 1, "lookup": 1, "stats": 1}
        assert stats["tenants"]["j1"]["rows"] == service._MAX_KEYS
    finally:
        sock.close()
