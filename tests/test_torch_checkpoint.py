"""harmony_tpu_torch's checkpoint manager against harmony_tpu's, on the CPU.

The same numpy values go into a table of each package. A checkpoint written
by one package restores in the other: dense values bit for bit, a hash
table's slot keys byte for byte and its values bit for bit. The two packages
write the same ``.blk`` bytes and the same manifest checksums for the same
table, and each reads the other's manifest, the update fn's module prefix
mapped. Exact comparisons throughout: checkpoints move bytes.

The port's own tests follow the reference's ``tests/test_checkpoint.py``:
temp then commit, restore from temp, a sampled checkpoint's init pad, a
missing id, no orphan table after a failed restore; and the view trap of an
in-place table: a snapshot holds the table's bytes at the hook even when
steps mutate the table afterwards.
"""
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from harmony_tpu.apps import widedeep as jax_wd
from harmony_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from harmony_tpu.checkpoint.manager import CheckpointInfo as JaxCheckpointInfo
from harmony_tpu.config.params import TableConfig as JaxTableConfig
from harmony_tpu.parallel import DevicePool as JaxDevicePool
from harmony_tpu.runtime import ETMaster as JaxETMaster
from harmony_tpu_torch import faults
from harmony_tpu_torch.apps import widedeep as torch_wd
from harmony_tpu_torch.checkpoint import CheckpointManager, make_commit_backend
from harmony_tpu_torch.checkpoint.manager import (
    CheckpointCorruptError,
    CheckpointInfo,
    _check_update_fn,
)
from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.dolphin.evaluator import ModelChkpManager, ModelEvaluator
from harmony_tpu_torch.faults import FaultPlan, FaultRule
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.runtime.master import ETMaster, TableHandle

CAP, VSHAPE, NBLOCKS = 64, (2,), 16


@pytest.fixture(scope="module", autouse=True)
def codecs_built():
    """Both packages write .blk files here (see tests/test_torch_native.py:
    the reference's loader may meet another test process's build midway)."""
    from harmony_tpu import native as ref_native
    from harmony_tpu_torch import native

    assert native.available()
    for _ in range(100):
        if ref_native.available():
            return
        ref_native._tried = False
        time.sleep(0.2)
    pytest.fail("the reference's native codec did not build")


@pytest.fixture()
def roots(tmp_path):
    return str(tmp_path / "temp"), str(tmp_path / "commit")


@pytest.fixture()
def mgr(roots):
    return CheckpointManager(*roots)


@pytest.fixture()
def master():
    return ETMaster(DevicePool([torch.device("cpu")]))


@pytest.fixture()
def jax_master():
    return JaxETMaster(JaxDevicePool(jax.devices()[:1]))


def _values(seed=0, capacity=CAP):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(capacity, *VSHAPE)).astype(np.float32)


def make_handle(master, tid="t", vals=None, ex=None):
    ex = ex or master.add_executors(1)
    cfg = TableConfig(table_id=tid, capacity=CAP, value_shape=VSHAPE, num_blocks=NBLOCKS)
    table = master.create_table(cfg, [e.id for e in ex])
    vals = _values() if vals is None else vals
    table.multi_update(list(range(CAP)), vals)
    return TableHandle(master, table, [e.id for e in ex]), vals


def make_jax_handle(jax_master, tid="t", vals=None):
    ex = jax_master.add_executors(1)
    cfg = JaxTableConfig(table_id=tid, capacity=CAP, value_shape=VSHAPE, num_blocks=NBLOCKS)
    h = jax_master.create_table(cfg, [e.id for e in ex])
    vals = _values() if vals is None else vals
    h.table.multi_update(list(range(CAP)), vals)
    return h, vals


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


# -- the port's two stages ----------------------------------------------------


class TestTwoStage:
    def test_temp_then_commit(self, mgr, master):
        h, _ = make_handle(master)
        cid = mgr.checkpoint(h)
        assert not mgr.info(cid).committed
        assert os.path.isdir(os.path.join(mgr.temp_root, cid))
        mgr.commit(cid)
        assert mgr.info(cid).committed
        assert os.path.isdir(os.path.join(mgr.commit_root, cid))
        assert not os.path.isdir(os.path.join(mgr.temp_root, cid))
        mgr.commit(cid)  # idempotent

    def test_restore_from_temp_stage(self, mgr, master):
        h, vals = make_handle(master, tid="t-temp")
        cid = mgr.checkpoint(h)
        h2 = mgr.restore(master, cid, h.executors, table_id="t-restored")
        assert _bits(h2.table.pull_array()) == _bits(vals)
        assert h2.table_id == "t-restored" and h2.ownership_vector() == [0] * NBLOCKS

    def test_sampling_ratio_pads_with_init(self, mgr, master):
        h, vals = make_handle(master, tid="t-sample")
        cid = mgr.checkpoint(h, sampling_ratio=0.5, commit=True)
        h2 = mgr.restore(master, cid, h.executors, table_id="t-sampled")
        got = np.asarray(h2.table.pull_array())
        bs = h.table.spec.block_size  # 4: keys 0, 1 of each block restored
        for b in range(NBLOCKS):
            np.testing.assert_array_equal(got[b * bs:b * bs + 2], vals[b * bs:b * bs + 2])
            np.testing.assert_array_equal(got[b * bs + 2:(b + 1) * bs], 0.0)

    def test_missing_checkpoint_raises(self, mgr, master):
        master.add_executors(1)
        with pytest.raises(FileNotFoundError):
            mgr.restore(master, "nope-1-2", master.executor_ids())

    def test_failed_restore_leaves_no_orphan_table(self, mgr, master):
        h, _ = make_handle(master, tid="t-orphan")
        cid = mgr.checkpoint(h, commit=True)
        cdir = os.path.join(mgr.commit_root, cid)
        os.remove(os.path.join(cdir, next(f for f in os.listdir(cdir) if f.startswith("3."))))
        with pytest.raises(FileNotFoundError):
            mgr.restore(master, cid, h.executors, table_id="t-orphan2")
        assert "t-orphan2" not in master.table_ids()

    def test_torn_manifest_is_corrupt_and_quarantine_hides_it(self, mgr, master):
        h, _ = make_handle(master, tid="t-torn")
        cid = mgr.checkpoint(h, commit=True)
        path = os.path.join(mgr.commit_root, cid, "manifest.json")
        with open(path, "r+") as f:
            f.truncate(40)
        with pytest.raises(CheckpointCorruptError):
            mgr.info(cid)
        with pytest.raises(CheckpointCorruptError):
            mgr.restore(master, cid, h.executors, table_id="t-torn2")
        mgr.quarantine(cid)
        assert cid not in mgr.list_checkpoints()
        assert os.path.isdir(os.path.join(mgr.commit_root, cid + ".quarantined"))

    def test_flipped_block_byte_fails_the_checksum(self, mgr, master):
        h, _ = make_handle(master, tid="t-flip")
        cid = mgr.checkpoint(h, commit=True)
        blk = os.path.join(mgr.commit_root, cid, "5.blk")
        raw = bytearray(open(blk, "rb").read())
        raw[len(raw) // 2] ^= 0x01
        open(blk, "wb").write(bytes(raw))
        with pytest.raises(CheckpointCorruptError):
            mgr.restore(master, cid, h.executors, table_id="t-flip2")
        assert "t-flip2" not in master.table_ids()

    def test_delete_removes_every_copy(self, mgr, master):
        h, _ = make_handle(master, tid="t-del")
        cid = mgr.checkpoint(h, commit=True)
        mgr.delete(cid)
        assert mgr.list_checkpoints() == []
        with pytest.raises(FileNotFoundError):
            mgr.delete(cid)

    def test_object_store_roots_are_not_ported(self, tmp_path):
        for root, backend in (("gs://bucket/chkps", None), (str(tmp_path), "orbax")):
            with pytest.raises(NotImplementedError, match="Orbax"):
                make_commit_backend(root, backend)


# -- the view trap: steps update the table in place --------------------------


def test_snapshot_blocks_are_copies_of_the_dense_storage(master):
    h, vals = make_handle(master, tid="t-view")
    snap = h.table.snapshot_blocks()
    h.table.multi_update(list(range(CAP)), np.ones((CAP, *VSHAPE), np.float32))
    got = np.concatenate([snap[b].numpy() for b in sorted(snap)])
    assert _bits(got[:CAP]) == _bits(vals)


def test_snapshot_blocks_are_copies_of_the_hash_state(master):
    master.add_executors(1)
    trainer = torch_wd.FMTrainer(vocab_size=64, num_slots=4, emb_dim=4, sparse=True)
    table = master.create_table(trainer.model_table_config("fm"), master.executor_ids())
    keys = np.arange(1, 200, 3)
    table.multi_get_or_init(keys)
    before = [t.clone() for t in table.state]
    snap = table.snapshot_blocks()
    table.multi_get_or_init(np.arange(1000, 1100))          # new slots claimed
    table.multi_update(keys, np.ones((len(keys), trainer.width), np.float32))
    sk = np.stack([snap[b][0].numpy() for b in sorted(snap)])
    v = np.stack([snap[b][1].numpy() for b in sorted(snap)])
    assert _bits(sk) == _bits(before[0]) and _bits(v) == _bits(before[1])


def test_async_checkpoint_holds_the_bytes_at_the_hook(mgr, master, monkeypatch):
    """The writer is held at its first block (a fault-plan delay) while the
    table is mutated in place; every later block it copies to the host must
    still hold the pre-mutation bytes."""
    monkeypatch.setenv("HARMONY_CHKP_IO_THREADS", "1")
    h, vals = make_handle(master, tid="t-async")
    faults.arm(FaultPlan([FaultRule("chkp.block_write", match={"block": 0},
                                    action="delay", delay_sec=0.5)]))
    try:
        pending = mgr.checkpoint_async(h, commit=True)
        h.table.multi_update(list(range(CAP)), np.full((CAP, *VSHAPE), 100.0, np.float32))
        assert pending.wait(timeout=60) == pending.chkp_id
    finally:
        faults.disarm()
    h2 = mgr.restore(master, pending.chkp_id, h.executors, table_id="t-async2")
    assert _bits(h2.table.pull_array()) == _bits(vals)
    assert pending.bytes_written == CAP * 2 * 4 and pending.write_seconds >= 0.5


def test_drain_prunes_a_failed_writers_id(mgr, master):
    h, _ = make_handle(master, tid="t-drain")
    chain = ModelChkpManager(mgr, h, period=1)
    faults.arm(FaultPlan([FaultRule("chkp.block_write", match={"block": 2},
                                    exc="ValueError", count=1)]))
    try:
        first = chain.on_epoch(0)
        with pytest.raises(ValueError, match="injected"):
            chain.drain()
        assert chain.chkp_ids == []
        second = chain.on_epoch(1)
        assert chain.drain() == [second] != [first]
    finally:
        faults.disarm()
    assert mgr.list_checkpoints() == [second]
    assert mgr.info(second).app_meta == {"epoch": 1.0}
    assert [s["chkp_id"] for s in chain.stats] == [second]


def test_chain_backpressure_joins_the_oldest_writer(mgr, master):
    h, _ = make_handle(master, tid="t-bp")
    chain = ModelChkpManager(mgr, h, period=2)
    ids = [chain.on_epoch(e) for e in range(8)]
    assert ids[0::2] == [None] * 4
    assert len(chain._pending) <= ModelChkpManager.MAX_PENDING
    assert chain.drain() == ids[1::2]
    assert [mgr.info(c).app_meta["epoch"] for c in ids[1::2]] == [1.0, 3.0, 5.0, 7.0]


@pytest.mark.parametrize("threads", ["1", "4"])
def test_serial_and_pooled_routes_write_the_same_files(tmp_path, master, monkeypatch, threads):
    """HARMONY_CHKP_IO_THREADS=1 (serial) and 4 (pooled): the same manifest
    checksums and block bytes as the other route, and the same restore."""
    vals = _values(seed=4)
    out = {}
    ex = master.add_executors(1)
    for route in ("1", threads):
        monkeypatch.setenv("HARMONY_CHKP_IO_THREADS", route)
        m = CheckpointManager(str(tmp_path / f"t{route}{len(out)}"),
                              str(tmp_path / f"c{route}{len(out)}"))
        h, _ = make_handle(master, tid=f"t-route-{len(out)}", vals=vals, ex=ex)
        cid = m.checkpoint(h, commit=True)
        d = os.path.join(m.commit_root, cid)
        blocks = {f: open(os.path.join(d, f), "rb").read()
                  for f in os.listdir(d) if f.endswith(".blk")}
        restored = m.restore(master, cid, h.executors, table_id=f"r-route-{len(out)}")
        out[len(out)] = (m.info(cid).block_checksums, blocks,
                         _bits(restored.table.pull_array()))
    assert out[0] == out[1]
    assert out[0][2] == _bits(vals)


# -- both packages, both directions ------------------------------------------


def test_dense_reference_chain_restores_in_the_port(roots, master, jax_master):
    jh, vals = make_jax_handle(jax_master, tid="job:dense")
    cid = JaxCheckpointManager(*roots).checkpoint(jh, commit=True, app_meta={"epoch": 3.0})
    mgr = CheckpointManager(*roots)
    info = mgr.info(cid)
    assert info.app_meta == {"epoch": 3.0} and info.table_config.capacity == CAP
    master.add_executors(1)
    h = mgr.restore(master, cid, master.executor_ids())
    assert h.table_id == "job:dense"
    assert _bits(h.table.pull_array()) == _bits(np.asarray(jh.table.pull_array()))
    assert _bits(h.table.pull_array()) == _bits(vals)


def test_dense_port_chain_restores_in_the_reference(roots, master, jax_master):
    h, vals = make_handle(master, tid="job:dense")
    cid = CheckpointManager(*roots).checkpoint(h, commit=True, app_meta={"epoch": 1.0})
    jmgr = JaxCheckpointManager(*roots)
    assert jmgr.info(cid).app_meta == {"epoch": 1.0}
    jh = jmgr.restore(jax_master, cid, [e.id for e in jax_master.add_executors(1)],
                      table_id="r")
    assert _bits(np.asarray(jh.table.pull_array())) == _bits(vals)


def test_dense_blocks_and_checksums_are_byte_identical(tmp_path, master, jax_master):
    vals = _values(seed=5)
    jh, _ = make_jax_handle(jax_master, tid="same", vals=vals)
    h, _ = make_handle(master, tid="same", vals=vals)
    jm = JaxCheckpointManager(str(tmp_path / "jt"), str(tmp_path / "jc"))
    tm = CheckpointManager(str(tmp_path / "tt"), str(tmp_path / "tc"))
    jd = os.path.join(jm.commit_root, jm.checkpoint(jh, commit=True))
    td = os.path.join(tm.commit_root, tm.checkpoint(h, commit=True))
    files = sorted(os.listdir(jd))
    assert files == sorted(os.listdir(td))
    for f in files:
        if f.endswith(".blk"):
            assert open(os.path.join(jd, f), "rb").read() == \
                open(os.path.join(td, f), "rb").read(), f
    jman, tman = (json.load(open(os.path.join(d, "manifest.json"))) for d in (jd, td))
    assert jman["block_checksums"] == tman["block_checksums"]
    assert jman["table_config"] == tman["table_config"]
    assert set(jman) == set(tman)


FM_KW = dict(vocab_size=64, num_slots=4, emb_dim=4, sparse=True)


def _fill_hash(table, width, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2**31 - 3, size=300)
    table.multi_get_or_init(keys)
    table.multi_update(keys, rng.normal(size=(len(keys), width)).astype(np.float32))
    return keys


def test_hash_reference_chain_restores_in_the_port(roots, master, jax_master):
    jtrainer = jax_wd.FMTrainer(**FM_KW)
    jh = jax_master.create_table(jtrainer.model_table_config("job:fm"),
                                 [e.id for e in jax_master.add_executors(1)])
    keys = _fill_hash(jh.table, jtrainer.width)
    cid = JaxCheckpointManager(*roots).checkpoint(jh, commit=True, app_meta={"epoch": 0.0})
    mgr = CheckpointManager(*roots)
    info = mgr.info(cid)
    # the manifest names the reference's factory; the port reads its own
    assert info.table_config.update_fn.startswith("harmony_tpu_torch.apps.widedeep:make_embed_init?")
    master.add_executors(1)
    h = mgr.restore(master, cid, master.executor_ids())
    jsk, jv = (np.asarray(a) for a in jh.table._state)
    assert _bits(h.table.state[0]) == _bits(jsk)
    assert _bits(h.table.state[1]) == _bits(jv)
    assert _bits(h.table.multi_get(keys)) == _bits(jh.table.multi_get(keys))
    # a key neither table has seen: the same lazy init
    fresh = [123457]
    np.testing.assert_array_equal(h.table.multi_get_or_init(fresh),
                                  jh.table.multi_get_or_init(fresh))


def test_hash_port_chain_restores_in_the_reference(roots, master, jax_master):
    trainer = torch_wd.FMTrainer(**FM_KW)
    master.add_executors(1)
    table = master.create_table(trainer.model_table_config("job:fm"), master.executor_ids())
    keys = _fill_hash(table, trainer.width, seed=1)
    h = TableHandle(master, table, master.executor_ids())
    cid = CheckpointManager(*roots).checkpoint(h, commit=True)
    manifest = json.load(open(os.path.join(roots[1], cid, "manifest.json")))
    assert manifest["table_config"]["update_fn"].startswith(
        "harmony_tpu.apps.widedeep:make_embed_init?")
    jh = JaxCheckpointManager(*roots).restore(
        jax_master, cid, [e.id for e in jax_master.add_executors(1)], table_id="r")
    jsk, jv = (np.asarray(a) for a in jh.table._state)
    assert _bits(jsk) == _bits(table.state[0]) and _bits(jv) == _bits(table.state[1])
    assert _bits(jh.table.multi_get(keys)) == _bits(table.multi_get(keys))


def test_manifests_read_across_packages(roots, master, jax_master):
    jtrainer = jax_wd.FMTrainer(**FM_KW)
    jh = jax_master.create_table(jtrainer.model_table_config("a:fm"),
                                 [e.id for e in jax_master.add_executors(1)])
    jcid = JaxCheckpointManager(*roots).checkpoint(jh, commit=True, app_meta={"epoch": 2.0})
    h, _ = make_handle(master, tid="b:dense")
    tcid = CheckpointManager(*roots).checkpoint(h, commit=True, app_meta={"epoch": 4.0})
    text = {c: open(os.path.join(roots[1], c, "manifest.json")).read() for c in (jcid, tcid)}
    ours, theirs = CheckpointInfo.from_json(text[jcid]), JaxCheckpointInfo.from_json(text[tcid])
    assert ours.app_meta == {"epoch": 2.0} and theirs.app_meta == {"epoch": 4.0}
    assert ours.table_config.update_fn == torch_wd.FMTrainer(**FM_KW)._sparse_init_name()
    assert ours.table_config.update_fn.replace("harmony_tpu_torch.", "harmony_tpu.", 1) == \
        jtrainer.model_table_config("a:fm").update_fn
    assert theirs.table_config.update_fn == "add" and theirs.table_config.capacity == CAP
    assert json.loads(ours.to_json())["table_config"]["update_fn"] == \
        json.loads(text[jcid])["table_config"]["update_fn"]
    # a newer writer's extra fields are dropped, not raised on
    extra = json.loads(text[tcid])
    extra["future_field"] = 1
    extra["table_config"]["future_knob"] = True
    assert CheckpointInfo.from_json(json.dumps(extra)).chkp_id == tcid


def test_update_fn_without_a_counterpart_module_raises():
    _check_update_fn("add")
    _check_update_fn("harmony_tpu_torch.apps.widedeep:make_embed_init?width=5")
    with pytest.raises(ValueError, match="no counterpart"):
        _check_update_fn("harmony_tpu_torch.apps.nosuchapp:make_init?x=1")


# -- evaluation of a chain ----------------------------------------------------


def test_chained_checkpoints_replay(mgr, master):
    """MLR with a snapshot every epoch, replayed offline: the evaluation loss
    falls along the chain, and the evaluation tables are temporary."""
    from harmony_tpu_torch.apps.mlr import MLRTrainer, make_synthetic
    from harmony_tpu_torch.config.params import TrainerParams
    from harmony_tpu_torch.dolphin.data import TrainingDataProvider
    from harmony_tpu_torch.dolphin.trainer import TrainerContext
    from harmony_tpu_torch.dolphin.worker import WorkerTasklet

    ex = master.add_executors(1)
    trainer = MLRTrainer(4, 16, 4, step_size=0.5)
    table = master.create_table(trainer.model_table_config("mlr-chk"), [ex[0].id])
    chain = ModelChkpManager(mgr, TableHandle(master, table, [ex[0].id]), period=1)
    x, y = make_synthetic(256, 16, 4, seed=11)
    worker = WorkerTasklet(
        "chk-job", TrainerContext(params=TrainerParams(num_epochs=4, num_mini_batches=4),
                                  model_table=table),
        trainer, TrainingDataProvider([x, y], 4), epoch_callback=chain.on_epoch)
    result = worker.run()
    assert result["windows"] == [1, 1, 1, 1]  # a chain sees every epoch
    ids = chain.drain()
    assert len(ids) == 4
    results = ModelEvaluator(master, mgr).evaluate_checkpoints(ids, trainer, (x, y), [ex[0].id])
    losses = [r["loss"] for r in results]
    assert losses[-1] < losses[0], losses
    assert all(not t.startswith("__eval__") for t in master.table_ids())


def test_evaluations_run_on_the_tables_device(master):
    """The sparse evaluation's rows, labels and metrics lie on the table's
    device, and the dense route hands evaluate its batch there too."""
    master.add_executors(1)
    trainer = torch_wd.FMTrainer(**FM_KW)
    table = master.create_table(trainer.model_table_config("fm"), master.executor_ids())
    ids, y = torch_wd.make_synthetic_sparse(n=32, vocab_size=64, num_slots=4)
    metrics = trainer.evaluate_sparse(table, (ids, y))
    assert all(isinstance(v, torch.Tensor) and v.device == table.device
               for v in metrics.values())

    seen = {}

    class Probe(torch_wd.FMTrainer):
        def evaluate(self, model, batch):
            seen["devices"] = {model.device, *(b.device for b in batch)}
            seen["types"] = {type(b) for b in batch}
            return {"loss": model.sum()}

    dense = torch_wd.FMTrainer(vocab_size=64, num_slots=4, emb_dim=4)
    h = TableHandle(master, master.create_table(dense.model_table_config("fm-d"),
                                                master.executor_ids()),
                    master.executor_ids())

    class OneShot:  # a manager whose restore hands back the dense table
        def restore(self, *_args, **_kw):
            return h

    x = np.zeros((8, 4), np.int32)
    out = ModelEvaluator(master, OneShot()).evaluate_checkpoints(
        ["c"], Probe(vocab_size=64, num_slots=4, emb_dim=4), (x, np.zeros(8, np.float32)),
        master.executor_ids())
    assert seen["devices"] == {table.device} and seen["types"] == {torch.Tensor}
    assert out == [{"loss": 0.0}]
