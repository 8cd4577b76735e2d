"""Dolphin jobs on tables over several executors, on the CPU.

The port's ``JobServer(4, device_pool=DevicePool.virtual(cpu, 4))`` against
the reference's ``JobServer(num_executors=4)`` over 4 of the 8 virtual CPU
devices ``tests/conftest.py`` sets up: Wide&Deep, MLR and FM on a hash table,
each job's table split block-major over the 4 executors, at ``data_axis`` 1
(blocks over 4 slots) and 2 (2 rows of replicas of a 2-way split, the batch
halved over the rows). One worker a job, as ``--workers 1`` gives.

Tolerances:

* The port's ``data_axis`` 1 run against its one-executor run: the bits, per
  batch and for the final table (every shard folds its keys in their
  original order).
* The port against the reference: the per-batch losses within
  ``LOSS_ATOL`` = 1e-5 absolutely (losses ~0.69 and ~1.4; f32 sums taken in
  another order in the two frameworks, as tests/test_torch_widedeep.py
  allows for one device).
* The port's ``data_axis`` 2 run against its one-executor run: the same
  1e-5. Its rows' deltas, each a half-batch mean weighed by 1/2, add up in
  another order than the whole batch's mean (and Wide&Deep's L2 term on the
  shared rows is taken over each half's rows); the run is the same bits
  twice.
* Chains across meshes: ``.blk`` files byte for byte (blocks are bytes).
"""
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from harmony_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from harmony_tpu.config.params import JobConfig as JaxJobConfig
from harmony_tpu.config.params import TrainerParams as JaxTrainerParams
from harmony_tpu.jobserver import JobServer as JaxJobServer
from harmony_tpu.parallel import DevicePool as JaxDevicePool
from harmony_tpu.runtime import ETMaster as JaxETMaster
from harmony_tpu_torch.checkpoint import CheckpointManager
from harmony_tpu_torch.config.params import JobConfig, TrainerParams
from harmony_tpu_torch.jobserver.server import JobServer
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


CPU = torch.device("cpu")
TIMEOUT = 300
LOSS_ATOL = 1e-5

APPS = {
    "wd": ("widedeep:WideDeepTrainer", "widedeep:make_synthetic",
           {"vocab_size": 512, "num_slots": 4, "emb_dim": 8, "hidden": 16,
            "step_size": 0.5},
           {"n": 512, "vocab_size": 512, "num_slots": 4}),
    "mlr": ("mlr:MLRTrainer", "mlr:make_synthetic",
            {"num_classes": 4, "num_features": 16, "features_per_partition": 4,
             "step_size": 0.5},
            {"n": 256, "num_features": 16, "num_classes": 4, "seed": 7}),
    "fm": ("widedeep:FMTrainer", "widedeep:make_synthetic_sparse",
           {"vocab_size": 64, "num_slots": 4, "emb_dim": 4, "step_size": 2.0,
            "sparse": True},
           {"n": 512, "vocab_size": 64, "num_slots": 4}),
}


def job(app, job_id=None, epochs=2, data_axis=1, pkg="harmony_tpu_torch", period=0):
    trainer, data_fn, app_params, data_args = APPS[app]
    cls, params = ((JobConfig, TrainerParams) if pkg == "harmony_tpu_torch"
                   else (JaxJobConfig, JaxTrainerParams))
    user = {"data_fn": f"{pkg}.apps.{data_fn}", "data_args": dict(data_args)}
    if data_axis > 1:
        user["data_axis"] = data_axis
    return cls(job_id=job_id or app, app_type="dolphin", trainer=f"{pkg}.apps.{trainer}",
               params=params(num_epochs=epochs, num_mini_batches=4, model_chkp_period=period,
                             app_params=dict(app_params)),
               num_workers=1, user=user)


def port_run(config, executors=4, root=None):
    """(the worker's result, the job's result)."""
    pool = DevicePool.virtual(CPU, executors) if executors > 1 else DevicePool([CPU])
    server = JobServer(executors, device_pool=pool, chkp_root=root)
    server.start()
    try:
        res = server.submit(config).result(timeout=TIMEOUT)
    finally:
        server.shutdown(timeout=TIMEOUT)
    (w,) = res["workers"].values()
    return w, res


def ref_losses(config, executors, root=None):
    ref = JaxJobServer(num_executors=executors, device_pool=JaxDevicePool(
        jax.devices()[:executors]), chkp_root=root)
    ref.start()
    try:
        res = ref.submit(config).result(timeout=TIMEOUT)
        ms = sorted(ref.metrics.worker_batch_metrics(job_id=config.job_id),
                    key=lambda m: (m.epoch_idx, m.batch_idx))
    finally:
        ref.shutdown(timeout=TIMEOUT)
    return [m.loss for m in ms], res


@pytest.mark.parametrize("app", ["wd", "mlr", "fm"])
def test_data_axis_1_is_the_one_executor_run_and_near_the_reference(app):
    one, _ = port_run(job(app), executors=1)
    four, _ = port_run(job(app), executors=4)
    assert four["mesh"] == {"data": 1, "model": 4} and one["mesh"] == {"data": 1, "model": 1}
    assert four["batch_losses"] == one["batch_losses"]
    want, _ = ref_losses(job(app, pkg="harmony_tpu"), 4)
    assert len(want) == len(four["batch_losses"]) == 8
    np.testing.assert_allclose(four["batch_losses"], want, rtol=0, atol=LOSS_ATOL)


@pytest.mark.parametrize("app", ["wd", "mlr", "fm"])
def test_data_axis_2_splits_the_batch_over_two_rows(app):
    one, _ = port_run(job(app), executors=1)
    two, _ = port_run(job(app, data_axis=2), executors=4)
    again, _ = port_run(job(app, data_axis=2), executors=4)
    assert two["mesh"] == {"data": 2, "model": 2} and two["step_mode"] == "data_parallel"
    assert two["batch_losses"] == again["batch_losses"]
    np.testing.assert_allclose(two["batch_losses"], one["batch_losses"], rtol=0,
                               atol=LOSS_ATOL)
    want, _ = ref_losses(job(app, pkg="harmony_tpu", data_axis=2), 4)
    np.testing.assert_allclose(two["batch_losses"], want, rtol=0, atol=LOSS_ATOL)


def test_cli_run_on_a_virtual_mesh_and_the_data_axis_flag():
    from harmony_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["run", "mlr", "--device", "cpu", "--set", "data_axis=2", "--set", "num_classes=4"])
    cfg = cli.build_config(args.app, args)
    assert cfg.user["data_axis"] == 2 and "data_axis" not in cfg.params.app_params
    assert args.num_executors == 0


def entries(root, job_id):
    mgr = CheckpointManager.for_job(root, job_id)
    infos = sorted((mgr.info(c) for c in mgr.list_checkpoints()),
                   key=lambda i: int(i.app_meta["epoch"]))
    return mgr, infos


def blk_files(entry_dir):
    out = {os.path.basename(p): open(p, "rb").read()
           for p in sorted(glob.glob(os.path.join(entry_dir, "*.blk")))}
    assert out, f"no .blk files in {entry_dir}"
    return out


def test_chain_on_4_slots_is_the_one_slot_chain_and_restores_anywhere(tmp_path):
    r1, r4 = str(tmp_path / "one"), str(tmp_path / "four")
    port_run(job("wd", "wd-chain", period=1), executors=1, root=r1)
    port_run(job("wd", "wd-chain", period=1), executors=4, root=r4)
    m1, i1 = entries(r1, "wd-chain")
    m4, i4 = entries(r4, "wd-chain")
    assert len(i1) == len(i4) == 2
    for a, b in zip(i1, i4):
        f1, f4 = blk_files(m1._dir_of(a.chkp_id)), blk_files(m4._dir_of(b.chkp_id))
        assert f1 and f1 == f4
        # the manifest's ownership: the reference's even round-robin over the
        # executors that hold the table
        assert b.executors == [f"executor-{i}" for i in range(4)]
        assert b.ownership == [blk % 4 for blk in range(len(b.ownership))]
        assert a.ownership == [0] * len(a.ownership)
    # a chain written on 4 slots restores on 1, and one written on 1 on 4
    for mgr, info, n in ((m4, i4[-1], 1), (m1, i1[-1], 4)):
        pool = DevicePool.virtual(CPU, n) if n > 1 else DevicePool([CPU])
        master = ETMaster(pool)
        ids = [e.id for e in master.add_executors(n)]
        h = mgr.restore(master, info.chkp_id, ids)
        assert len(h.table.mesh.slots) == n
        out = str(tmp_path / f"again-{n}")
        again = CheckpointManager.for_job(out, "x")
        cid = again.checkpoint(h, commit=True)
        assert blk_files(again._dir_of(cid)) == blk_files(mgr._dir_of(info.chkp_id))


def test_chains_cross_between_the_reference_on_8_devices_and_the_port_on_4(tmp_path):
    """The reference writes a chain on 8 devices; the port restores it on 4
    slots and writes the same .blk bytes again; the reverse too."""
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_losses(job("mlr", "mlr-x", pkg="harmony_tpu", period=1), 8, root=ref_root)
    port_run(job("mlr", "mlr-x", period=1), executors=4, root=port_root)
    jmgr = JaxCheckpointManager(os.path.join(ref_root, "mlr-x", "temp"),
                                os.path.join(ref_root, "mlr-x", "commit"))
    pmgr, pinfos = entries(port_root, "mlr-x")
    (ref_cid,) = [c for c in jmgr.list_checkpoints()
                  if json.loads(open(os.path.join(jmgr._dir_of(c), "manifest.json")).read())
                  .get("app_meta", {}).get("epoch") == 1]
    ref_dir = jmgr._dir_of(ref_cid)

    # reference (8 devices) -> port (4 slots)
    master = ETMaster(DevicePool.virtual(CPU, 4))
    ids = [e.id for e in master.add_executors(4)]
    h = CheckpointManager(os.path.join(ref_root, "mlr-x", "temp"),
                          os.path.join(ref_root, "mlr-x", "commit")).restore(master, ref_cid, ids)
    assert h.table.sharding.spec == ("model",)
    out = CheckpointManager.for_job(str(tmp_path / "p-again"), "x")
    assert blk_files(out._dir_of(out.checkpoint(h, commit=True))) == blk_files(ref_dir)

    # port (4 slots) -> reference (8 devices)
    jmaster = JaxETMaster(JaxDevicePool(jax.devices()[:8]))
    jids = [e.id for e in jmaster.add_executors(8)]
    info = pinfos[-1]
    jh = JaxCheckpointManager(pmgr.temp_root, pmgr.commit_root).restore(
        jmaster, info.chkp_id, jids)
    jout = JaxCheckpointManager(str(tmp_path / "j-temp"), str(tmp_path / "j-commit"))
    jcid = jout.checkpoint(jh, commit=True)
    assert blk_files(jout._dir_of(jcid)) == blk_files(pmgr._dir_of(info.chkp_id))
    # the manifests name the same ownership for the same executor count
    ref_manifest = json.loads(open(os.path.join(ref_dir, "manifest.json")).read())
    assert ref_manifest["ownership"] == [b % 8 for b in range(len(ref_manifest["ownership"]))]
    assert info.ownership == [b % 4 for b in range(len(info.ownership))]


def test_a_handle_reads_its_tables_block_manager_or_makes_one():
    """A handle of a table its master holds reads the master's block manager
    (the reference's round-robin over the table's executors); a handle of a
    table made outside any master makes its own."""
    from harmony_tpu_torch.config.params import TableConfig
    from harmony_tpu_torch.runtime.master import TableHandle
    from harmony_tpu_torch.table.table import DenseTable, TableSpec

    master = ETMaster(DevicePool.virtual(CPU, 4))
    ids = [e.id for e in master.add_executors(4)]
    cfg = TableConfig(table_id="bm", capacity=64, value_shape=(2,), num_blocks=8)
    table = master.create_table(cfg, ids)
    h = TableHandle(master, table, ids)
    assert h.block_manager is TableHandle(master, table, ids).block_manager
    assert h.ownership_vector() == [b % 4 for b in range(8)]
    with pytest.raises(RuntimeError, match="still associated"):
        master.remove_executor(ids[0])
    master.drop_table("bm")
    master.remove_executor(ids[0])
    loose = TableHandle(None, DenseTable(TableSpec(cfg), CPU), ["executor-0"])
    assert loose.ownership_vector() == [0] * 8
