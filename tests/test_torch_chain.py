"""harmony_tpu_torch's checkpoint chains under the JobServer, on the CPU.

A job with ``model_chkp_period`` chains snapshots of its model table from the
chief's epoch hook; with ``offline_model_eval`` the server's shutdown replays
the chain through the trainer's evaluation and deletes it; a job submitted
with ``user["resume_from_chain"]`` continues from the chain's newest entry
that restores. Held to the reference where both run: the port's evaluations
of a chain within 1e-5 of the reference's ModelEvaluator over the same files
(f32 sums in another order, as tests/test_torch_apps.py allows for MLR), and
a resumed Wide&Deep job's losses within the slice tolerance of
tests/test_torch_widedeep.py (1e-5 absolute). A resume in the port is exact:
the resumed table equals the uninterrupted run's bit for bit.
"""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from harmony_tpu.apps.mlr import MLRTrainer as JaxMLRTrainer
from harmony_tpu.apps.mlr import make_synthetic as jax_mlr_data
from harmony_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from harmony_tpu.config.params import JobConfig as JaxJobConfig
from harmony_tpu.config.params import TrainerParams as JaxTrainerParams
from harmony_tpu.dolphin.evaluator import ModelEvaluator as JaxModelEvaluator
from harmony_tpu.jobserver import JobServer as JaxJobServer
from harmony_tpu.parallel import DevicePool as JaxDevicePool
from harmony_tpu.runtime import ETMaster as JaxETMaster
from harmony_tpu_torch import cli, faults
from harmony_tpu_torch.checkpoint import CheckpointManager
from harmony_tpu_torch.config.params import JobConfig, TrainerParams
from harmony_tpu_torch.dolphin.evaluator import ModelChkpManager
from harmony_tpu_torch.faults import FaultPlan, FaultRule
from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.runtime.master import ETMaster, TableHandle


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


EVAL_ATOL = 1e-5   # evaluations of one chain, port against reference
LOSS_ATOL = 1e-5   # a resumed W&D job's losses, port against reference

MLR_APP = {"num_classes": 4, "num_features": 16, "features_per_partition": 4,
           "step_size": 0.5}
MLR_DATA = {"n": 256, "num_features": 16, "num_classes": 4, "seed": 7}
WD_APP = {"vocab_size": 512, "num_slots": 4, "emb_dim": 8, "hidden": 16, "step_size": 0.5}
WD_DATA = {"n": 512, "vocab_size": 512, "num_slots": 4}


def job(job_id, epochs, period=1, offline=False, pkg="harmony_tpu_torch", app="mlr",
        **user):
    trainer, data_fn, app_params, data_args = {
        "mlr": ("mlr:MLRTrainer", "mlr:make_synthetic", MLR_APP, MLR_DATA),
        "wd": ("widedeep:WideDeepTrainer", "widedeep:make_synthetic", WD_APP, WD_DATA),
        "fm": ("widedeep:FMTrainer", "widedeep:make_synthetic_sparse",
               {"vocab_size": 64, "num_slots": 4, "emb_dim": 4, "step_size": 2.0,
                "sparse": True},
               {"n": 512, "vocab_size": 64, "num_slots": 4}),
    }[app]
    config_cls, params_cls = ((JobConfig, TrainerParams) if pkg == "harmony_tpu_torch"
                              else (JaxJobConfig, JaxTrainerParams))
    return config_cls(
        job_id=job_id, app_type="dolphin", trainer=f"{pkg}.apps.{trainer}",
        params=params_cls(num_epochs=epochs, num_mini_batches=4,
                          model_chkp_period=period, offline_model_eval=offline,
                          app_params=dict(app_params)),
        num_workers=1,
        user={"data_fn": f"{pkg}.apps.{data_fn}", "data_args": dict(data_args), **user})


def serve(root, *configs, shutdown=True):
    server = JobServer(1, device_pool=DevicePool([torch.device("cpu")]), chkp_root=root)
    server.start()
    try:
        results = [server.submit(c).result(timeout=300) for c in configs]
    finally:
        if shutdown:
            server.shutdown(timeout=300)
    return server, results


def worker_result(result):
    (w,) = result["workers"].values()
    return w


def chain_dirs(root, job_id):
    return sorted(d for sub in ("temp", "commit")
                  for d in os.listdir(os.path.join(root, job_id, sub))
                  if os.path.isdir(os.path.join(root, job_id, sub, d)))


def newest_table_bits(root, job_id):
    """The bits of the job's newest chain entry (the table after its last
    chained epoch)."""
    mgr = CheckpointManager.for_job(root, job_id)
    infos = [mgr.info(c) for c in mgr.list_checkpoints()]
    newest = max(infos, key=lambda i: (i.app_meta["epoch"], i.created_at))
    master = ETMaster(DevicePool([torch.device("cpu")]))
    h = mgr.restore(master, newest.chkp_id, [e.id for e in master.add_executors(1)])
    return int(newest.app_meta["epoch"]), h.table.pull_array().numpy().tobytes()


# -- the chain and its deferred evaluation ------------------------------------


def test_chain_and_eval_at_shutdown_match_the_reference_evaluator(tmp_path):
    root = str(tmp_path / "chains")
    server, (res,) = serve(root, job("eval-mlr", 3, offline=True), shutdown=False)
    assert len(res["model_chkp_ids"]) == 3 and res["model_chkp_root"] == root
    assert [s["bytes"] > 0 for s in res["model_chkp_stats"]] == [True] * 3
    assert worker_result(res)["windows"] == [1, 1, 1]
    assert "eval-mlr" not in server.eval_results  # deferred, not yet run
    copy = str(tmp_path / "copy")
    shutil.copytree(os.path.join(root, "eval-mlr"), copy)
    server.shutdown(timeout=300)
    evals = server.eval_results["eval-mlr"]
    assert isinstance(evals, list) and len(evals) == 3
    assert evals[-1]["loss"] < evals[0]["loss"]
    assert all(np.isfinite(m["loss"]) for m in evals)
    assert chain_dirs(root, "eval-mlr") == []  # the replay consumed the chain

    # the reference's evaluator over the same files
    jmgr = JaxCheckpointManager(os.path.join(copy, "temp"), os.path.join(copy, "commit"))
    jmaster = JaxETMaster(JaxDevicePool(jax.devices()[:1]))
    x, y = jax_mlr_data(**MLR_DATA)
    ref = JaxModelEvaluator(jmaster, jmgr).evaluate_checkpoints(
        res["model_chkp_ids"], JaxMLRTrainer(**MLR_APP), (x, y),
        [e.id for e in jmaster.add_executors(1)])
    for ours, theirs in zip(evals, ref):
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert abs(ours[k] - theirs[k]) <= EVAL_ATOL, (k, ours, theirs)


def test_no_chain_without_period(tmp_path):
    server, (res,) = serve(str(tmp_path), job("plain", 1, period=0))
    assert "model_chkp_ids" not in res
    assert server.eval_results == {}


def test_eval_failure_recorded_not_raised(tmp_path):
    config = job("broken-eval", 1, offline=True,
                 test_data_fn="harmony_tpu_torch.apps.mlr:no_such_fn")
    server, (res,) = serve(str(tmp_path), config)
    assert len(res["model_chkp_ids"]) == 1
    assert "AttributeError" in server.eval_results["broken-eval"]["error"]


def test_sparse_deferred_eval_at_shutdown(tmp_path):
    """A hash-backed FM's chain is evaluated through evaluate_sparse."""
    root = str(tmp_path)
    server, (res,) = serve(root, job("sp-ev", 4, period=2, offline=True, app="fm"))
    assert len(res["model_chkp_ids"]) == 2
    evals = server.eval_results["sp-ev"]
    assert isinstance(evals, list) and len(evals) == 2, evals
    assert evals[-1]["loss"] < evals[0]["loss"]
    assert chain_dirs(root, "sp-ev") == []


def test_cli_runs_a_chain_with_offline_eval(capsys):
    assert cli.main(["run", "mlr", "--device", "cpu", "--epochs", "2", "--batches", "2",
                     "--model-chkp-period", "1", "--offline-eval",
                     "--data", "n=256"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["result"]["model_chkp_ids"]) == 2
    assert len(out["offline_eval"]) == 2 and out["offline_eval"][-1]["loss"] > 0


@pytest.mark.parametrize("argv, msg", [
    (["run", "mlr", "--device", "cpu", "--offline-eval"], "needs --model-chkp-period"),
    (["run", "pagerank", "--device", "cpu", "--model-chkp-period", "1"], "dolphin"),
    (["run", "pagerank", "--device", "cpu", "--offline-eval"], "dolphin"),
])
def test_cli_refuses_chain_flags_as_the_reference_does(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        cli.main(argv)


# -- resume from the chain ----------------------------------------------------


def test_resume_is_bit_identical_and_matches_the_reference(tmp_path):
    root, ref_root = str(tmp_path / "port"), str(tmp_path / "ref")
    _, (whole, first) = serve(root, job("wd-whole", 2, app="wd"), job("wd-resumed", 1, app="wd"))
    _, (resumed,) = serve(root, job("wd-resumed", 2, app="wd", resume_from_chain=True))
    w = worker_result(resumed)
    assert w["starting_epoch"] == 1 and w["epochs_run"] == 1
    assert worker_result(first)["losses"] + w["losses"] == worker_result(whole)["losses"]
    assert newest_table_bits(root, "wd-resumed") == newest_table_bits(root, "wd-whole")
    # the resumed chain continues its numbering past the first run's entry
    assert int(resumed["model_chkp_ids"][0].rsplit("-", 2)[1]) == 2

    server = JaxJobServer(1, device_pool=JaxDevicePool(jax.devices()[:1]), chkp_root=ref_root)
    server.start()
    try:
        server.submit(job("wd-resumed", 1, app="wd", pkg="harmony_tpu")).result(timeout=300)
        ref = server.submit(job("wd-resumed", 2, app="wd", pkg="harmony_tpu",
                                resume_from_chain=True)).result(timeout=300)
    finally:
        server.shutdown(timeout=300)
    (rw,) = ref["workers"].values()
    assert rw["starting_epoch"] == 1
    assert abs(rw["losses"][0] - w["losses"][0]) <= LOSS_ATOL


def test_resume_falls_back_past_a_torn_block_from_the_fault_plan(tmp_path):
    """``disk.write`` -> ``corrupt`` tears block 0 of the resumed run's first
    (newest) entry; the next resume quarantines it and continues from the
    entry before, one epoch earlier, to the same table."""
    root = str(tmp_path)
    serve(root, job("wd-f", 1, app="wd"))
    faults.arm(FaultPlan([FaultRule("disk.write", match={"kind": "chkp.block", "block": 0},
                                    action="corrupt")]))
    try:
        serve(root, job("wd-f", 2, app="wd", resume_from_chain=True))
    finally:
        faults.disarm()
    mgr = CheckpointManager.for_job(root, "wd-f")
    ids = mgr.list_checkpoints()
    assert len(ids) == 2
    _, (again,) = serve(root, job("wd-f", 2, app="wd", resume_from_chain=True))
    assert worker_result(again)["starting_epoch"] == 1
    assert len(mgr.list_checkpoints()) == 2  # one quarantined, one new
    assert any(d.endswith(".quarantined") for d in os.listdir(mgr.commit_root))
    _, (whole,) = serve(root, job("wd-f-whole", 2, app="wd"))
    assert newest_table_bits(root, "wd-f") == newest_table_bits(root, "wd-f-whole")


def test_resume_quarantines_a_flipped_block_and_a_torn_manifest(tmp_path):
    root = str(tmp_path)
    _, (res,) = serve(root, job("mlr-c", 3))
    mgr = CheckpointManager.for_job(root, "mlr-c")
    e0, e1, e2 = res["model_chkp_ids"]
    blk = os.path.join(mgr.commit_root, e2, "1.blk")
    raw = bytearray(open(blk, "rb").read())
    raw[len(raw) // 2] ^= 0x10
    open(blk, "wb").write(bytes(raw))
    with open(os.path.join(mgr.commit_root, e1, "manifest.json"), "r+") as f:
        f.truncate(25)
    _, (resumed,) = serve(root, job("mlr-c", 3, resume_from_chain=True))
    assert worker_result(resumed)["starting_epoch"] == 1  # e2 and e1 gone, e0 restored
    names = os.listdir(mgr.commit_root)
    assert f"{e2}.quarantined" in names and f"{e1}.quarantined" in names
    assert e1 not in mgr.list_checkpoints() and e2 not in mgr.list_checkpoints()
    assert e0 in mgr.list_checkpoints()


def test_resume_refusals(tmp_path):
    with pytest.raises(ValueError, match="chkp_root"):
        DolphinJobEntity(job("x", 1, resume_from_chain=True)).setup(
            ETMaster(DevicePool([torch.device("cpu")])), [])
    master = ETMaster(DevicePool([torch.device("cpu")]))
    ids = [e.id for e in master.add_executors(1)]
    with pytest.raises(ValueError, match="no epoch-tagged"):
        DolphinJobEntity(job("y", 1, resume_from_chain=True),
                         chkp_root=str(tmp_path)).setup(master, ids)
    nmf = JobConfig(job_id="nmf", app_type="dolphin",
                    trainer="harmony_tpu_torch.apps.nmf:NMFTrainer",
                    params=TrainerParams(app_params={"num_rows": 8, "num_cols": 8, "rank": 2}),
                    user={"data_fn": "harmony_tpu_torch.apps.nmf:make_synthetic",
                          "data_args": {"num_rows": 8, "num_cols": 8, "rank": 2},
                          "resume_from_chain": True})
    with pytest.raises(ValueError, match="worker-local"):
        DolphinJobEntity(nmf, chkp_root=str(tmp_path)).setup(master, ids)


# -- epoch cuts -----------------------------------------------------------------


@pytest.mark.parametrize("app", ["mlr", "wd"])
def test_each_snapshot_holds_its_own_epochs_table(tmp_path, app):
    """A worker outside the JobServer runs fused windows of several epochs;
    a chain hook (not deferrable) cuts them to one epoch, so the snapshot at
    epoch e equals the table after an (e + 1)-epoch run."""
    epochs = 3
    master = ETMaster(DevicePool([torch.device("cpu")]))
    ids = [e.id for e in master.add_executors(1)]
    mgr = CheckpointManager(str(tmp_path / "t"), str(tmp_path / "c"))

    def table_after(n, chain=False):
        entity = DolphinJobEntity(job(f"{app}-{n}-{chain}", n, period=0, app=app))
        entity.setup(master, ids)
        try:
            hook = None
            if chain:
                handle = TableHandle(master, entity._table, ids)
                hook = ModelChkpManager(mgr, handle, period=1)
            worker = entity.make_worker(epoch_callback=hook.on_epoch if hook else None)
            result = worker.run()
            return result, hook, entity._table.pull_array().numpy().tobytes()
        finally:
            entity.cleanup()

    result, chain, final = table_after(epochs, chain=True)
    assert result["windows"] == [1] * epochs
    assert table_after(epochs)[0]["windows"] != [1] * epochs  # windows without a chain
    restored = []
    for cid in chain.drain():
        h = mgr.restore(master, cid, ids)
        restored.append(h.table.pull_array().numpy().tobytes())
        h.drop()
    for e in range(epochs):
        assert restored[e] == table_after(e + 1)[2], f"epoch {e}"
    assert restored[-1] == final
