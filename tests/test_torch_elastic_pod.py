"""Elastic recovery and auto-resume on real pods of processes, on the CPU.

Pods of ``cli start-pod --device cpu`` processes (one CPU slot each) over one
gloo world on a ``FileStore`` (``tests/test_torch_pod.py``'s ``Pod``), their
chains under one shared ``HARMONY_POD_CHKP_ROOT``, faults armed through
``HARMONY_FAULT_PLAN``. MLR with 16 blocks of 16 bytes.

* (a) Kill, then shrink (``pod_carve:1``; a filler takes process 0, so the
  victim lies wholly on process 1, which a ``worker.step`` crash rule kills
  with exit code 86): the same submission completes on process 0 with
  ``auto_resumed == []``, two attempts and one ``elastic_shrink``; its
  restore reads every block (``blocks_local`` 0, 16 blocks, 256 bytes); its
  epochs are the uninterrupted one-slot run's bits and its final loss within
  1e-5 of the reference's uninterrupted in-process ``JobServer`` run of the
  same config on the JAX CPU backend.
* (b) Silence, then shrink, then re-grow, the table split over both
  processes (share-all): a ``pod.heartbeat`` ``skip`` rule mutes process 1
  for a bounded window. The submission shrinks onto process 0, whose restore
  reads exactly the lost half (8 blocks, 128 bytes; the other 8 from its
  recovery cache), and re-grows onto both once the beats resume: process 0
  reads nothing (its cache holds the fence entry), process 1 its 8 blocks.
  Three attempts, the pod's whole event arc, the final attempt starting one
  epoch after the re-grow fence, and the uninterrupted run's bits.
* A plan with ``elastic_fence`` sent to a job no elastic loop owns ends the
  job with the fence's marker (no longer the refusal naming ROADMAP A item 4),
  cleanly.
* ``--auto-resume``: a job killed with its follower is resubmitted with
  ``resume_from_chain`` (``auto_resumed == [job]``) and finishes with the
  uninterrupted bits; a job failing on its own terms is not resubmitted.

Every wait has a deadline, every child process is killed in a ``finally``,
and each pod starts once a module.
"""
import json
import os
import time

import pytest
import torch

from harmony_tpu_torch import faults
from harmony_tpu_torch.config.params import JobConfig, TrainerParams
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.parallel.mesh import DevicePool
from test_torch_pod import DEADLINE, Pod

LOSS_ATOL = 1e-5
MLR = {"num_classes": 4, "num_features": 16, "features_per_partition": 4, "step_size": 0.1}
DATA = {"n": 64, "num_features": 16, "num_classes": 4, "seed": 31}
BLOCK_BYTES = 16   # a block: one row of features_per_partition f32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mlr(job_id, epochs, trainer="harmony_tpu_torch.apps.mlr:MLRTrainer", pkg="harmony_tpu_torch",
        chain=True, **user):
    app = dict(MLR)
    if trainer.startswith("tests."):
        app.update(user.pop("app", {}))
    if pkg == "harmony_tpu":
        from harmony_tpu.config.params import JobConfig as Cfg
        from harmony_tpu.config.params import TrainerParams as Params
    else:
        Cfg, Params = JobConfig, TrainerParams
    return Cfg(job_id=job_id, app_type="dolphin", trainer=trainer,
               params=Params(num_epochs=epochs, num_mini_batches=2,
                             model_chkp_period=1 if chain else 0, app_params=app),
               num_workers=1,
               user={"data_fn": f"{pkg}.apps.mlr:make_synthetic", "data_args": dict(DATA),
                     **user})


_UNINTERRUPTED = {}


def uninterrupted(epochs):
    """The port's uninterrupted run of the config on one CPU slot: its batch
    losses."""
    if epochs not in _UNINTERRUPTED:
        server = JobServer(1, device_pool=DevicePool.virtual("cpu", 1))
        server.start()
        try:
            res = server.submit(mlr("ref", epochs, chain=False)).result(timeout=DEADLINE)
        finally:
            server.shutdown(timeout=DEADLINE)
        (w,) = res["workers"].values()
        _UNINTERRUPTED[epochs] = w["batch_losses"]
    return _UNINTERRUPTED[epochs]


def reference_final_loss(epochs):
    """The reference's uninterrupted in-process JobServer run of the same
    config (the JAX CPU backend): its last epoch's loss."""
    from harmony_tpu.jobserver.server import JobServer as RefServer

    server = RefServer(num_executors=1)
    server.start()
    try:
        res = server.submit(mlr("ref", epochs, pkg="harmony_tpu",
                                trainer="harmony_tpu.apps.mlr:MLRTrainer",
                                chain=False)).result(timeout=DEADLINE)
    finally:
        server.shutdown(timeout=DEADLINE)
    (w,) = res["workers"].values()
    return float(w["losses"][-1])


def start_pod(tmp_path_factory, name, scheduler, rules, hb_timeout="3", hb_period="0.5"):
    tmp = str(tmp_path_factory.mktemp(name))
    plan = faults.FaultPlan([faults.FaultRule(site, **kw) for site, kw in rules])
    pod = Pod(tmp, scheduler=scheduler, env={
        "HARMONY_POD_CHKP_ROOT": os.path.join(tmp, "chains"),
        "HARMONY_POD_HB_TIMEOUT": hb_timeout, "HARMONY_POD_HB_PERIOD": hb_period,
        faults.ENV_VAR: plan.to_json()})
    pod.root = os.path.join(tmp, "chains")
    return pod


def close_survivor(pod):
    """Shut a pod down whose follower died: the leader must exit 0; returns
    what it prints as it closes."""
    assert pod.sender.send_shutdown_command().get("ok")
    pod.procs[0].wait(timeout=DEADLINE)
    assert pod.procs[0].returncode == 0, pod.stderr(0)[-3000:]
    prefix = "pod jobserver closed: "
    (line,) = [ln for ln in pod.procs[0].stdout.read().splitlines() if ln.startswith(prefix)]
    return json.loads(line[len(prefix):])


def run_filler_and(pod, cfg):
    """A one-epoch filler takes process 0 first (``pod_carve:1``), so ``cfg``
    lands wholly on process 1; returns ``cfg``'s result (or raises)."""
    filler = mlr("filler", 1, chain=False)
    for c in (filler, cfg):
        reply = pod.sender.send_job_submit_command(c)
        assert reply.get("ok"), reply
    pod.sender.wait_result("filler", timeout=DEADLINE, poll=1.0)
    return pod.sender.wait_result(cfg.job_id, timeout=DEADLINE, poll=1.0)


# -- (a) kill, then shrink ------------------------------------------------------------

KILL_EPOCHS = 12


def test_a_killed_follower_shrinks_the_same_submission_onto_the_survivor(tmp_path_factory):
    pod = start_pod(tmp_path_factory, "kill", "pod_carve:1", [
        ("worker.step", dict(match={"job": "ek", "proc": 1}, after=8, count=1,
                             action="crash", exit_code=86))])
    try:
        # the start lag lets the filler finish before the crash (at epoch 4)
        victim = mlr("ek", KILL_EPOCHS, trainer="tests.torch_pod_trainers:SlowStartMLRTrainer",
                     elastic_shrink=True, app={"start_lag_sec": 1.0})
        res = run_filler_and(pod, victim)
        assert pod.procs[1].wait(timeout=DEADLINE) == 86   # died of the injection
        status = pod.sender.send_status_command()
        closed = close_survivor(pod)
    finally:
        pod.kill()
    assert closed["auto_resumed"] == [] and status["pod"]["auto_resumed"] == []
    meta = res["elastic"]
    assert meta["attempts"] == 2 and [e["kind"] for e in meta["events"]] == ["elastic_shrink"]
    assert meta["events"][0]["procs"] == [0]
    rst = res["elastic_restore"]
    assert rst["partial"] == 1 and rst["kind"] == "shrink" and rst["blocks_local"] == 0
    assert rst["blocks_read"] == rst["blocks_needed"] == rst["lost_block_count"] == 16
    assert rst["bytes_read"] == 16 * BLOCK_BYTES
    (w,) = res["workers"].values()
    assert w["starting_epoch"] == rst["resumed_epoch"] >= 2
    assert w["epochs_run"] == KILL_EPOCHS - w["starting_epoch"]
    assert w["batch_losses"] == uninterrupted(KILL_EPOCHS)[2 * w["starting_epoch"]:]
    assert abs(w["losses"][-1] - reference_final_loss(KILL_EPOCHS)) < LOSS_ATOL
    kinds = [e["kind"] for e in closed["elastic_events"]]
    assert "follower_death" in kinds and "elastic_shrink" in kinds
    assert [e["kind"] for e in closed["job_events"]["ek"]].count("elastic_restore") == 1


# -- (b) silence, shrink, re-grow; and a fence to a job no loop owns --------------------

SPLIT_EPOCHS = 130


@pytest.fixture(scope="module")
def split_pod(tmp_path_factory):
    # process 1's beacon goes mute 4 beats into its first job (until its
    # second starts), for 28 beats (7 s at 0.25 s): past the 2 s timeout, the
    # shrink fence's 10 epochs and the restore, with the shrunk attempt far
    # from its end
    pod = start_pod(tmp_path_factory, "split", "share_all", [
        ("pod.heartbeat", dict(match={"pid": 1, "jobs_started": 1}, after=4, count=28,
                               action="skip"))], hb_timeout="2", hb_period="0.25")
    try:
        yield pod
    finally:
        pod.kill()


def test_silence_shrinks_onto_the_survivor_then_regrows_to_the_original(split_pod):
    pod = split_pod
    victim = mlr("es", SPLIT_EPOCHS, trainer="tests.torch_pod_trainers:SlowEpochsMLR",
                 elastic_shrink=True, app={"epoch_lag_sec": 0.1})
    assert pod.sender.send_job_submit_command(victim).get("ok")
    res = pod.sender.wait_result("es", timeout=2 * DEADLINE, poll=1.0)
    status = pod.sender.send_status_command()
    meta = res["elastic"]
    assert [e["kind"] for e in meta["events"]] == ["elastic_shrink", "elastic_regrow"], meta
    assert meta["attempts"] == 3
    shrink, regrow = meta["events"]
    assert shrink["procs"] == [0] and shrink["lost_executors"] == ["executor-1"]
    assert regrow["procs"] == [0, 1]
    assert regrow["executors"] == ["executor-0", "executor-1"]   # the original layout
    pod_kinds = [e["kind"] for e in status["elastic"]["events"]]
    for k in ("follower_silenced", "elastic_shrink_fence", "follower_rehabilitated",
              "elastic_regrow_fence", "elastic_shrink", "elastic_regrow"):
        assert k in pod_kinds, (k, pod_kinds)
    reps = status["pod"]["reports"]
    # the shrink's restore on the survivor: exactly the lost half from storage
    (s_rep,) = reps["es@a1"].values()
    srst = s_rep["elastic_restore"]
    assert srst["blocks_needed"] == 16 and srst["blocks_local"] == 8
    assert srst["blocks_read"] == 8 and srst["bytes_read"] == 8 * BLOCK_BYTES
    assert srst["lost_block_count"] == 8
    # the re-grow: the survivor's cache holds the fence entry, the returning
    # process (whose cache is older) reads its half
    r0, r1 = reps["es@a2"]["0"]["elastic_restore"], reps["es@a2"]["1"]["elastic_restore"]
    assert r0["kind"] == r1["kind"] == "regrow" and r0["chkp_id"] == r1["chkp_id"]
    assert (r0["blocks_local"], r0["blocks_read"]) == (8, 0)
    assert (r1["blocks_local"], r1["blocks_read"], r1["bytes_read"]) == (0, 8, 8 * BLOCK_BYTES)
    fences = {e["kind"]: e["epoch"] for e in status["elastic"]["events"]
              if e["kind"].endswith("_fence")}
    (w,) = res["workers"].values()
    assert w["starting_epoch"] == res["elastic_restore"]["resumed_epoch"] \
        == fences["elastic_regrow_fence"] + 1
    assert 0 < srst["resumed_epoch"] == fences["elastic_shrink_fence"] + 1 < w["starting_epoch"]
    assert w["epochs_run"] == SPLIT_EPOCHS - w["starting_epoch"]
    full = uninterrupted(SPLIT_EPOCHS)
    assert w["batch_losses"] == full[2 * w["starting_epoch"]:]
    assert s_rep["workers"]["es/w0"]["batch_losses"] == \
        full[2 * srst["resumed_epoch"]:2 * w["starting_epoch"]]


def test_an_elastic_fence_ends_a_job_no_elastic_loop_owns(split_pod):
    """The fence a leader would send (scheduled in every process by the
    trainer) reaches a job that is not elastic: the attempt ends with the
    fence's marker in each process, and the job fails cleanly."""
    pod = split_pod
    cfg = mlr("fenced", 12, trainer="tests.torch_pod_trainers:FenceAtMLR", chain=False,
              app={"fence_epoch": 3})
    assert pod.sender.send_job_submit_command(cfg).get("ok")
    with pytest.raises(RuntimeError, match="ElasticFence: elastic shrink fence at epoch 3"):
        pod.sender.wait_result("fenced", timeout=DEADLINE, poll=1.0)
    (reps,) = pod.reports(["fenced"]).values()
    assert reps["1"]["elastic_fence"] == "shrink" and "ROADMAP" not in reps["1"]["error"]
    assert "ElasticFence" in reps["0"]["error"]
    status = pod.sender.send_status_command()
    assert status["pod"]["broken"] is None and status["pod"]["auto_resumed"] == []
    assert not [e for e in status["elastic"]["events"] if e.get("job_id") == "fenced"]


# -- --auto-resume -------------------------------------------------------------------


def test_auto_resume_resubmits_a_killed_job_and_only_on_infra_evidence(tmp_path_factory):
    pod = start_pod(tmp_path_factory, "autoresume", "pod_carve:1", [
        ("worker.step", dict(match={"job": "ar", "proc": 1}, after=8, count=1,
                             action="crash", exit_code=86))])
    try:
        cfg = mlr("ar", KILL_EPOCHS, trainer="tests.torch_pod_trainers:SlowStartMLRTrainer",
                  auto_resume=True, app={"start_lag_sec": 1.0})
        with pytest.raises(RuntimeError, match="never reported"):
            run_filler_and(pod, cfg)
        assert pod.procs[1].wait(timeout=DEADLINE) == 86
        deadline = time.monotonic() + DEADLINE
        while pod.sender.send_status_command()["pod"]["auto_resumed"] != ["ar"]:
            assert time.monotonic() < deadline, "never auto-resumed"
            time.sleep(0.2)
        res = pod.sender.wait_result("ar", timeout=DEADLINE, poll=1.0)
        (w,) = res["workers"].values()
        assert w["starting_epoch"] >= 2
        assert w["batch_losses"] == uninterrupted(KILL_EPOCHS)[2 * w["starting_epoch"]:]
        # a job failing on its own terms (too few examples) is not resubmitted
        bad = mlr("ar-bad", 2, auto_resume=True)
        bad.user["data_args"] = dict(DATA, n=1)
        assert pod.sender.send_job_submit_command(bad).get("ok")
        with pytest.raises(RuntimeError, match="cannot feed"):
            pod.sender.wait_result("ar-bad", timeout=DEADLINE, poll=1.0)
        closed = close_survivor(pod)
    finally:
        pod.kill()
    assert closed["auto_resumed"] == ["ar"]
