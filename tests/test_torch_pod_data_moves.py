"""Moves, optimizer plans and elastic recovery of a job at data axis 2 whose
rows lie in different processes of the port's pod, on the CPU.

Pods of two ``cli start-pod --device cpu,cpu`` processes (two CPU slots a
process: executor-0 and -1 on process 0, -2 and -3 on process 1), so a
data-2 job on the four executors is (data 2, model 2) with a row in each
process. The yardstick of every leg is the port's one process on four
virtual CPU slots (``tests/test_torch_dp_moves.py`` holds that leg to the
reference): the same job with the same plans at the same epochs, applied
through the same chief hook (``DolphinJobEntity._make_pod_plan_hook``).

* ``POD_RESHARD`` (Wide&Deep and NMF, a host sleep before the first epoch so
  the plans land at epochs 9, 11 and 13): a block from executor-1 to
  executor-0 (the rows kept), executor-3 drained onto executor-0 (three
  owners: data 1, one row over both processes), and a block back onto
  executor-3 (data 2 again). In both processes: the one-process run's
  per-batch losses and applied plans, its owned blocks of the model and
  local tables (joined over the processes), every replica of every block in
  every slot alike, no batch restaged (the plans land at epoch boundaries),
  and the rows each epoch computed: the process's own row, then row 0 of
  the data-1 mesh, then its own again.
* The optimizer (``tests/torch_pod_trainers.py:MoveOncePodOptimizer`` on the
  leader, its plan through the pod's ``plan_sink``): one applied plan, alike
  in both processes, and the bits of the one-process run that replays it at
  its epoch.
* Elastic recovery: process 1 killed at a step of a data-2 job over both
  processes (a ``worker.step`` crash rule, as phase 3el (a)); the same
  submission finishes on process 0's two slots, (data 2, model 1), with the
  uninterrupted run's bits, its ``restore_partial`` reading no block from
  storage (process 0 owned every block, so its recovery cache holds them).
  Process 1 muted instead (a ``pod.heartbeat`` skip rule, as phase 3el
  (b)): the job shrinks onto process 0 and re-grows onto both, the
  uninterrupted bits throughout; the returning process reads its blocks.
* The reference's own two-process pod (two virtual devices a process,
  ``tests/pod_worker.py``) at data 2: Wide&Deep with the first two plans
  (the rows kept, then data 1) gives the same applied plans as the port's
  and every epoch's loss within ``LOSS_ATOL`` = 1e-5 (f32 sums in another
  order in the two frameworks); with the third plan (back to data 2) the
  reference's job fails (its comm probe meets a batch on the old mesh:
  ROADMAP C's known differences), where the port's gives the one-process
  bits above.

Every socket binds port 0 with a timeout, every wait has a deadline, and
every child process is killed in a ``finally``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from harmony_tpu_torch import faults
from harmony_tpu_torch.jobserver import podplan
from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.runtime.master import ETMaster
from test_torch_elastic_pod import close_survivor
from test_torch_pod import DEADLINE, Pod
from test_torch_pod_data import APPS, job
from test_torch_pod_moves import reshard
from torch_pod_trainers import kept_replicas, kept_tables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL = 1e-5
EPOCHS = 16
START_LAG = 3.0
# (src, dst, blocks, epoch): the rows kept, then data 1, then data 2 again
PLANS = (("executor-1", "executor-0", 1, 9), ("executor-3", "executor-0", 1024, 11),
         ("executor-0", "executor-3", 1, 13))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def dx_job(app, keep, job_id, epochs=EPOCHS, **app_params):
    cfg = job(app, keep, job_id=job_id, epochs=epochs)
    return cfg.replace(params=cfg.params.replace(app_params={**cfg.params.app_params,
                                                             **app_params}))


def replay(cfg, plans):
    """The job in one process on four virtual CPU slots with ``plans``
    (dicts as ``POD_RESHARD`` sends them) applied at its chief hook, per-batch
    epochs as under a JobServer: (worker result, applied plans)."""
    cfg = cfg.replace(params=cfg.params.replace(app_params={
        **cfg.params.app_params, "start_lag_sec": 0.0, "epoch_lag_sec": 0.0}))
    master = ETMaster(DevicePool.virtual("cpu", 4))
    ent = DolphinJobEntity(cfg)
    ent.setup(master, [e.id for e in master.add_executors(4)])
    for p in plans:
        podplan.schedule(cfg.job_id, dict(p))
    try:
        res = ent.make_worker(epoch_callback=ent._make_pod_plan_hook(),
                              batch_barrier=lambda i: False).run()
    finally:
        ent.cleanup()
        podplan.clear(cfg.job_id)
    return res, list(ent._applied_plans)


def num_blocks(app):
    import torch_pod_trainers

    trainer, _, app_params, _ = APPS[app]
    kept = getattr(torch_pod_trainers, f"Kept{trainer}")(**app_params)
    return kept.model_table_config().num_blocks


def held_by_process(owners, data, nb, per=2):
    """Process -> the blocks its slots hold when executors ``owners`` (in
    mesh order, ``per`` a process) carry the table at ``data`` rows: the
    row-major (data, model) mesh, each model coordinate a contiguous run
    when the blocks divide over the model axis, else every block."""
    m = len(owners) // data
    out = {}
    for i, e in enumerate(owners):
        k = i % m
        blocks = range(k * nb // m, (k + 1) * nb // m) if nb % m == 0 else range(nb)
        out.setdefault(e // per, set()).update(blocks)
    return out


def _worker(report):
    (w,) = report["workers"].values()
    return w


def assert_replicas_alike(keep, job_id):
    """Every slot's copy of each block is the owned copy, byte for byte."""
    owned, replicas = kept_tables(keep, job_id), kept_replicas(keep, job_id)
    assert replicas and set(replicas) <= set(owned)
    for key, digests in replicas.items():
        assert set(digests) == {owned[key]}, key


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    pod = Pod(str(tmp_path_factory.mktemp("dxmoves")), devices="cpu,cpu",
              env={"HARMONY_POD_MOVE_TIMEOUT": "60"})
    try:
        yield pod
        pod.finish()
    finally:
        pod.kill()


@pytest.mark.parametrize("app", ["wd", "nmf"])
def test_plans_that_keep_and_change_the_rows_are_the_one_process_bits(pod, app,
                                                                      tmp_path_factory):
    jid = f"{app}-dx-moved"
    keep = str(tmp_path_factory.mktemp(f"pod-{app}"))
    cfg = dx_job(app, keep, jid, start_lag_sec=START_LAG)
    assert pod.sender.send_job_submit_command(cfg).get("ok")
    for i, plan in enumerate(PLANS):
        reply = reshard(pod.sender, jid, *plan, retry=i == 0)
        assert reply.get("ok"), reply
    pod.sender.wait_result(jid, timeout=DEADLINE, poll=1.0)
    reps = pod.reports([jid])[jid]
    one_keep = str(tmp_path_factory.mktemp(f"one-{app}"))
    want, applied = replay(dx_job(app, one_keep, jid), [
        {"epoch": e, "src": s, "dst": d, "num_blocks": n} for s, d, n, e in PLANS])
    assert [(p["epoch"], p["moved"] > 0, p["owners_after"]) for p in applied] == [
        (9, True, 4), (11, True, 3), (13, True, 4)]
    assert sorted(reps) == ["0", "1"]
    for pid, r in reps.items():
        assert r["ok"], r
        w = _worker(r)
        assert w["batch_losses"] == want["batch_losses"]
        assert r["applied_plans"] == applied and w["restaged_batches"] == 0
        # a process's own row, row 0 of the data-1 mesh, its own row again
        # (process 0 computed row 0 throughout: one list)
        own = [int(pid)]
        by_epoch = [own] * 12 + [[0]] * 2 + [own] * 2
        assert w["data_rows"] == (own if pid == "0" else by_epoch)
        assert [m["epoch"] for m in r["plan_moves"]] == [11, 13]
    # each process's side of the two exchanges: what its slots hold after
    # that they did not before (a row is a whole replica, so at data 2 each
    # process holds every block and the drain moves none)
    nb = num_blocks(app)
    layouts = [((0, 1, 2, 3), 2), ((0, 1, 2), 1), ((0, 1, 2, 3), 2)]
    for k, (before, after) in enumerate(zip(layouts, layouts[1:])):
        old, new = held_by_process(*before, nb), held_by_process(*after, nb)
        for p in (0, 1):
            assert reps[str(p)]["plan_moves"][k]["blocks_received"] == len(new[p] - old[p])
    assert kept_tables(keep, jid) == kept_tables(one_keep, jid)
    assert_replicas_alike(keep, jid)


def test_the_optimizer_moves_a_data_2_job_through_the_plan_channel(pod, tmp_path_factory):
    jid = "wd-dx-optimized"
    keep = str(tmp_path_factory.mktemp("pod-opt"))
    cfg = dx_job("wd", keep, jid, epochs=24, epoch_lag_sec=0.1).replace(
        optimizer="tests.torch_pod_trainers:MoveOncePodOptimizer", optimizer_period=0.3)
    assert pod.sender.send_job_submit_command(cfg).get("ok")
    result = pod.sender.wait_result(jid, timeout=DEADLINE, poll=1.0)
    assert result["reconfigs"] == 1 and "optimizer_errors" not in result, result
    (applied,) = result["applied_plans"]
    assert applied["src"] == "executor-3" and applied["moved"] > 0, applied
    assert applied["owners_after"] == 4, applied
    reps = pod.reports([jid])[jid]
    one_keep = str(tmp_path_factory.mktemp("one-opt"))
    want, replayed = replay(cfg.replace(optimizer=None, params=cfg.params.replace(
        app_params={**cfg.params.app_params, "keep_dir": one_keep})),
        [{"epoch": applied["epoch"], "src": applied["src"], "dst": applied["dst"],
          "num_blocks": applied["moved"]}])
    assert replayed == [applied]
    for r in reps.values():
        assert r["ok"] and r["applied_plans"] == [applied], r
        assert _worker(r)["batch_losses"] == want["batch_losses"]
    assert kept_tables(keep, jid) == kept_tables(one_keep, jid)


# -- elastic recovery ----------------------------------------------------------------

KILL_EPOCHS = 8


def uninterrupted(keep, epochs):
    res, _ = replay(dx_job("wd", keep, "wd-dx-ref", epochs=epochs), [])
    return res["batch_losses"]


def elastic_pod(tmp_path_factory, name, rules, hb_timeout="3", hb_period="0.5"):
    tmp = str(tmp_path_factory.mktemp(name))
    plan = faults.FaultPlan([faults.FaultRule(site, **kw) for site, kw in rules])
    pod = Pod(tmp, devices="cpu,cpu", env={
        "HARMONY_POD_CHKP_ROOT": os.path.join(tmp, "chains"),
        "HARMONY_POD_HB_TIMEOUT": hb_timeout, "HARMONY_POD_HB_PERIOD": hb_period,
        faults.ENV_VAR: plan.to_json()})
    return pod


def test_a_killed_follower_of_a_data_2_job_finishes_on_the_leaders_rows(tmp_path_factory):
    keep = str(tmp_path_factory.mktemp("kill-keep"))
    pod = elastic_pod(tmp_path_factory, "dx-kill", [
        ("worker.step", dict(match={"job": "wd-dx-killed", "proc": 1}, after=4 * 4, count=1,
                             action="crash", exit_code=86))])
    try:
        cfg = dx_job("wd", keep, "wd-dx-killed", epochs=KILL_EPOCHS, start_lag_sec=1.0)
        cfg = cfg.replace(params=cfg.params.replace(model_chkp_period=1))
        cfg.user["elastic_shrink"] = True
        assert pod.sender.send_job_submit_command(cfg).get("ok")
        res = pod.sender.wait_result(cfg.job_id, timeout=DEADLINE, poll=1.0)
        assert pod.procs[1].wait(timeout=DEADLINE) == 86
        close_survivor(pod)
    finally:
        pod.kill()
    meta = res["elastic"]
    assert meta["attempts"] == 2 and [e["kind"] for e in meta["events"]] == ["elastic_shrink"]
    assert meta["events"][0]["procs"] == [0]
    assert meta["events"][0]["executors"] == ["executor-0", "executor-1"]
    rst = res["elastic_restore"]
    # process 0 owned every block (row 0 holds them all, the lowest-owner
    # rule), so its recovery cache holds the whole entry: nothing is read
    assert rst["partial"] == 1 and rst["blocks_read"] == rst["bytes_read"] == 0
    assert rst["blocks_local"] == rst["blocks_needed"] == rst["blocks_total"]
    w = _worker(res)
    assert w["mesh"] == {"data": 2, "model": 1} and w["data_rows"] == [0, 1]
    s = w["starting_epoch"]
    assert s == rst["resumed_epoch"] >= 2
    assert w["batch_losses"] == uninterrupted(keep, KILL_EPOCHS)[4 * s:]


SPLIT_EPOCHS = 110


def test_silence_shrinks_a_data_2_job_and_regrows_it_to_the_original_layout(tmp_path_factory):
    keep = str(tmp_path_factory.mktemp("mute-keep"))
    # process 1's beacon goes mute 4 beats into the job, for 28 beats (7 s
    # at 0.25 s): past the 2 s timeout, the shrink fence and the restore
    pod = elastic_pod(tmp_path_factory, "dx-mute", [
        ("pod.heartbeat", dict(match={"pid": 1, "jobs_started": 1}, after=4, count=28,
                               action="skip"))], hb_timeout="2", hb_period="0.25")
    try:
        cfg = dx_job("wd", keep, "wd-dx-muted", epochs=SPLIT_EPOCHS, epoch_lag_sec=0.1)
        cfg = cfg.replace(params=cfg.params.replace(model_chkp_period=1))
        cfg.user["elastic_shrink"] = True
        assert pod.sender.send_job_submit_command(cfg).get("ok")
        res = pod.sender.wait_result(cfg.job_id, timeout=2 * DEADLINE, poll=1.0)
        status = pod.sender.send_status_command()
        pod.finish()
    finally:
        pod.kill()
    meta = res["elastic"]
    assert [e["kind"] for e in meta["events"]] == ["elastic_shrink", "elastic_regrow"], meta
    shrink, regrow = meta["events"]
    # the shrink onto process 0's two slots: (data 2, model 1)
    assert shrink["procs"] == [0] and shrink["executors"] == ["executor-0", "executor-1"]
    assert regrow["procs"] == [0, 1]
    assert regrow["executors"] == ["executor-0", "executor-1", "executor-2", "executor-3"]
    reps = status["pod"]["reports"]
    (s_rep,) = reps["wd-dx-muted@a1"].values()
    assert s_rep["elastic_restore"]["blocks_read"] == 0
    r1 = reps["wd-dx-muted@a2"]["1"]["elastic_restore"]
    assert r1["kind"] == "regrow" and r1["blocks_read"] > 0
    w = _worker(res)
    assert w["mesh"] == {"data": 2, "model": 2}
    full = uninterrupted(keep, SPLIT_EPOCHS)
    srst = s_rep["elastic_restore"]
    assert w["batch_losses"] == full[4 * w["starting_epoch"]:]
    assert _worker(s_rep)["batch_losses"] == \
        full[4 * srst["resumed_epoch"]:4 * w["starting_epoch"]]


# -- against the reference's own pod --------------------------------------------------

REF_EPOCHS = 20
REF_PLANS = (("executor-1", "executor-0", 1, 10), ("executor-3", "executor-0", 1024, 12))
REF_REFILL = ("executor-0", "executor-3", 1, 14)


def test_a_data_2_pod_reshard_is_near_the_references_pod(pod, tmp_path_factory):
    from benchmarks.common import free_port, sanitized_cpu_env, wait_for_ready
    from harmony_tpu.jobserver.client import CommandSender as RefSender
    from test_torch_pod_data import ref_job

    coord, pod_port, tcp_port = free_port(), free_port(), free_port()
    worker = os.path.join(REPO, "tests", "pod_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, f"127.0.0.1:{coord}", "2", str(p),
                               str(pod_port), str(tcp_port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(sanitized_cpu_env(2), OMP_NUM_THREADS="1"))
             for p in range(2)]
    try:
        assert wait_for_ready(procs[0], DEADLINE), "the reference's pod never became ready"
        sender = RefSender(tcp_port)
        for jid, plans in (("wd-ref-moved", REF_PLANS),
                           ("wd-ref-refilled", REF_PLANS + (REF_REFILL,))):
            cfg = ref_job("wd", REF_EPOCHS)
            cfg.job_id = jid
            assert sender.send_job_submit_command(cfg).get("ok")
            for i, plan in enumerate(plans):
                reply = reshard(sender, jid, *plan, retry=i == 0)
                assert reply.get("ok"), reply
            deadline = time.monotonic() + DEADLINE
            while sender.send_status_command().get("running"):
                assert time.monotonic() < deadline, "the reference's pod never drained"
                time.sleep(0.3)
        sender.send_shutdown_command()
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=DEADLINE)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    (line,) = [ln for ln in outs[0].splitlines() if ln.startswith("RESULT ")]
    results = json.loads(line[len("RESULT "):])["local_results"]
    ref, refilled = results["wd-ref-moved"], results["wd-ref-refilled"]
    assert "incompatible devices" in refilled.get("error", ""), refilled
    assert "error" not in ref, ref
    (want,) = [w["losses"] for w in ref.values() if isinstance(w, dict) and "losses" in w]

    jid = "wd-dx-vs-ref"
    keep = str(tmp_path_factory.mktemp("vs-ref"))
    cfg = dx_job("wd", keep, jid, epochs=REF_EPOCHS, start_lag_sec=START_LAG)
    assert pod.sender.send_job_submit_command(cfg).get("ok")
    for i, plan in enumerate(REF_PLANS):
        reply = reshard(pod.sender, jid, *plan, retry=i == 0)
        assert reply.get("ok"), reply
    pod.sender.wait_result(jid, timeout=DEADLINE, poll=1.0)
    reps = pod.reports([jid])[jid]

    def key(plans):
        return [(p["epoch"], p["moved"], p["owners_after"], p.get("skipped")) for p in plans]

    assert key(ref["applied_plans"]) == [(10, 1, 4, None), (12, 64, 3, None)]
    for r in reps.values():
        assert r["ok"] and key(r["applied_plans"]) == key(ref["applied_plans"]), r
        np.testing.assert_allclose(_worker(r)["losses"], want, rtol=0, atol=LOSS_ATOL)
