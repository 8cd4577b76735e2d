"""Plans on the port's pod (``POD_RESHARD``, ``schedule_pod_reshard``, the
chief's epoch hook, the optimizer's plan channel) on the CPU.

Pods of two ``cli start-pod --device cpu,cpu`` processes (two CPU slots a
process, so four executors: executor-0 and -1 on process 0, -2 and -3 on
process 1) over one gloo world on a ``FileStore``. The jobs are the apps of
``tests/test_torch_pod.py`` with a host sleep before their first epoch
(``tests/torch_pod_trainers.py``), so the plans reach them at observed epoch
0 and the first lands at the smallest legal epoch, ``EPOCH_WINDOW`` + 1 = 9.

* MLR, Wide&Deep and FM (a hash table): executor-3 drains onto executor-0 at
  epoch 9, a block grows back onto it at 11, it drains again at 13, and a
  drain of executor-2 at 13, which would leave process 1 owning nothing, is
  skipped and recorded. ``applied_plans`` is the reference's
  ``test_pod_live_grow_mid_training``'s shape, the same in both processes,
  and both processes' batch losses are the unmoved run's bits (the port's one
  process on a virtual mesh of four CPU slots). Each process's side of the
  three exchanges (``plan_moves``) is what the layouts before and after give:
  blocks received, wire bytes as blocks times ``block_nbytes``, the sends
  summing to the receives, and the first drain crossing processes.
* A plan inside the window horizon is refused naming it; a plan for an
  unknown job is answered with an error; a job wholly on the follower
  (``pod_carve:1``) is held to its chief's observed epoch (PROGRESS_REQ),
  and a PROGRESS_REP that comes after its query gave up is dropped, never
  answering a later query.
* Two slots of one card in a process share it with no other process: such
  pods take NCCL.
* A two-worker SSP job with a plan gives the one-process ``force_lockstep``
  run's losses, every worker.
* The optimizer loop runs on the leader and its one move-only plan lands in
  both processes (``reconfigs`` 1, one applied plan, the losses alike); a plan
  that deletes an executor, or lands past the job's end, is declined.
* Against the reference's own two-process pod (one device a process,
  ``tests/pod_worker.py``), the same MLR job and the same plans:
  ``applied_plans`` (epoch, moved, owners_after) equal, every epoch's loss
  within ``LOSS_ATOL`` = 1e-5 (f32 sums taken in another order in the two
  frameworks, as ``tests/test_torch_pod.py`` allows).
* ``cli pod-reshard`` prints the server's reply.

Every wait has a deadline and every child process is killed in a
``finally``; each pod starts once a module.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from harmony_tpu_torch.config.params import JobConfig, TrainerParams
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.parallel.mesh import DevicePool
from test_torch_pod import APPS, DEADLINE, LOSS_ATOL, Pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPERS = "tests.torch_pod_trainers"
SLOW = {"mlr": "SlowStartMLRTrainer", "wd": "SlowStartWideDeepTrainer",
        "fm": "SlowStartFMTrainer"}
START_LAG = 3.0
EPOCHS = 14


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def slow_job(app, job_id, epochs=EPOCHS, workers=1, lockstep=False, slack=0, lag=START_LAG):
    trainer, data_fn, app_params, data_args = APPS[app]
    return JobConfig(
        job_id=job_id, app_type="dolphin", trainer=f"{HELPERS}:{SLOW[app]}",
        params=TrainerParams(num_epochs=epochs, num_mini_batches=4, clock_slack=slack,
                             app_params={**app_params, "start_lag_sec": lag}),
        num_workers=workers,
        user={"data_fn": f"harmony_tpu_torch.apps.{data_fn}", "data_args": dict(data_args),
              **({"force_lockstep": True} if lockstep else {})})


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    pod = Pod(str(tmp_path_factory.mktemp("moves")), env={"HARMONY_POD_MOVE_TIMEOUT": "60"},
              devices="cpu,cpu")
    try:
        yield pod
        pod.finish()
    finally:
        pod.kill()


def one_process(config, slots=4):
    """The job on one process over a virtual mesh of ``slots`` CPU slots,
    with no plan: each worker's batch losses."""
    server = JobServer(slots, device_pool=DevicePool.virtual("cpu", slots))
    server.start()
    try:
        res = server.submit(config.replace(params=config.params.replace(app_params={
            **config.params.app_params, "start_lag_sec": 0.0}))).result(timeout=DEADLINE)
    finally:
        server.shutdown(timeout=DEADLINE)
    return {w[-2:]: r["batch_losses"] for w, r in res["workers"].items()}


def reshard(sender, job_id, src, dst, blocks, epoch, retry=False):
    """POD_RESHARD; with ``retry``, until the job is dispatched."""
    deadline = time.monotonic() + DEADLINE
    while True:
        reply = sender.send_pod_reshard_command(job_id, src, dst, blocks, epoch)
        if reply.get("ok") or not retry or "unknown" not in reply.get("error", ""):
            return reply
        assert time.monotonic() < deadline, reply
        time.sleep(0.05)


def collect(pod, job_id):
    pod.sender.wait_result(job_id, timeout=DEADLINE, poll=1.0)
    return pod.reports([job_id])[job_id]


def by_worker(report):
    return {w[-2:]: v["batch_losses"] for w, v in report["workers"].items()}


def exchange_by_process(before, after, nb, per=2):
    """Blocks each process receives when a table's owners go from ``before``
    to ``after`` (executor indices in mesh order, ``per`` a process): the
    blocks its new slots hold that its old ones did not, under the even
    layout (contiguous runs when the blocks divide over the owners, else
    every owner holds every block)."""
    def held(owners):
        m, out = len(owners), {}
        for i, e in enumerate(owners):
            blocks = range(i * nb // m, (i + 1) * nb // m) if nb % m == 0 else range(nb)
            out.setdefault(e // per, set()).update(blocks)
        return out

    old, new = held(before), held(after)
    return {p: len(new.get(p, set()) - old.get(p, set())) for p in sorted(set(old) | set(new))}


def num_blocks(app):
    from harmony_tpu_torch.config.base import resolve_symbol

    trainer, _, app_params, _ = APPS[app]
    return resolve_symbol(f"harmony_tpu_torch.apps.{trainer}")(
        **app_params).model_table_config().num_blocks


@pytest.mark.parametrize("app", ["mlr", "wd", "fm"])
def test_pod_reshard_mid_training_moves_and_skips_alike_in_both_processes(pod, app):
    jid = f"{app}-moved"
    assert pod.sender.send_job_submit_command(slow_job(app, jid)).get("ok")
    first = reshard(pod.sender, jid, "executor-3", "executor-0", 1024, 9, retry=True)
    assert first.get("ok"), first
    for src, dst, n, epoch in (("executor-0", "executor-3", 1, 11),
                               ("executor-3", "executor-0", 1024, 13),
                               ("executor-2", "executor-0", 1024, 13)):
        reply = reshard(pod.sender, jid, src, dst, n, epoch)
        assert reply.get("ok"), reply
    reps = collect(pod, jid)
    assert sorted(reps) == ["0", "1"] and all(r["ok"] for r in reps.values()), reps
    applied = reps["0"]["applied_plans"]
    assert reps["1"]["applied_plans"] == applied
    assert [(p["epoch"], p["src"], p["dst"]) for p in applied] == [
        (9, "executor-3", "executor-0"), (11, "executor-0", "executor-3"),
        (13, "executor-3", "executor-0"), (13, "executor-2", "executor-0")]
    drain, grow, again, guarded = applied
    assert drain["moved"] > 0 and drain["owners_after"] == 3, applied
    assert grow["moved"] == 1 and grow["owners_after"] == 4, applied
    assert again["moved"] == 1 and again["owners_after"] == 3, applied
    assert guarded["moved"] == 0 and guarded["owners_after"] == 3, applied
    assert guarded["skipped"] == "process-set change mid-training"
    assert all("skipped" not in p for p in applied[:3])
    want = one_process(slow_job(app, jid))
    for r in reps.values():
        assert by_worker(r) == want
    assert len(want["w0"]) == EPOCHS * 4
    # each process's side of the three exchanges (the skipped plan moves nothing)
    nb, every = num_blocks(app), [0, 1, 2, 3]
    layouts = [(every, every[:3]), (every[:3], every), (every, every[:3])]
    for r in reps.values():
        assert [m["epoch"] for m in r["plan_moves"]] == [9, 11, 13], r["plan_moves"]
    for k, (before, after) in enumerate(layouts):
        want_in = exchange_by_process(before, after, nb)
        sides = [reps[p]["plan_moves"][k] for p in ("0", "1")]
        for p, st in enumerate(sides):
            bnb = st["block_nbytes"]
            assert st["transport"] == "tcp" and st["transport_retries"] == 0, st
            assert st["blocks_received"] == want_in[p], (k, p, st, want_in)
            assert st["bytes_received"] == want_in[p] * bnb, st
            assert st["bytes_sent"] == st["blocks_sent"] * bnb, st
        assert sum(st["blocks_sent"] for st in sides) == sum(want_in.values()) == \
            sides[0]["total_moves"], (k, sides, want_in)
    assert sum(reps[p]["plan_moves"][0]["bytes_received"] for p in ("0", "1")) > 0


def test_a_plan_inside_the_window_horizon_and_an_unknown_job_are_refused(pod):
    jid = "mlr-horizon"
    assert pod.sender.send_job_submit_command(slow_job("mlr", jid, epochs=10)).get("ok")
    reply = reshard(pod.sender, jid, "executor-3", "executor-0", 1, 8, retry=True)
    assert not reply["ok"] and "window horizon" in reply["error"], reply
    reply = pod.sender.send_pod_reshard_command("no-such-job", "executor-3", "executor-0", 1, 30)
    assert not reply["ok"] and "unknown" in reply["error"], reply
    reps = collect(pod, jid)
    assert all(r["ok"] and "applied_plans" not in r for r in reps.values()), reps


def test_a_late_progress_reply_is_dropped_and_never_answers_a_later_query():
    """The leader's PROGRESS_REQ carries a request id, and a reply is taken
    only while its own query waits: the reply of a query that timed out
    (epoch 0) neither lingers nor answers the next query (epoch 12)."""
    from harmony_tpu_torch.jobserver.pod import PodJobServer

    srv = PodJobServer.__new__(PodJobServer)
    srv._pod_cond, srv._reports, srv._dead_followers = threading.Condition(), {}, set()
    srv._progress_waiting, srv._progress_seq = set(), 0
    sent = []
    srv._send_to = lambda pid, msg: sent.append((pid, msg))
    with pytest.raises(RuntimeError, match="did not answer the progress query"):
        srv._query_remote_epoch("job", 1, timeout=0.2)
    ((pid, first),) = sent
    assert pid == 1 and first["cmd"] == "PROGRESS_REQ" and first["job_id"] == "job"
    late = {"cmd": "PROGRESS_REP", "job_id": "job", "epoch": 0, "req": first["req"]}
    srv._on_progress_rep(1, late)
    assert srv._reports == {}

    def answer(pid, msg):
        sent.append((pid, msg))
        srv._on_progress_rep(pid, late)           # the stale reply lands first
        srv._on_progress_rep(pid, {"cmd": "PROGRESS_REP", "job_id": "job", "epoch": 12,
                                   "req": msg["req"]})

    srv._send_to = answer
    assert srv._query_remote_epoch("job", 1, timeout=5.0) == 12
    assert sent[1][1]["req"] != first["req"]
    assert srv._reports == {} and srv._progress_waiting == set()


def test_two_slots_of_one_card_in_a_process_share_it_with_no_other_process():
    from harmony_tpu_torch.parallel import multihost

    assert multihost.choose_backend([["cuda-a", "cuda-a"], ["cuda-b", "cuda-b"]])[0] == "nccl"
    assert multihost.choose_backend([["cuda-a", "cuda-a"], ["cuda-a", "cuda-a"]])[0] == "gloo"
    assert multihost.choose_backend([["cpu", "cpu"], ["cpu", "cpu"]])[0] == "gloo"


def test_a_two_worker_ssp_job_with_a_plan_is_the_lockstep_baseline(pod):
    jid = "wd-2w-moved"
    cfg = slow_job("wd", jid, epochs=12, workers=2, slack=1)
    assert pod.sender.send_job_submit_command(cfg).get("ok")
    reply = reshard(pod.sender, jid, "executor-3", "executor-0", 1024, 9, retry=True)
    assert reply.get("ok"), reply
    reps = collect(pod, jid)
    (applied,) = reps["0"]["applied_plans"]
    assert applied["epoch"] == 9 and applied["moved"] > 0 and applied["owners_after"] == 3
    assert reps["1"]["applied_plans"] == [applied]
    want = one_process(slow_job("wd", jid, epochs=12, workers=2, slack=1, lockstep=True))
    assert set(want) == {"w0", "w1"}
    for r in reps.values():
        assert by_worker(r) == want


def test_the_optimizer_loop_moves_through_the_pods_plan_channel(pod):
    trainer, data_fn, app_params, data_args = APPS["mlr"]
    cfg = JobConfig(
        job_id="mlr-optimized", app_type="dolphin", trainer=f"{HELPERS}:SlowEpochsMLR",
        params=TrainerParams(num_epochs=28, num_mini_batches=4,
                             app_params={**app_params, "epoch_lag_sec": 0.1}),
        num_workers=1, optimizer=f"{HELPERS}:MoveOncePodOptimizer", optimizer_period=0.3,
        user={"data_fn": f"harmony_tpu_torch.apps.{data_fn}", "data_args": dict(data_args)})
    assert pod.sender.send_job_submit_command(cfg).get("ok")
    result = pod.sender.wait_result(cfg.job_id, timeout=DEADLINE, poll=1.0)
    assert result["reconfigs"] == 1 and "optimizer_errors" not in result, result
    (applied,) = result["applied_plans"]
    assert applied["src"] == "executor-3" and applied["moved"] > 0, applied
    assert applied["owners_after"] == 4, applied
    reps = pod.reports([cfg.job_id])[cfg.job_id]
    assert reps["1"]["applied_plans"] == [applied]
    assert by_worker(reps["0"]) == by_worker(reps["1"])


@pytest.mark.parametrize("optimizer,epochs", [("DeleteOnePodOptimizer", 40),
                                              ("MoveOncePodOptimizer", 6)])
def test_the_pods_plan_adapter_declines_deletes_and_plans_past_the_end(optimizer, epochs):
    """A plan that deletes an executor, or whose earliest safe epoch is past
    the job's end, never reaches the plan channel."""
    from harmony_tpu_torch.config.base import resolve_symbol
    from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
    from harmony_tpu_torch.metrics.collector import BatchMetrics
    from harmony_tpu_torch.metrics.manager import MetricManager
    from harmony_tpu_torch.optimizer.api import EvaluatorParams

    sent = []
    metrics = MetricManager()
    metrics.start_collection()
    cfg = slow_job("mlr", "adapted", epochs=epochs)
    ent = DolphinJobEntity(cfg, metric_manager=metrics,
                           pod_plan_sink=lambda *plan: sent.append(plan))
    metrics.on_metric(BatchMetrics(job_id="adapted", worker_id="adapted/w0", epoch_idx=2))
    adapt = ent._make_pod_plan_adapter()
    plan = resolve_symbol(f"{HELPERS}:{optimizer}")().optimize(EvaluatorParams(
        worker_metrics=metrics.worker_batch_metrics(job_id="adapted"), table_id="t",
        block_counts={"executor-0": 4, "executor-1": 4}), 2)
    assert not plan.empty
    assert adapt(plan) is False and sent == []
    if optimizer == "MoveOncePodOptimizer":
        ent.config = slow_job("mlr", "adapted", epochs=40)
        assert adapt(plan) is True
        assert sent == [("adapted", "executor-1", "executor-0", 2, 2 + 8 + 2)]


@pytest.fixture(scope="module")
def carved(tmp_path_factory):
    pod = Pod(str(tmp_path_factory.mktemp("carved-moves")), scheduler="pod_carve:1")
    try:
        yield pod
        pod.finish()
    finally:
        pod.kill()


def test_a_follower_only_job_is_held_to_its_chiefs_observed_epoch(carved):
    """The leader runs none of the job: the horizon check asks the chief
    follower (PROGRESS_REQ). A zero-block plan at epoch 9 passes while the
    job is at epoch 0 and is refused once the follower's epoch has risen."""
    trainer, data_fn, app_params, data_args = APPS["mlr"]
    holder = slow_job("mlr", "mlr-holds-process-0", epochs=4, lag=0.5)
    target = JobConfig(
        job_id="mlr-on-1", app_type="dolphin", trainer=f"{HELPERS}:SlowEpochsMLR",
        params=TrainerParams(num_epochs=40, num_mini_batches=2,
                             app_params={**app_params, "epoch_lag_sec": 0.1}),
        user={"data_fn": f"harmony_tpu_torch.apps.{data_fn}", "data_args": dict(data_args)})
    for cfg in (holder, target):
        assert carved.sender.send_job_submit_command(cfg).get("ok")
    refused, accepted = None, 0
    deadline = time.monotonic() + DEADLINE
    while refused is None and time.monotonic() < deadline:
        reply = carved.sender.send_pod_reshard_command(
            "mlr-on-1", "executor-1", "executor-1", 0, 9)
        if reply.get("ok"):
            accepted += 1
        elif "window horizon" in reply.get("error", ""):
            refused = reply
        time.sleep(0.1)
    assert refused is not None, "the plan was never refused"
    reps = {}
    for cfg in (holder, target):
        carved.sender.wait_result(cfg.job_id, timeout=DEADLINE, poll=1.0)
        reps.update(carved.reports([cfg.job_id]))
    assert list(reps["mlr-on-1"]) == ["1"] and reps["mlr-on-1"]["1"]["ok"]
    # the plans accepted while the job was at epoch 0 moved nothing
    assert all(p["moved"] == 0 for p in reps["mlr-on-1"]["1"].get("applied_plans", []))


@pytest.fixture(scope="module")
def one_slot_pod(tmp_path_factory):
    """The reference pod's layout: one slot a process."""
    pod = Pod(str(tmp_path_factory.mktemp("one-slot-moves")))
    try:
        yield pod
        pod.finish()
    finally:
        pod.kill()


REF_EPOCHS = 16
REF_PLANS = (("executor-1", "executor-0", 4, 10), ("executor-1", "executor-0", 1024, 12))


def test_the_pod_reshard_is_near_the_references_two_process_pod(one_slot_pod):
    from benchmarks.common import free_port, sanitized_cpu_env, wait_for_ready
    from harmony_tpu.config.params import JobConfig as RefConfig
    from harmony_tpu.config.params import TrainerParams as RefParams
    from harmony_tpu.jobserver.client import CommandSender as RefSender

    trainer, data_fn, app_params, data_args = APPS["mlr"]
    coord, pod_port, tcp_port = free_port(), free_port(), free_port()
    worker = os.path.join(REPO, "tests", "pod_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, f"127.0.0.1:{coord}", "2", str(p),
                               str(pod_port), str(tcp_port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(sanitized_cpu_env(1), OMP_NUM_THREADS="1"))
             for p in range(2)]
    try:
        assert wait_for_ready(procs[0], DEADLINE), "the reference's pod never became ready"
        sender = RefSender(tcp_port)
        ref_cfg = RefConfig(
            job_id="mlr-ref-moved", app_type="dolphin", trainer="tests.helpers:LaggyMLRTrainer",
            params=RefParams(num_epochs=REF_EPOCHS, num_mini_batches=4,
                             app_params={**app_params, "lag_sec": 0.3, "lag_worker": "/w0"}),
            num_workers=1, user={"data_fn": f"harmony_tpu.apps.{data_fn}", "data_args": dict(data_args)})
        assert sender.send_job_submit_command(ref_cfg).get("ok")
        for i, plan in enumerate(REF_PLANS):
            reply = reshard(sender, "mlr-ref-moved", *plan, retry=i == 0)
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
    ref = json.loads(line[len("RESULT "):])["local_results"]["mlr-ref-moved"]
    assert "error" not in ref, ref
    (want,) = [w["losses"] for w in ref.values() if isinstance(w, dict) and "losses" in w]

    jid = "mlr-vs-ref-moved"
    cfg = slow_job("mlr", jid, epochs=REF_EPOCHS)
    assert one_slot_pod.sender.send_job_submit_command(cfg).get("ok")
    for i, plan in enumerate(REF_PLANS):
        reply = reshard(one_slot_pod.sender, jid, *plan, retry=i == 0)
        assert reply.get("ok"), reply
    reps = collect(one_slot_pod, jid)

    def key(plans):
        return [(p["epoch"], p["moved"], p["owners_after"], p.get("skipped")) for p in plans]

    assert key(ref["applied_plans"]) == [(10, 4, 2, None),
                                         (12, 0, 2, "process-set change mid-training")]
    for r in reps.values():
        assert r["ok"] and key(r["applied_plans"]) == key(ref["applied_plans"])
        (got,) = [w["losses"] for w in r["workers"].values()]
        np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)


def test_cli_pod_reshard_prints_the_servers_reply(one_slot_pod):
    out = subprocess.run(
        [sys.executable, "-m", "harmony_tpu_torch.cli", "pod-reshard", "--port",
         str(one_slot_pod.port), "--job", "not-running", "--src", "executor-1", "--dst",
         "executor-0", "--blocks", "1", "--epoch", "20"],
        cwd=REPO, capture_output=True, text=True, timeout=DEADLINE)
    assert out.returncode == 1, out.stderr[-2000:]
    reply = json.loads(out.stdout.strip().splitlines()[-1])
    assert reply["ok"] is False and "unknown (or finished) pod job not-running" in reply["error"]
