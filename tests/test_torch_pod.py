"""The port's pod (``jobserver/pod.py``, ``cli start-pod``) on the CPU.

Two fresh interpreters run ``python -m harmony_tpu_torch.cli start-pod
--device cpu`` over one gloo world (a ``FileStore`` under the test's
temporary directory), each driving one CPU slot; process 0 is the
``PodJobServer``, process 1 a ``PodFollower``, and the tests submit over
TCP. One share-all pod serves most tests (module scope); the carve and the
killed follower take pods of their own.

* Dolphin jobs over a table sharded over the two processes (MLR on a range
  table, Wide&Deep on a hash-partitioned dense table, FM on a hash table)
  and PageRank's sharded vertex tables: both processes report the same
  losses (the same vertex values), and they are the port's one-process run
  on a virtual mesh of two CPU slots, bit for bit.
* MLR and Wide&Deep against the reference's own 2-process pod
  (``tests/pod_worker.py`` launched as ``tests/test_multihost.py``'s
  ``PodHarness`` launches it): every epoch's loss within ``LOSS_ATOL`` = 1e-5
  (f32 sums taken in another order in the two frameworks, as
  ``tests/test_torch_sharded_jobs.py`` allows).
* Two share-all tenants submitted together overlap and each gives its solo
  bits; ``pod_carve:1`` runs two jobs at once on disjoint processes (one
  wholly on the follower, its result riding the chief's report); a killed
  follower fails the running job within the heartbeat window and the leader
  still answers STATUS, with ``pod.broken`` set; a chain, a resume from one
  and a deferred evaluation run on a multi-process grant (the chains' bits:
  ``tests/test_torch_pod_chain.py``), and a deferred evaluation on a grant
  wholly on the follower runs there at shutdown and comes back in EVAL_DONE
  (``POD_RESHARD`` and the optimizer loop on a pod:
  ``tests/test_torch_pod_moves.py``).
* ``torchrun --nproc-per-node 2`` starts the same pod from its environment,
  with the one-process bits.

Every wait has a deadline and every child process is killed in a
``finally``.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from harmony_tpu_torch.config.params import JobConfig, TrainerParams
from harmony_tpu_torch.jobserver.client import CommandSender
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.parallel.mesh import DevicePool, Slot, build_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 120
LOSS_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


APPS = {
    "wd": ("widedeep:WideDeepTrainer", "widedeep:make_synthetic",
           {"vocab_size": 512, "num_slots": 4, "emb_dim": 8, "hidden": 16, "step_size": 0.5},
           {"n": 512, "vocab_size": 512, "num_slots": 4}),
    "mlr": ("mlr:MLRTrainer", "mlr:make_synthetic",
            {"num_classes": 4, "num_features": 16, "features_per_partition": 4,
             "step_size": 0.5},
            {"n": 256, "num_features": 16, "num_classes": 4, "seed": 7}),
    "fm": ("widedeep:FMTrainer", "widedeep:make_synthetic_sparse",
           {"vocab_size": 64, "num_slots": 4, "emb_dim": 4, "step_size": 2.0, "sparse": True},
           {"n": 512, "vocab_size": 64, "num_slots": 4}),
}


def job(app, job_id=None, epochs=2, pkg="harmony_tpu_torch", workers=1, lockstep=False,
        **params):
    if app == "pagerank":
        return JobConfig(job_id=job_id or app, app_type="pregel",
                         trainer="harmony_tpu_torch.apps.pagerank:PageRankComputation",
                         params=TrainerParams(app_params={"num_iterations": 5}),
                         user={"graph_fn": "harmony_tpu_torch.pregel.graph:random_graph",
                               "graph_args": {"num_vertices": 300, "avg_degree": 5,
                                              "seed": 3},
                               "max_supersteps": 20})
    trainer, data_fn, app_params, data_args = APPS[app]
    if pkg == "harmony_tpu":
        from harmony_tpu.config.params import JobConfig as Cfg
        from harmony_tpu.config.params import TrainerParams as Params
    else:
        Cfg, Params = JobConfig, TrainerParams
    return Cfg(job_id=job_id or app, app_type="dolphin", trainer=f"{pkg}.apps.{trainer}",
               params=Params(num_epochs=epochs, num_mini_batches=4,
                             app_params=dict(app_params), **params),
               num_workers=workers,
               user={"data_fn": f"{pkg}.apps.{data_fn}", "data_args": dict(data_args),
                     **({"force_lockstep": True} if lockstep else {})})


class Pod:
    """``cli start-pod`` in ``n`` processes on the CPU (``devices``: each
    process's ``--device``, ``cpu,cpu`` for two slots a process)."""

    def __init__(self, tmp, n=2, scheduler="share_all", env=None, torchrun=False,
                 devices="cpu"):
        self.port, pod_port = _free_port(), _free_port()
        self.tmp = tmp
        full = dict(os.environ, OMP_NUM_THREADS="1", HARMONY_POD_HB_PERIOD="0.5",
                    HARMONY_POD_UNIT_TIMEOUT="60")
        full.update(env or {})
        self.procs = []
        self.logs = []
        pod = ["-m", "harmony_tpu_torch.cli", "start-pod", "--device", devices,
               "--pod-port", str(pod_port), "--port", str(self.port), "--scheduler", scheduler]
        if torchrun:
            # one launcher for the n processes (its own session, so that
            # ``kill`` reaches them too); they take torchrun's environment
            launches = [[sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                         str(n), "--master-addr", "127.0.0.1",
                         "--master-port", str(_free_port())] + pod]
        else:
            launches = [[sys.executable] + pod + [
                "--coordinator", f"file://{tmp}/store", "--num-processes", str(n),
                "--process-id", str(p)] for p in range(n)]
        for p, argv in enumerate(launches):
            err = open(os.path.join(tmp, f"process{p}.err"), "w")
            self.logs.append(err)
            self.procs.append(subprocess.Popen(
                argv, cwd=REPO, env=full, stdout=subprocess.PIPE, stderr=err, text=True,
                start_new_session=True))
        self.sender = CommandSender(self.port)
        box = {}

        def ready():
            for line in self.procs[0].stdout:
                if line.startswith("pod jobserver ready"):
                    box["line"] = line
                    return

        t = threading.Thread(target=ready, daemon=True)
        t.start()
        t.join(DEADLINE)
        assert "line" in box, f"the leader never became ready: {self.stderr(0)[-3000:]}"
        self.ready_line = box["line"]

    def stderr(self, p):
        self.logs[p].flush()
        with open(os.path.join(self.tmp, f"process{p}.err")) as f:
            return f.read()

    def run(self, *configs, timeout=DEADLINE):
        """Submit ``configs`` together; wait for each and for its reports.
        Returns {job id: {pid: report}}."""
        for cfg in configs:
            reply = self.sender.send_job_submit_command(cfg)
            assert reply.get("ok"), reply
        for cfg in configs:
            self.sender.wait_result(cfg.job_id, timeout=timeout, poll=2.0)
        return self.reports([c.job_id for c in configs])

    def reports(self, job_ids, timeout=DEADLINE):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            pod = self.sender.send_status_command()["pod"]
            if all(j in pod["reports"] for j in job_ids) and not set(job_ids) & set(pod["active"]):
                return {j: pod["reports"][j] for j in job_ids}
            time.sleep(0.1)
        raise AssertionError(f"no reports for {job_ids}")

    def finish(self):
        """Shut the pod down (once): every process must exit 0. Returns what
        the leader prints as it closes (its deferred evaluations' results and
        whether the pod was broken)."""
        if getattr(self, "closed", None) is not None:
            return self.closed
        assert self.sender.send_shutdown_command().get("ok")
        for p, proc in enumerate(self.procs):
            proc.wait(timeout=DEADLINE)
            assert proc.returncode == 0, self.stderr(p)[-3000:]
        prefix = "pod jobserver closed: "
        (line,) = [ln for ln in self.procs[0].stdout.read().splitlines()
                   if ln.startswith(prefix)]
        self.closed = json.loads(line[len(prefix):])
        return self.closed

    def kill(self):
        for proc in self.procs:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait(timeout=10)
        for f in self.logs:
            f.close()


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pod"))
    pod = Pod(tmp, env={"HARMONY_POD_CHKP_ROOT": os.path.join(tmp, "chains")})
    try:
        yield pod
        pod.finish()
    finally:
        pod.kill()


_ONE_PROCESS = {}


def one_process(app, workers=1):
    """The port's run on ONE process over a virtual mesh of two CPU slots:
    each worker's batch losses, or a graph job's vertex digest. Several
    workers take turns there as on a pod (``force_lockstep``)."""
    if (app, workers) not in _ONE_PROCESS:
        from harmony_tpu_torch.jobserver.pod import _job_summary

        server = JobServer(2, device_pool=DevicePool.virtual("cpu", 2))
        server.start()
        try:
            res = server.submit(job(app, workers=workers, lockstep=workers > 1)).result(
                timeout=DEADLINE)
        finally:
            server.shutdown(timeout=DEADLINE)
        _ONE_PROCESS[app, workers] = _job_summary(res)
    return _ONE_PROCESS[app, workers]


def _losses(report):
    (w,) = report["workers"].values()
    return w["batch_losses"]


@pytest.mark.parametrize("app", ["mlr", "wd", "fm", "pagerank"])
def test_a_job_over_two_processes_is_the_one_process_meshs_bits(pod, app):
    reps = pod.run(job(app))[app]
    assert set(reps) == {"0", "1"}
    assert all(r["ok"] for r in reps.values()), reps
    want = one_process(app)
    for r in reps.values():
        if app == "pagerank":
            assert r["vertex_digest"] == want["vertex_digest"]
            assert r["supersteps"] == want["supersteps"]
        else:
            assert _losses(r) == [w["batch_losses"] for w in want["workers"].values()][0]
            assert len(_losses(r)) == 8
        # the pull's all-gather crossed the processes
        assert r["combine"]["calls"] > 0 and r["combine"]["bytes_in"] > 0


def test_two_workers_take_turns_on_the_pod_as_in_one_process(pod):
    """A job's workers on every process take turns in a DispatchTurnstile,
    inside the job's pod units: the one-process lockstep run's bits."""
    reps = pod.run(job("wd", job_id="wd-2w", workers=2))["wd-2w"]
    want = one_process("wd", workers=2)["workers"]
    for r in reps.values():
        assert r["ok"], r
        assert {w[-2:]: v["batch_losses"] for w, v in r["workers"].items()} == {
            w[-2:]: v["batch_losses"] for w, v in want.items()}


def test_the_pod_is_near_the_references_two_process_pod(pod):
    from benchmarks.common import free_port, sanitized_cpu_env, wait_for_ready
    from harmony_tpu.jobserver.client import CommandSender as RefSender

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
        for app in ("mlr", "wd"):
            assert sender.send_job_submit_command(job(app, pkg="harmony_tpu")).get("ok")
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
    ref = json.loads(line[len("RESULT "):])
    mine = pod.run(job("mlr", job_id="mlr-vs-ref"), job("wd", job_id="wd-vs-ref"))
    for app in ("mlr", "wd"):
        (want,) = [w["losses"] for w in ref["local_results"][app].values()]
        (follower,) = [w["losses"] for w in ref["pod_reports"][app]["1"]["workers"].values()]
        assert follower == want
        for r in mine[f"{app}-vs-ref"].values():
            (got,) = [w["losses"] for w in r["workers"].values()]
            np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)


def test_two_share_all_tenants_overlap_with_their_solo_bits(pod):
    reps = pod.run(job("wd", job_id="wd-beside", epochs=2), job("mlr", job_id="mlr-beside"))
    walls = pod.sender.send_status_command()["pod"]["walls"]
    (a0, a1), (b0, b1) = walls["wd-beside"], walls["mlr-beside"]
    assert a0 < b1 and b0 < a1, walls  # each started before the other ended
    for jid, app in (("wd-beside", "wd"), ("mlr-beside", "mlr")):
        want = [w["batch_losses"] for w in one_process(app)["workers"].values()][0]
        for r in reps[jid].values():
            assert r["ok"] and _losses(r) == want
    assert pod.sender.send_status_command()["pod"]["units_granted"] > 0


def test_pod_isolated_jobs_run_one_after_another_with_their_solo_bits(pod):
    """``user.pod_isolated`` opts a job out of the unit protocol: two such
    multi-process jobs on the same processes are serialized at admission."""
    first, second = job("mlr", job_id="mlr-isolated"), job("wd", job_id="wd-isolated")
    for cfg in (first, second):
        cfg.user["pod_isolated"] = True
    reps = pod.run(first, second)
    walls = pod.sender.send_status_command()["pod"]["walls"]
    (a0, a1), (b0, b1) = walls["mlr-isolated"], walls["wd-isolated"]
    assert a1 <= b0 or b1 <= a0, walls
    for jid, app in (("mlr-isolated", "mlr"), ("wd-isolated", "wd")):
        want = [w["batch_losses"] for w in one_process(app)["workers"].values()][0]
        for r in reps[jid].values():
            assert r["ok"] and _losses(r) == want and r.get("units", 0) == 0


def test_pod_reshard_a_chain_and_an_optimizer_are_refused_naming_item_3b(pod):
    """Named for the refusals it replaced; it checks that they are gone. A
    chain, a resume from it and a job with the deferred evaluation run
    on a multi-process grant now (their bits: ``tests/test_torch_pod_chain.py``):
    the chain's entries are the pod's, the resume continues it with the
    uninterrupted run's losses, and the evaluation runs at the pod's
    shutdown. ``POD_RESHARD`` and the optimizer loop run on the pod too
    (``tests/test_torch_pod_moves.py``): a plan is refused here only because
    its job is not running."""
    reply = pod.sender.send_pod_reshard_command("wd", "executor-0", "executor-1", 1, 30)
    assert not reply["ok"] and "unknown (or finished) pod job wd" in reply["error"], reply
    chained = job("mlr", job_id="mlr-chain", model_chkp_period=1)
    resumed = job("mlr", job_id="mlr-chain", epochs=3, model_chkp_period=1)
    resumed.user["resume_from_chain"] = True
    evaluated = job("mlr", job_id="mlr-eval", model_chkp_period=1, offline_model_eval=True)
    whole = job("mlr", job_id="mlr-whole", epochs=3)
    reps = pod.run(chained, whole)
    first, want = reps["mlr-chain"], reps["mlr-whole"]
    ids = first["0"]["model_chkp_ids"]
    assert len(ids) == 2 and all(c.endswith("-pod") for c in ids), ids
    cont = pod.run(resumed)["mlr-chain"]
    for p in ("0", "1"):
        assert first[p]["ok"] and cont[p]["ok"], (first[p], cont[p])
        assert first[p]["model_chkp_ids"] == ids
        assert _losses(first[p]) + _losses(cont[p]) == _losses(want[p])
    assert all(r["ok"] for r in pod.run(evaluated)["mlr-eval"].values())
    # the pod still runs jobs after them
    assert all(r["ok"] for r in pod.run(job("mlr", job_id="mlr-after"))["mlr-after"].values())


@pytest.fixture(scope="module")
def carved(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("carved"))
    pod = Pod(tmp, scheduler="pod_carve:1",
              env={"HARMONY_POD_CHKP_ROOT": os.path.join(tmp, "chains")})
    try:
        yield pod
        pod.finish()
    finally:
        pod.kill()


def test_pod_carve_runs_two_jobs_at_once_on_disjoint_processes(carved):
    reps = carved.run(job("wd", job_id="wd-carved", epochs=3), job("mlr", job_id="mlr-carved"))
    status = carved.sender.send_status_command()["pod"]
    (a0, a1), (b0, b1) = status["walls"]["wd-carved"], status["walls"]["mlr-carved"]
    assert a0 < b1 and b0 < a1, status["walls"]
    # one job on each process, and neither crossed processes
    assert [sorted(reps[j]) for j in ("wd-carved", "mlr-carved")] == [["0"], ["1"]]
    for jid, app in (("wd-carved", "wd"), ("mlr-carved", "mlr")):
        (r,) = reps[jid].values()
        assert r["ok"] and r["combine"]["calls"] == 0
    # the follower-only job's result came through its chief's report
    res = carved.sender.wait_result("mlr-carved", timeout=10)
    (w,) = res["workers"].values()
    assert w["batch_losses"] == _losses(reps["mlr-carved"]["1"])


def test_a_deferred_evaluation_on_a_follower_only_grant_is_refused_naming_item_3b(carved):
    """Named for the refusal it replaced; it checks that it is gone. A job
    wholly on a follower with a chain and ``offline_model_eval`` runs there, and so does its evaluation: the follower, its chief, keeps
    it (JOB_DONE's ``has_deferred_eval``), runs it at the pod's shutdown and
    sends its results back in EVAL_DONE, which reach the leader's
    ``eval_results`` beside the leader's own evaluations."""
    held = job("wd", job_id="wd-holds-process-0", epochs=3)
    evaluated = job("mlr", job_id="mlr-eval-on-1", model_chkp_period=1, offline_model_eval=True)
    for cfg in (held, evaluated):
        assert carved.sender.send_job_submit_command(cfg).get("ok")
    for cfg in (held, evaluated):
        carved.sender.wait_result(cfg.job_id, timeout=DEADLINE, poll=2.0)
    reps = carved.reports([held.job_id, evaluated.job_id])
    assert list(reps[held.job_id]) == ["0"] and reps[held.job_id]["0"]["ok"]
    (r,) = reps[evaluated.job_id].values()
    assert list(reps[evaluated.job_id]) == ["1"] and r["ok"], r
    assert r["has_deferred_eval"] and len(r["model_chkp_ids"]) == 2
    closed = carved.finish()
    evals = closed["eval_results"][evaluated.job_id]
    assert isinstance(evals, list) and len(evals) == 2, evals
    assert all(np.isfinite(m["loss"]) for m in evals) and evals[-1]["loss"] < evals[0]["loss"]
    assert held.job_id not in closed["eval_results"] and closed["broken"] is None


def test_a_pod_started_under_torchrun_gives_the_one_process_bits(tmp_path):
    """``torchrun --nproc-per-node 2 -m harmony_tpu_torch.cli start-pod``:
    the processes take torchrun's environment and its agent's store."""
    pod = Pod(str(tmp_path), torchrun=True)
    try:
        reps = pod.run(job("mlr", job_id="mlr-torchrun"))["mlr-torchrun"]
        want = _losses(one_process("mlr"))
        assert sorted(reps) == ["0", "1"]
        for r in reps.values():
            assert r["ok"] and _losses(r) == want
        pod.finish()
    finally:
        pod.kill()


@pytest.mark.parametrize("device,local_rank,want", [
    ("cuda", None, None), ("cuda", "1", ["cuda:1"]), ("cuda:0", "1", ["cuda:0"]),
    ("cpu", "1", ["cpu"])])
def test_a_pod_process_takes_its_device_flag_else_its_local_rank(
        monkeypatch, device, local_rank, want):
    from harmony_tpu_torch import cli

    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert cli._pod_devices(device) == want


def test_a_killed_follower_fails_the_job_and_the_leader_answers(tmp_path):
    pod = Pod(str(tmp_path), env={"HARMONY_POD_HB_TIMEOUT": "3",
                                  "HARMONY_POD_UNIT_TIMEOUT": "20"})
    try:
        long_job = job("wd", job_id="wd-long", epochs=400)
        assert pod.sender.send_job_submit_command(long_job).get("ok")
        deadline = time.monotonic() + DEADLINE
        while "wd-long" not in pod.sender.send_status_command()["pod"]["active"]:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        time.sleep(1.0)   # inside its epochs
        pod.procs[1].send_signal(signal.SIGKILL)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="failed"):
            pod.sender.wait_result("wd-long", timeout=60, poll=1.0)
        assert time.monotonic() - t0 < 30   # within the heartbeat window and its grace
        status = pod.sender.send_status_command()
        assert status["ok"] and status["pod"]["broken"]
        assert status["pod"]["dead"] == [1] and 1 in status["pod"]["unusable_procs"]
        # a later job on the dead process is failed at admission, not hung
        assert pod.sender.send_job_submit_command(job("mlr", job_id="mlr-late")).get("ok")
        with pytest.raises(RuntimeError, match="pod is broken"):
            pod.sender.wait_result("mlr-late", timeout=30, poll=1.0)
        assert pod.sender.send_shutdown_command().get("ok")
        pod.procs[0].wait(timeout=DEADLINE)
        assert pod.procs[0].returncode == 0, pod.stderr(0)[-3000:]
    finally:
        pod.kill()


def test_a_live_read_of_a_table_over_processes_is_refused():
    """The serving endpoint's live read would be a collective that only the
    leader joins: it is refused, naming ROADMAP C's entry on live reads
    over processes, a fault of the reference (no pod needed to build such
    a table: its other process's shard is simply not held here)."""
    from types import SimpleNamespace

    from harmony_tpu_torch.config.params import TableConfig
    from harmony_tpu_torch.table.table import DenseTable, TableSpec

    cpu = torch.device("cpu")
    mesh = build_mesh([Slot(0, cpu, 0), Slot(1, cpu, 1)], data=1)
    table = DenseTable(TableSpec(TableConfig(table_id="spanning", capacity=64,
                                             value_shape=(2,), num_blocks=8)), mesh)
    assert sorted(s.index for s in table.array.shards) == [0]
    server = JobServer(1, device_pool=DevicePool([cpu]))
    server.start()
    try:
        server._entities["spanning"] = SimpleNamespace(
            table_handle=SimpleNamespace(table=table))
        with pytest.raises(LookupError, match=r"ROADMAP C, known differences: live reads "
                                              r"over processes"):
            server._ensure_serving().lookup("spanning", np.arange(4, dtype=np.int32))
    finally:
        server.shutdown(timeout=DEADLINE)


def test_a_followers_beat_carries_its_metrics_port_and_the_leader_scrapes_it(monkeypatch):
    """In one process over two CPU slots: with ``HARMONY_METRICS_PORT=0`` the
    follower runs an exporter and advertises its port on every beat; the
    leader lists it in STATUS's ``pod.metrics_ports`` and its scrape targets
    (``pod:1``), scrapes both targets without a gap, and drops a silenced
    follower from the targets; the follower's exporter stops at shutdown."""
    from harmony_tpu_torch.jobserver.pod import PodFollower, PodJobServer

    monkeypatch.setenv("HARMONY_METRICS_PORT", "0")
    monkeypatch.setenv("HARMONY_POD_HB_PERIOD", "0.05")
    monkeypatch.setenv("HARMONY_OBS_SCRAPE_PERIOD", "3600")
    cpu = torch.device("cpu")
    server = PodJobServer(2, num_followers=1,
                          device_pool=DevicePool([Slot(0, cpu, 0), Slot(1, cpu, 1)]))
    server.start()
    follower = ft = None
    try:
        t = threading.Thread(target=lambda: server.serve_pod(0), daemon=True)
        t.start()
        deadline = time.monotonic() + DEADLINE
        while server._pod_sock is None and time.monotonic() < deadline:
            time.sleep(0.01)
        follower = PodFollower("127.0.0.1", server._pod_sock.getsockname()[1], pid=1,
                               num_executors=2,
                               pool=DevicePool([Slot(0, cpu, 0), Slot(1, cpu, 1)]),
                               join_timeout=DEADLINE)
        ft = threading.Thread(target=follower.run, daemon=True)
        ft.start()
        port = follower.metrics_exporter.port
        while server._hb_metrics_ports.get(1) != port and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server._hb_metrics_ports == {1: port}
        assert server._status()["pod"]["metrics_ports"] == {"1": port}
        assert server._status()["metrics_port"] == server.metrics_exporter.port
        targets = server._scrape_targets()
        assert set(targets) == {"leader", "pod:1"}
        assert targets["pod:1"] == f"http://127.0.0.1:{port}/metrics"
        report = server._history_scraper.poll_once()
        assert report["targets"]["leader"] != "gap" and report["targets"]["pod:1"] != "gap"
        assert server.history.stats()["targets"] == ["leader", "pod:1"]
        assert server.history.gaps() == []
        server._on_follower_silence(1)
        assert set(server._scrape_targets()) == {"leader"}
    finally:
        server.shutdown(timeout=DEADLINE)
        if ft is not None:
            ft.join(timeout=DEADLINE)
    assert not ft.is_alive() and follower.metrics_exporter is None
    assert server.metrics_exporter is None
