"""Elastic recovery's pieces without a pod of processes, on the CPU.

The port's ``jobserver/elastic.py``, ``jobserver/joblog.py``, the
schedulers' ``retire``/``restore``/``reacquire`` and the pod server's elastic
dispatch loop, liveness monitor and late joins, held against the reference
(``tests/test_elastic.py``) where the function is pure:

* ``attempt_key``/``attempt_of`` round trips, and the schedulers' elastic
  surface (share-all, carve, process-carve, a restore that launches a queued
  arrival) giving the reference's results on the same inputs;
* ``joblog``'s events: the reference's shape (``ts``, ``kind``, the fields),
  its per-job rings and ``JobLogger.event``;
* the dispatch loop in one process (a ``PodJobServer`` of no followers over
  two virtual CPU slots): a fence ends an attempt and the SAME submission
  goes on from the recovery cache (no block read) to the uninterrupted run's
  bits; a job failing on its own terms is never recovered; the recovery cap
  holds; an injected death of the planner or a failed restore fails the
  submission loudly;
* scripted followers (JSON lines on the control port): silence confines a
  follower and resumed beats rehabilitate it; a JOIN again from the same
  process (its incarnation token) is reinstated and lifts the partial
  poison, and a new process under a dead pid is refused with the reason
  named, never reinstated.

Every wait has a deadline.
"""
import json
import socket
import threading
import time

import pytest
import torch

from harmony_tpu_torch import faults
from harmony_tpu_torch.checkpoint import manager as chkp_manager
from harmony_tpu_torch.config.params import JobConfig, TrainerParams
from harmony_tpu_torch.jobserver import elastic, joblog
from harmony_tpu_torch.jobserver.elastic import ElasticFence
from harmony_tpu_torch.jobserver.pod import PodJobServer
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.parallel.mesh import DevicePool, Slot

DEADLINE = 60
EPOCHS = 24


@pytest.fixture(autouse=True)
def _clean_state():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    chkp_manager.drop_recovery_cache()
    yield
    faults.disarm()
    chkp_manager.drop_recovery_cache()
    torch.set_num_threads(threads)


# -- the shared vocabulary ---------------------------------------------------------


def test_attempt_keys_round_trip_as_the_reference():
    from harmony_tpu.config.params import JobConfig as RefJobConfig
    from harmony_tpu.jobserver import elastic as ref

    for att in (0, 1, 2, 7):
        assert elastic.attempt_key("j", att) == ref.attempt_key("j", att)
        user = {"elastic_recovery": {"attempt": att}}
        mine = JobConfig(job_id="j", app_type="dolphin", user=dict(user))
        theirs = RefJobConfig(job_id="j", app_type="dolphin", user=dict(user))
        assert elastic.attempt_of(mine) == ref.attempt_of(theirs) == att
        assert elastic.config_attempt_key(mine) == ref.config_attempt_key(theirs)
    assert elastic.attempt_key("j", 0) == "j" and elastic.attempt_key("j", 2) == "j@a2"
    fence = ElasticFence("regrow", 9)
    assert fence.elastic_fence == "regrow" and fence.epoch == 9
    assert str(fence) == str(ref.ElasticFence("regrow", 9))


# -- the schedulers' elastic surface ----------------------------------------------


def _scheduler_trace(mod, name):
    """One scripted sequence of retire/restore/reacquire/finish on a
    scheduler of ``mod`` (the port's or the reference's scheduler module):
    every call's result and the free pool after it."""
    launched = []
    out = []
    execs = ["e0", "e1", "e2", "e3"]
    if name == "share_all":
        s = mod.ShareAllScheduler()
        s.bind(execs[:3], lambda c, ex: launched.append((c.job_id, ex)))
        s.retire(["e2"])
        out += [s.reacquire("j", ["e1", "e2"]), s.reacquire("j", ["e2"])]
        s.restore(["e2"])
        out.append(s.reacquire("j", ["e2"]))
        return out
    if name == "carve":
        s = mod.CarveScheduler(max_share=2)
        s.bind(execs, lambda c, ex: launched.append((c.job_id, ex)))
        out.append(s.reacquire("j", ["e1", "e3"]))
        out.append(sorted(s._free))
        s.retire(["e3"])
        s.on_job_finish("j")   # a retired executor does not come back
        out.append(sorted(s._free))
        out.append(s.reacquire("k", ["e3"]))   # none preferred: a fresh slice
        s.restore(["e3"])
        out.append(sorted(s._free))
        return out
    s = mod.ProcessCarveScheduler()
    s.bind(execs, lambda c, ex: launched.append((c.job_id, ex)))
    s.set_process_map({"e0": 0, "e1": 0, "e2": 1, "e3": 1})
    s._free = ["e1", "e2", "e3"]
    out.append(s.reacquire("j", ["e1", "e2", "e3"]))   # e1 alone is half a process
    s.on_job_finish("j")
    s.retire(["e2", "e3"])
    out.append(s.reacquire("k", ["e2", "e3"]))          # process 1 is gone
    out.append(sorted(s._free))
    return out


@pytest.mark.parametrize("name", ["share_all", "carve", "process_carve"])
def test_scheduler_elastic_surface_matches_the_reference(name):
    from harmony_tpu.jobserver import scheduler as ref_sched

    from harmony_tpu_torch.jobserver import scheduler as port_sched

    assert _scheduler_trace(port_sched, name) == _scheduler_trace(ref_sched, name)


def test_restore_launches_a_queued_arrival_as_the_reference():
    from harmony_tpu.config.params import JobConfig as RefJobConfig
    from harmony_tpu.jobserver import scheduler as ref_sched

    from harmony_tpu_torch.jobserver import scheduler as port_sched

    for mod, cfg in ((port_sched, JobConfig), (ref_sched, RefJobConfig)):
        launched = []
        s = mod.CarveScheduler()
        s.bind(["e0"], lambda c, ex: launched.append((c.job_id, ex)))
        s.retire(["e0"])
        s.on_job_arrival(cfg(job_id="q1", app_type="dolphin"))
        assert launched == []   # queued: nothing free
        s.restore(["e0"])
        assert launched == [("q1", ["e0"])]


# -- joblog ------------------------------------------------------------------------


def test_joblog_events_have_the_reference_shape():
    from harmony_tpu.jobserver import joblog as ref

    joblog.clear_events()
    ref.clear_events()
    try:
        for mod in (joblog, ref):
            mod.record_event("j1", "elastic_shrink", attempt=1, executors=["e0"])
            mod.job_logger("j1").event("elastic_restore", blocks_read=3)
            mod.record_event("j2", "follower_silenced", pid=1)
        mine, theirs = joblog.job_events(), ref.job_events()
        assert sorted(mine) == sorted(theirs) == ["j1", "j2"]
        for j in mine:
            assert [{k: v for k, v in e.items() if k != "ts"} for e in mine[j]] == \
                [{k: v for k, v in e.items() if k != "ts"} for e in theirs[j]]
            assert all(isinstance(e["ts"], float) for e in mine[j])
        assert [e["kind"] for e in joblog.job_events("j1")] == [
            "elastic_shrink", "elastic_restore"]
        assert joblog.job_logger("j1").process("hi", {})[0] == "[JobId: j1] hi"
    finally:
        joblog.clear_events()
        ref.clear_events()


# -- the elastic dispatch loop, in one process -------------------------------------


def _cfg(job_id, epochs=EPOCHS, lag=0.05, extra_user=None, n=64):
    trainer = "tests.torch_pod_trainers:SlowEpochsMLR" if lag else \
        "harmony_tpu_torch.apps.mlr:MLRTrainer"
    app = {"num_classes": 4, "num_features": 16, "features_per_partition": 4,
           "step_size": 0.1, **({"epoch_lag_sec": lag} if lag else {})}
    user = {"data_fn": "harmony_tpu_torch.apps.mlr:make_synthetic",
            "data_args": {"n": n, "num_features": 16, "num_classes": 4, "seed": 3},
            "elastic_shrink": True, **(extra_user or {})}
    return JobConfig(job_id=job_id, app_type="dolphin", trainer=trainer,
                     params=TrainerParams(num_epochs=epochs, num_mini_batches=2,
                                          model_chkp_period=1, app_params=app),
                     num_workers=1, user=user)


@pytest.fixture()
def pod_server(tmp_path):
    srv = PodJobServer(2, num_followers=0, device_pool=DevicePool.virtual("cpu", 2),
                       chkp_root=str(tmp_path / "chkp"))
    srv.start()
    srv.serve_pod(0)
    yield srv
    srv.shutdown(timeout=DEADLINE)


def _fence_when_active(srv, job_id, kind):
    deadline = time.monotonic() + DEADLINE
    while time.monotonic() < deadline:
        with srv._pod_cond:
            live = job_id in srv._elastic_active
        if live:
            ep = srv._schedule_elastic_fence(job_id, kind)
            assert ep is not None, "fence refused (job too short?)"
            return ep
        time.sleep(0.02)
    raise AssertionError("the job never became elastic-active")


def test_a_fence_recovers_the_same_submission_with_the_uninterrupted_bits(pod_server):
    fut = pod_server.submit(_cfg("el-fence"))
    fence_ep = _fence_when_active(pod_server, "el-fence", "shrink")
    res = fut.result(timeout=DEADLINE)
    meta = res["elastic"]
    assert meta["attempts"] == 2 and meta["recoveries"] == 1
    assert [e["kind"] for e in meta["events"]] == ["elastic_shrink"]
    rst = res["elastic_restore"]
    assert rst["partial"] == 1 and rst["kind"] == "shrink" and rst["attempt"] == 1
    assert rst["resumed_epoch"] == fence_ep + 1
    assert rst["blocks_read"] == 0 and rst["bytes_read"] == 0  # the recovery cache
    assert rst["blocks_local"] == rst["blocks_needed"] == rst["blocks_total"] == 16
    (w,) = res["workers"].values()
    assert w["starting_epoch"] == fence_ep + 1 and w["attempt"] == 1
    assert w["epochs_run"] == EPOCHS - (fence_ep + 1)
    # the uninterrupted run of the same config, bit for bit
    ref = JobServer(2, device_pool=DevicePool.virtual("cpu", 2))
    ref.start()
    try:
        base = _cfg("el-ref", lag=0.0)
        base.user.pop("elastic_shrink")
        (w2,) = ref.submit(base).result(timeout=DEADLINE)["workers"].values()
    finally:
        ref.shutdown(timeout=DEADLINE)
    assert w["batch_losses"] == w2["batch_losses"][2 * (fence_ep + 1):]
    # the events reach STATUS
    status = pod_server._status()
    kinds = [e["kind"] for e in status["elastic"]["events"]]
    assert "elastic_shrink_fence" in kinds and "elastic_shrink" in kinds
    assert any(e["kind"] == "elastic_restore" for e in status["job_events"]["el-fence"])


def test_a_failure_on_the_jobs_own_terms_is_never_recovered(pod_server):
    cfg = _cfg("el-bug", epochs=4, lag=0.0, n=1)   # too few examples to feed it
    with pytest.raises(Exception, match="cannot feed"):
        pod_server.submit(cfg).result(timeout=DEADLINE)
    ev = [e for e in pod_server.elastic_events if e.get("job_id") == "el-bug"]
    assert [e["kind"] for e in ev] == ["elastic_give_up"]
    assert "own terms" in ev[0]["reason"]


def test_the_recovery_cap_bounds_fence_loops(pod_server, monkeypatch):
    monkeypatch.setenv("HARMONY_ELASTIC_MAX_SHRINKS", "0")
    fut = pod_server.submit(_cfg("el-cap"))
    _fence_when_active(pod_server, "el-cap", "shrink")
    with pytest.raises(ElasticFence):
        fut.result(timeout=DEADLINE)
    assert any(e["kind"] == "elastic_give_up" and "cap" in e["reason"]
               for e in pod_server.elastic_events)


def test_an_injected_planning_death_fails_the_submission_loudly(pod_server):
    faults.arm(faults.FaultPlan([faults.FaultRule(
        "pod.shrink_plan", count=1, exc="RuntimeError", message="planner struck down")]))
    fut = pod_server.submit(_cfg("el-plandeath"))
    _fence_when_active(pod_server, "el-plandeath", "shrink")
    with pytest.raises(ElasticFence):
        fut.result(timeout=DEADLINE)
    assert any(e["kind"] == "elastic_give_up" and "planning failed" in e["reason"]
               for e in pod_server.elastic_events)


def test_an_injected_restore_failure_fails_the_submission_loudly(pod_server, monkeypatch):
    monkeypatch.setenv("HARMONY_ELASTIC_CACHE", "0")   # every block is read
    faults.arm(faults.FaultPlan([faults.FaultRule(
        "chkp.partial_read", count=-1, exc="OSError", message="second failure mid-restore")]))
    fut = pod_server.submit(_cfg("el-midrestore"))
    _fence_when_active(pod_server, "el-midrestore", "shrink")
    with pytest.raises(OSError, match="mid-restore"):
        fut.result(timeout=DEADLINE)


# -- liveness and late joins, against scripted followers ---------------------------


class _FakeFollower:
    """A scripted control-plane follower: JOINs, beats on demand."""

    def __init__(self, port, pid, incarnation="fake-1"):
        self.pid = pid
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        self.file = self.sock.makefile("r")
        self.send({"cmd": "JOIN", "pid": pid, "incarnation": incarnation})

    def send(self, msg):
        self.sock.sendall((json.dumps(msg) + "\n").encode())

    def heartbeat(self):
        self.send({"cmd": "HEARTBEAT", "pid": self.pid, "jobs": []})

    def close(self):
        for obj in (self.file, self.sock):   # the server sees EOF only once both close
            try:
                obj.close()
            except OSError:
                pass


@pytest.fixture()
def control_pod(tmp_path):
    """A PodJobServer waiting for one follower, and its control port."""
    cpu = torch.device("cpu")
    # executor-1 names a slot of process 1, the scripted follower
    pool = DevicePool([Slot(0, cpu, 0), Slot(1, cpu, 1)])
    srv = PodJobServer(2, num_followers=1, device_pool=pool, chkp_root=str(tmp_path / "chkp"))
    srv.start()
    srv.hb_timeout = 1.0
    t = threading.Thread(target=lambda: srv.serve_pod(0), daemon=True)
    t.start()
    deadline = time.monotonic() + DEADLINE
    while srv._pod_sock is None and time.monotonic() < deadline:
        time.sleep(0.02)
    yield srv, srv._pod_sock.getsockname()[1], t
    srv.shutdown(timeout=DEADLINE)


def _until(pred, beat=None):
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and not pred():
        if beat is not None:
            beat()
        time.sleep(0.1)
    return pred()


def test_silence_confines_and_resumed_beats_rehabilitate(control_pod):
    srv, port, t = control_pod
    fake = _FakeFollower(port, 1)
    try:
        t.join(timeout=DEADLINE)
        assert not t.is_alive(), "serve_pod never completed the join"
        for _ in range(3):
            fake.heartbeat()
            time.sleep(0.2)
        assert 1 not in srv._silenced
        # silence past hb_timeout: confined, its executor retired
        assert _until(lambda: 1 in srv._silenced)
        assert 1 in srv._unusable_procs and srv._status()["pod"]["silenced"] == [1]
        assert srv._scheduler._executors == ["executor-0"]
        # beats resume: rehabilitated, the executor restored
        assert _until(lambda: 1 not in srv._silenced, beat=fake.heartbeat)
        assert 1 not in srv._unusable_procs
        assert srv._scheduler._executors == ["executor-0", "executor-1"]
        kinds = [e["kind"] for e in srv.elastic_events]
        assert "follower_silenced" in kinds and "follower_rehabilitated" in kinds
    finally:
        fake.close()


def test_a_rejoin_of_the_same_process_is_reinstated_and_a_new_one_refused(control_pod):
    srv, port, t = control_pod
    fake = _FakeFollower(port, 1, incarnation="proc-A")
    others = []
    try:
        t.join(timeout=DEADLINE)
        assert not t.is_alive()
        fake.heartbeat()
        fake.close()   # the reader's EOF: a death, confined
        assert _until(lambda: 1 in srv._dead_followers and srv._status()["pod"]["broken"])
        # a NEW process under the dead pid: outside the torch.distributed world
        newcomer = _FakeFollower(port, 1, incarnation="proc-B")
        others.append(newcomer)
        reply = json.loads(newcomer.file.readline())
        assert reply["cmd"] == "JOIN_REFUSED"
        assert "torch.distributed world" in reply["error"]
        assert srv.reinstated == [] and 1 in srv._dead_followers
        assert srv._status()["pod"]["refused_joins"][0]["pid"] == 1
        # the same process JOINs again (its connection dropped, it lives on)
        again = _FakeFollower(port, 1, incarnation="proc-A")
        others.append(again)
        assert _until(lambda: 1 in srv.reinstated, beat=again.heartbeat)
        assert srv.reinstated == [1] and 1 not in srv._dead_followers
        assert 1 not in srv._unusable_procs
        assert srv._status()["pod"]["broken"] is None   # the pod is whole again
    finally:
        fake.close()
        for f in others:
            f.close()
