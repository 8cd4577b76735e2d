"""The control plane's HA on the CPU: the durable log, the lease and the
standby, against the reference.

The port's ``utils/durability.py``, ``jobserver/{halog,lease,ha}.py``, the
JobServer's HA half and the pod follower's fencing and re-JOIN, mirroring the
reference's ``tests/test_ha.py`` classes this slice covers (the durable log,
replication, the lease, follower fencing and re-JOIN, the re-arm policy, an
in-process takeover, the durable sink, the NOT_LEADER redirect), plus a
deposed leader's gating and the checks across packages, all exact:

* ``encode_record`` gives the reference's bytes, and two logs fed the same
  appends (the clock pinned) are the same file;
* a log written by either package, with a deposed leader's stale-epoch
  entries and a torn tail, scans to the same ``(entries, good, torn)`` and
  replays to the same ``ReplayState.to_dict()`` in both;
* a lease file written by either package is read by the other's
  ``read_lease`` and ``leader_hint``, and the epochs stay monotonic when a
  port manager and a reference one contend on one directory.

Leases are at most 0.6 s; every socket binds port 0 with a timeout, and every
controller and server is stopped by the test that made it.
"""
import json
import os
import socket
import threading
import time

import pytest
import torch

from harmony_tpu.jobserver import halog as ref_halog
from harmony_tpu.jobserver import lease as ref_lease
from harmony_tpu_torch import faults
from harmony_tpu_torch.config.params import JobConfig, TrainerParams
from harmony_tpu_torch.jobserver import halog, joblog, lease
from harmony_tpu_torch.jobserver.halog import (
    DurableJobLog,
    LogReceiver,
    LogReplicator,
    ReplayState,
    StaleEpochError,
    scan_records,
)
from harmony_tpu_torch.jobserver.lease import LeaseManager
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.utils.durability import fsync_dir

DEADLINE = 30.0


@pytest.fixture(autouse=True)
def _clean_state():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    joblog.clear_events()
    yield
    faults.disarm()
    joblog.clear_events()
    torch.set_num_threads(threads)


def _wait_for(cond, timeout=DEADLINE, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _cpu_server(**kw):
    from harmony_tpu_torch.jobserver.server import JobServer

    return JobServer(1, device_pool=DevicePool(["cpu"]), **kw)


def _laggy_job(job_id: str, epochs: int, lag: float = 0.25) -> JobConfig:
    return JobConfig(
        job_id=job_id, app_type="dolphin", trainer="tests.torch_pod_trainers:SlowEpochsMLR",
        params=TrainerParams(num_epochs=epochs, num_mini_batches=2,
                             app_params={"num_classes": 4, "num_features": 16,
                                         "features_per_partition": 4, "step_size": 0.1,
                                         "epoch_lag_sec": lag}),
        num_workers=1,
        user={"data_fn": "harmony_tpu_torch.apps.mlr:make_synthetic",
              "data_args": {"n": 64, "num_features": 16, "num_classes": 4, "seed": 11}})


def _raw(port: int, msg: dict) -> dict:
    """One command on the wire, the reply as sent (no client-side mapping)."""
    with socket.create_connection(("127.0.0.1", port), timeout=DEADLINE) as s:
        s.sendall((json.dumps(msg) + "\n").encode())
        data = b""
        while not data.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    return json.loads(data.decode())


# -- the durable log -------------------------------------------------------------


class TestDurableLog:
    def test_append_replay_roundtrip(self, tmp_path):
        path = str(tmp_path / "job.walog")
        log = DurableJobLog(path)
        e1 = log.append("submission", job_id="j1", config={"a": 1})
        e2 = log.append("dispatch", job_id="j1", executors=["e0", "e1"])
        e3 = log.append("job_done", job_id="j1", ok=True)
        log.close()
        reopened = DurableJobLog(path)
        assert reopened.torn_recovered == 0
        entries = reopened.entries()
        assert [e["seq"] for e in entries] == [1, 2, 3]
        assert entries[0]["config"] == {"a": 1}
        assert entries[1]["executors"] == ["e0", "e1"]
        assert entries[2]["ok"] is True
        assert [e["kind"] for e in entries] == [e1["kind"], e2["kind"], e3["kind"]]
        # the seq stays monotonic past the reopened tail
        assert reopened.append("submission", job_id="j2", config={})["seq"] == 4
        stats = reopened.stats()
        assert stats["appends"] == 1 and stats["group_commits"] == 1
        assert stats["last_seq"] == 4 and stats["append_seconds"] > 0
        reopened.close()

    def test_torn_tail_truncated_on_open(self, tmp_path):
        path = str(tmp_path / "job.walog")
        log = DurableJobLog(path)
        log.append("submission", job_id="j1", config={})
        log.append("dispatch", job_id="j1")
        log.close()
        good_size = os.path.getsize(path)
        with open(path, "ab") as f:  # a crash mid-append
            f.write(b"\x40\x00\x00\x00\xde\xad\xbe\xefgarbage")
        entries, good, torn = scan_records(path)
        assert len(entries) == 2 and good == good_size and torn > 0
        reopened = DurableJobLog(path)
        assert reopened.torn_recovered > 0
        assert os.path.getsize(path) == good_size
        reopened.append("job_done", job_id="j1", ok=False, error="x")
        reopened.close()
        entries, _good, torn = scan_records(path)
        assert torn == 0
        assert [e["kind"] for e in entries] == ["submission", "dispatch", "job_done"]
        assert [e["seq"] for e in entries] == [1, 2, 3]

    def test_a_torn_append_is_cut_back_and_the_log_stays_appendable(self, tmp_path):
        """The tail-repair bracket: an injected torn write (``disk.write``,
        ``kind="halog"``, ``corrupt``) raises, and the half record is
        truncated, so the next append lands after the last whole one."""
        path = str(tmp_path / "job.walog")
        log = DurableJobLog(path)
        log.append("submission", job_id="j1", config={})
        faults.arm(faults.FaultPlan([faults.FaultRule(
            "disk.write", match={"kind": "halog"}, count=1, action="corrupt")]))
        with pytest.raises(faults.DiskIOError):
            log.append("dispatch", job_id="j1")
        faults.disarm()
        log.append("job_done", job_id="j1", ok=True)
        log.close()
        entries, _good, torn = scan_records(path)
        assert torn == 0
        assert [(e["seq"], e["kind"]) for e in entries] == [(1, "submission"), (2, "job_done")]

    def test_fenced_epoch_rejects_deposed_writer(self, tmp_path):
        log = DurableJobLog(str(tmp_path / "job.walog"))
        log.append("submission", job_id="j1", epoch=1, config={})
        log.set_epoch(3)
        with pytest.raises(StaleEpochError):
            log.append("dispatch", job_id="j1", epoch=2)
        with pytest.raises(StaleEpochError):
            log.set_epoch(2)
        log.append("dispatch", job_id="j1", epoch=3)
        log.close()

    @pytest.mark.parametrize("package", ["port", "reference"])
    def test_replay_fences_stale_epoch_entries(self, package):
        entries = [
            {"seq": 1, "epoch": 1, "kind": "submission", "job": "a", "config": {"job_id": "a"}},
            {"seq": 2, "epoch": 2, "kind": "leader_takeover", "job": None},
            {"seq": 3, "epoch": 1, "kind": "job_done", "job": "a", "ok": True},  # stale
            {"seq": 4, "epoch": 2, "kind": "submission", "job": "b", "config": {"job_id": "b"}},
        ]
        cls = ReplayState if package == "port" else ref_halog.ReplayState
        st = cls.from_entries(entries)
        assert st.rejected_stale == 1
        assert sorted(st.in_flight()) == ["a", "b"]
        assert st.max_epoch == 2 and len(st.takeovers) == 1
        assert st.to_dict() == ref_halog.ReplayState.from_entries(entries).to_dict()

    def test_replay_state_lifecycle(self, tmp_path):
        log = DurableJobLog(str(tmp_path / "job.walog"))
        log.append("submission", job_id="a", config={"job_id": "a"})
        log.append("dispatch", job_id="a", attempt=0)
        log.append("chkp_chain", job_id="a", chkp_id="a:model-3-x")
        log.append("elastic_shrink", job_id="a", attempt=2)
        log.append("submission", job_id="b", config={"job_id": "b"})
        log.append("job_done", job_id="b", ok=True)
        st = ReplayState.from_entries(log.entries())
        assert st.in_flight() == ["a"]
        assert st.chains["a"] == "a:model-3-x"
        assert st.attempts["a"] == 2
        assert "b" in st.done
        assert halog.replay_file(log.path).to_dict() == st.to_dict()
        log.close()


def test_fsync_dir_syncs_a_directory_or_a_files_parent(tmp_path):
    f = tmp_path / "x"
    f.write_text("1")
    assert fsync_dir(str(tmp_path)) and fsync_dir(str(f))
    assert not fsync_dir(str(tmp_path / "missing" / "y"))


# -- replication ---------------------------------------------------------------------


class TestReplication:
    def test_standby_catch_up_after_gap(self, tmp_path):
        leader = DurableJobLog(str(tmp_path / "leader.walog"))
        standby = DurableJobLog(str(tmp_path / "standby.walog"))
        for i in range(3):  # before the receiver exists: the catch-up prefix
            leader.append("submission", job_id=f"j{i}", config={})
        recv = LogReceiver(standby, port=0)
        port = recv.start()
        repl = LogReplicator(leader, [f"127.0.0.1:{port}"])
        repl.start()
        _wait_for(lambda: standby.last_seq == 3, msg="catch-up")
        leader.append("dispatch", job_id="j0")  # live
        _wait_for(lambda: standby.last_seq == 4, msg="live entry")
        repl.stop()  # a gap: the standby goes away, the leader appends on
        recv.stop()
        for i in range(4):
            leader.append("job_done", job_id=f"j{i}", ok=True)
        assert standby.last_seq == 4
        recv2 = LogReceiver(standby, port=0)
        port2 = recv2.start()
        repl2 = LogReplicator(leader, [f"127.0.0.1:{port2}"])
        repl2.start()
        _wait_for(lambda: standby.last_seq == leader.last_seq, msg="gap repair")
        ours = [(e["seq"], e["epoch"], e["kind"], e["job"]) for e in standby.entries()]
        theirs = [(e["seq"], e["epoch"], e["kind"], e["job"]) for e in leader.entries()]
        assert ours == theirs
        assert repl2.stats()[f"127.0.0.1:{port2}"]["connected"]
        assert recv2.stats()["received"] == 4
        repl2.stop()
        recv2.stop()
        leader.close()
        standby.close()

    def test_a_receiver_rejects_a_deposed_leaders_stream(self, tmp_path):
        """A standby whose log has seen epoch 2 counts an epoch-1 stream's
        entries as stale and applies none of them."""
        old = DurableJobLog(str(tmp_path / "old.walog"))
        standby = DurableJobLog(str(tmp_path / "standby.walog"))
        standby.append("leader_takeover", epoch=2)
        for i in range(2):
            old.append("submission", job_id=f"late{i}", epoch=1, config={})
        old._seq = 10  # its late writes carry seqs past the standby's
        old.append("dispatch", job_id="late0", epoch=1)
        recv = LogReceiver(standby, port=0)
        port = recv.start()
        repl = LogReplicator(old, [f"127.0.0.1:{port}"])
        repl.start()
        _wait_for(lambda: recv.stats()["rejected_stale"] >= 1, msg="a stale entry")
        repl.stop()
        recv.stop()
        assert [e["kind"] for e in standby.entries()] == ["leader_takeover"]
        old.close()
        standby.close()


# -- the lease -----------------------------------------------------------------------


class TestLease:
    def test_election_renewal_and_deposition(self, tmp_path):
        lost = []
        a = LeaseManager(str(tmp_path), "replica-a", lease_s=0.5,
                         on_lost=lambda: lost.append("a"), addr="127.0.0.1:1001")
        b = LeaseManager(str(tmp_path), "replica-b", lease_s=0.5, addr="127.0.0.1:1002")
        assert a.try_acquire()
        assert a.epoch == 1 and a.is_valid()
        assert not b.try_acquire()
        assert a.renew()
        assert lease.leader_hint(str(tmp_path)) == "127.0.0.1:1001"
        assert lease.leader_hint(str(tmp_path), own_holder_id="replica-a") is None
        time.sleep(0.6)  # the holder stops renewing: the lease runs out
        assert not a.is_valid()
        assert b.try_acquire()
        assert b.epoch == 2
        assert b.previous and b.previous["holder"] == "replica-a"
        assert not a.renew()  # the old holder's renewal sees the successor
        assert lost == ["a"]
        assert a.stats()["renew_failures"] == 1 and not a.stats()["held"]
        b.release()

    def test_release_hands_off_immediately(self, tmp_path):
        a = LeaseManager(str(tmp_path), "a", lease_s=0.6)
        b = LeaseManager(str(tmp_path), "b", lease_s=0.6)
        assert a.try_acquire()
        assert not b.try_acquire()
        t0 = time.monotonic()
        a.release()
        assert b.try_acquire() and time.monotonic() - t0 < 0.6
        assert b.epoch == 2
        assert not a.renew()  # a released lease is never re-extended

    def test_a_skipped_renewal_lets_the_lease_lapse(self, tmp_path):
        """The ``jobserver.lease_renew`` site: a ``skip`` rule is a wedged
        leader, whose lease runs out while its renewal thread lives on."""
        a = LeaseManager(str(tmp_path), "a", lease_s=0.3)
        assert a.try_acquire()
        faults.arm(faults.FaultPlan([faults.FaultRule(
            "jobserver.lease_renew", match={"holder": "a"}, count=100, action="skip")]))
        a.start_renewal()
        _wait_for(lambda: not a.is_valid(), timeout=5, msg="the lapse")
        assert a.renewals == 0
        a.stop()
        assert LeaseManager(str(tmp_path), "b", lease_s=0.3).try_acquire()


# -- the pod follower ----------------------------------------------------------------


def _scripted_leader(n: int = 1):
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(n)
    srv.settimeout(DEADLINE)
    return srv, srv.getsockname()[1]


def _send_line(conn, msg):
    conn.sendall((json.dumps(msg) + "\n").encode())


def _follower(port, pid, **kw):
    from harmony_tpu_torch.jobserver.pod import PodFollower

    return PodFollower("127.0.0.1", port, pid=pid, num_executors=1,
                       pool=DevicePool(["cpu"]), join_timeout=DEADLINE, **kw)


class TestFollowerFencing:
    def test_follower_rejects_stale_epoch_run_job(self):
        """A deposed leader's late RUN_JOB (below the epoch the follower has
        seen) is answered with a failed JOB_DONE marked ``stale_epoch``."""
        srv, port = _scripted_leader()
        box = {}

        def leader_side():
            conn, _ = srv.accept()
            conn.settimeout(DEADLINE)
            f = conn.makefile("r")
            box["join"] = json.loads(f.readline())
            _send_line(conn, {"cmd": "PLAN", "job_id": "zz", "plan": {"epoch": 99},
                              "leader_epoch": 5})
            _send_line(conn, {"cmd": "RUN_JOB", "conf": {"job_id": "stale-job"}, "att": 0,
                              "executor_ids": [], "leader_epoch": 3})
            while True:
                line = f.readline()
                if not line:
                    return
                msg = json.loads(line)
                if msg.get("cmd") == "JOB_DONE":
                    box["done"] = msg
                    break
            _send_line(conn, {"cmd": "SHUTDOWN"})

        t = threading.Thread(target=leader_side, daemon=True)
        t.start()
        follower = _follower(port, 1, reconnect=False)
        ft = threading.Thread(target=follower.run, daemon=True)
        ft.start()
        ft.join(timeout=DEADLINE)
        t.join(timeout=DEADLINE)
        srv.close()
        assert not ft.is_alive(), "the follower never saw the SHUTDOWN"
        done = box["done"]
        assert done["ok"] is False and done.get("stale_epoch") is True
        assert done["job_id"] == "stale-job"
        assert follower.stale_rejected == 1
        assert follower._leader_epoch == 5
        assert box["join"]["incarnation"] == follower.incarnation

    def test_a_stale_shutdown_is_fenced_before_dispatch(self):
        """SHUTDOWN is fenced too: a deposed leader's exit must not end a
        follower its successor has."""
        srv, port = _scripted_leader()

        def leader_side():
            conn, _ = srv.accept()
            conn.makefile("r").readline()
            _send_line(conn, {"cmd": "PLAN", "job_id": "zz", "plan": {"epoch": 99},
                              "leader_epoch": 4})
            _send_line(conn, {"cmd": "SHUTDOWN", "leader_epoch": 2})
            time.sleep(0.5)
            _send_line(conn, {"cmd": "SHUTDOWN", "leader_epoch": 4})

        t = threading.Thread(target=leader_side, daemon=True)
        t.start()
        follower = _follower(port, 2, reconnect=False)
        ft = threading.Thread(target=follower.run, daemon=True)
        ft.start()
        time.sleep(0.25)
        assert ft.is_alive(), "a stale SHUTDOWN ended the follower"
        ft.join(timeout=DEADLINE)
        t.join(timeout=DEADLINE)
        srv.close()
        assert not ft.is_alive()
        assert follower.stale_rejected == 1


class TestFollowerReHello:
    def test_follower_reconnects_on_leader_loss(self):
        """With HA on, a follower whose control socket closes JOINs the
        (new) leader again under the same pid AND the same incarnation token,
        so the leader's late-join path reinstates the same process."""
        srv, port = _scripted_leader(2)
        joins = []

        def leader_side():
            conn, _ = srv.accept()
            f = conn.makefile("r")
            joins.append(json.loads(f.readline()))
            f.close()
            conn.close()  # the first leader dies
            conn2, _ = srv.accept()  # its successor, on the same port
            f2 = conn2.makefile("r")
            joins.append(json.loads(f2.readline()))
            _send_line(conn2, {"cmd": "SHUTDOWN"})

        t = threading.Thread(target=leader_side, daemon=True)
        t.start()
        follower = _follower(port, 3, reconnect=True)
        ft = threading.Thread(target=follower.run, daemon=True)
        ft.start()
        ft.join(timeout=DEADLINE)
        t.join(timeout=DEADLINE)
        srv.close()
        assert not ft.is_alive(), "the follower never saw the SHUTDOWN"
        assert [j["cmd"] for j in joins] == ["JOIN", "JOIN"]
        assert [j["pid"] for j in joins] == [3, 3]
        assert [j["incarnation"] for j in joins] == [follower.incarnation] * 2

    def test_the_rejoin_walks_the_leader_address_list(self):
        """``leader_addrs``: the first leader's address is gone for good; the
        follower JOINs the next one that answers."""
        srv, port = _scripted_leader()
        srv2, port2 = _scripted_leader()
        joins = []

        def leader_side():
            conn, _ = srv.accept()
            f = conn.makefile("r")
            joins.append(json.loads(f.readline()))
            f.close()
            conn.close()
            srv.close()  # the first address refuses from now on
            conn2, _ = srv2.accept()
            joins.append(json.loads(conn2.makefile("r").readline()))
            _send_line(conn2, {"cmd": "SHUTDOWN", "leader_epoch": 2})

        t = threading.Thread(target=leader_side, daemon=True)
        t.start()
        follower = _follower(port, 1, reconnect=True,
                             leader_addrs=[("127.0.0.1", port), ("127.0.0.1", port2)])
        ft = threading.Thread(target=follower.run, daemon=True)
        ft.start()
        ft.join(timeout=DEADLINE)
        t.join(timeout=DEADLINE)
        srv2.close()
        assert not ft.is_alive()
        assert [(j["pid"], j["incarnation"]) for j in joins] == [(1, follower.incarnation)] * 2

    def test_a_real_pod_leader_reinstates_the_rejoined_process(self):
        """The re-JOIN carries the bootstrap's incarnation, which is what a
        ``PodJobServer``'s late-join path asks of a follower it reinstates
        (only the same process is readmitted)."""
        from harmony_tpu_torch.jobserver.pod import PodFollower, PodJobServer
        from harmony_tpu_torch.parallel.mesh import Slot

        cpu = torch.device("cpu")
        pool = DevicePool([Slot(0, cpu, 0), Slot(1, cpu, 1)])
        server = PodJobServer(2, num_followers=1, device_pool=pool)
        server.start()
        t = threading.Thread(target=lambda: server.serve_pod(0), daemon=True)
        t.start()
        _wait_for(lambda: server._pod_sock is not None, msg="the control port")
        port = server._pod_sock.getsockname()[1]
        # the follower's own pool over the same global slots
        follower = PodFollower("127.0.0.1", port, pid=1, num_executors=2,
                               pool=DevicePool([Slot(0, cpu, 0), Slot(1, cpu, 1)]),
                               join_timeout=DEADLINE, reconnect=True)
        ft = threading.Thread(target=follower.run, daemon=True)
        ft.start()
        try:
            t.join(timeout=DEADLINE)
            assert not t.is_alive()
            conn, _ = server._followers[1]
            conn.shutdown(socket.SHUT_RDWR)  # the follower loses its leader connection
            _wait_for(lambda: 1 in server.reinstated, msg="the reinstatement")
            assert server.refused_joins == []
        finally:
            server.shutdown(timeout=DEADLINE)
        ft.join(timeout=DEADLINE)
        assert not ft.is_alive()
        assert follower.stale_rejected == 0


# -- the takeover --------------------------------------------------------------------


class TestRearmPolicy:
    def test_rearm_branches(self, tmp_path, monkeypatch):
        """Elastic jobs continue their attempt sequence, chained jobs resume
        from their chain, chainless ones run again, and one failing re-arm
        does not stop the rest."""
        from harmony_tpu_torch.jobserver.ha import HAController

        def conf(job_id, **user):
            cfg = _laggy_job(job_id, 1, lag=0.0)
            cfg.user.update(user)
            return cfg.to_dict()

        st = ReplayState.from_entries([
            {"seq": 1, "epoch": 1, "kind": "submission", "job": "el",
             "config": conf("el", elastic_shrink=True)},
            {"seq": 2, "epoch": 1, "kind": "dispatch", "job": "el", "attempt": 1},
            {"seq": 3, "epoch": 1, "kind": "submission", "job": "ch", "config": conf("ch")},
            {"seq": 4, "epoch": 1, "kind": "submission", "job": "raw", "config": conf("raw")},
            {"seq": 5, "epoch": 1, "kind": "submission", "job": "boom", "config": conf("boom")},
        ])

        class FakeServer:
            _chkp_root = str(tmp_path)

            def __init__(self):
                self.submitted = []

            def submit(self, cfg):
                if cfg.job_id == "boom":
                    raise RuntimeError("synthetic re-arm failure")
                self.submitted.append(cfg)

        monkeypatch.setattr(HAController, "_has_chain",
                            staticmethod(lambda server, job: job in ("el", "ch")))
        ctl = HAController.__new__(HAController)  # the policy only, no I/O
        server = FakeServer()
        assert HAController._rearm(ctl, server, st) == ["el", "ch", "raw"]
        by_id = {c.job_id: c for c in server.submitted}
        rec = by_id["el"].user["elastic_recovery"]
        assert rec == {"attempt": 2, "kind": "shrink", "lost_executors": []}
        assert by_id["ch"].user.get("resume_from_chain") is True
        assert "resume_from_chain" not in by_id["raw"].user
        assert "elastic_recovery" not in by_id["raw"].user

    def test_has_chain_reads_the_jobs_entries_under_the_root(self, tmp_path):
        from harmony_tpu_torch.jobserver.ha import HAController

        class S:
            _chkp_root = str(tmp_path)

        os.makedirs(tmp_path / "j" / "commit" / "j:model-0-1")
        assert HAController._has_chain(S(), "j")
        assert not HAController._has_chain(S(), "k")
        S._chkp_root = None
        assert not HAController._has_chain(S(), "j")

    def test_seed_done_answers_a_wait_for_a_job_the_old_leader_finished(self):
        from harmony_tpu_torch.jobserver.ha import HAController

        st = ReplayState.from_entries([
            {"seq": 1, "epoch": 1, "kind": "submission", "job": "ok", "config": {}},
            {"seq": 2, "epoch": 1, "kind": "job_done", "job": "ok", "ok": True},
            {"seq": 3, "epoch": 1, "kind": "submission", "job": "bad", "config": {}},
            {"seq": 4, "epoch": 1, "kind": "job_done", "job": "bad", "ok": False,
             "error": "ValueError: x"},
        ])
        server = _cpu_server()
        HAController._seed_done(server, st)
        assert server._jobs["ok"].result() == {"done": True, "ok": True, "replayed": True,
                                               "epoch": 1}
        with pytest.raises(RuntimeError, match="failed under a previous leader"):
            server._jobs["bad"].result()


class TestTakeover:
    def test_takeover_rearms_in_flight_submission(self, tmp_path):
        """Two controllers in one process: the leader loses its command
        plane and stops renewing mid-job; the standby takes the lease at the
        next epoch, re-arms the SAME submission and the failover client gets
        its result; the deposed leader's completion never lands in the log."""
        from harmony_tpu_torch.jobserver.client import CommandSender
        from harmony_tpu_torch.jobserver.ha import HAController

        ha_dir = str(tmp_path / "ha")
        epochs = 4
        a = HAController(_cpu_server, log_dir=ha_dir, replica_id="rep-a", submit_port=0,
                         lease_s=0.6).start()
        b = None
        try:
            assert a.wait_leader(DEADLINE), "the first replica must take the lease"
            assert a.lease.epoch == 1
            a_addr = f"127.0.0.1:{a.port}"
            resp = CommandSender(addrs=[a_addr]).send_job_submit_command(
                _laggy_job("ha-victim", epochs))
            assert resp.get("ok"), resp
            # the leader crashes mid-job as far as the others see: its command
            # plane is gone and its renewals stop, but its dispatch runs on
            a.server._stop_tcp()
            a.lease.stop()
            b = HAController(_cpu_server, log_dir=ha_dir, replica_id="rep-b",
                             submit_port=0, lease_s=0.6).start()
            b_early = f"127.0.0.1:{b.port}"
            with pytest.raises(Exception):
                CommandSender(b.port).send_job_submit_command(_laggy_job("other", 1))
            assert b.wait_leader(DEADLINE), "the standby must take over"
            assert b.lease.epoch == 2
            assert f"127.0.0.1:{b.port}" == b_early  # the same port, vacated and served
            result = CommandSender(addrs=[a_addr, b_early]).wait_result("ha-victim",
                                                                       timeout=120)
            (w,) = result["workers"].values()
            assert len(w["losses"]) + int(w["starting_epoch"]) == epochs
            ha = CommandSender(b.port).send_status_command()["ha"]
            assert ha["enabled"] and ha["role"] == "leader" and ha["leader_epoch"] == 2
            tk = ha["takeovers"][-1]
            assert (tk["old_leader"], tk["new_leader"]) == ("rep-a", "rep-b")
            assert tk["rearmed"] == ["ha-victim"] and tk["replay_ms"] > 0
            assert ha["log"]["appends"] > 0 and ha["lease"]["held"]
            # the deposed leader's server: deposed, its appends refused
            assert a.server._ha_status()["role"] == "deposed"
            assert not a.server._ha_append("probe")
            _wait_for(lambda: not a.server.running_jobs(), msg="the deposed leader's job")
            # job_done is written by the future's callback, after WAIT's reply
            _wait_for(lambda: "ha-victim" in ReplayState.from_entries(
                b.server.ha_log.entries()).done, msg="the successor's job_done")
            st = ReplayState.from_entries(b.server.ha_log.entries())
            done = st.done["ha-victim"]
            assert int(done["epoch"]) == 2 and done["ok"]
            assert st.rejected_stale == 0
        finally:
            if b is not None:
                b.stop()
            a.stop()


    def test_a_successor_adopts_a_persisted_open_incident(self, tmp_path):
        """The leader's incident engine opens an incident (an ``slo`` trigger),
        whose ``kind="incident"`` transition the HA tee makes durable; the
        standby that takes over adopts it OPEN (STATUS: ``adopted`` 1), and
        evidence after the takeover joins it and resolves it."""
        from harmony_tpu_torch.jobserver.client import CommandSender
        from harmony_tpu_torch.jobserver.ha import HAController

        ha_dir = str(tmp_path / "ha")
        a = HAController(_cpu_server, log_dir=ha_dir, replica_id="rep-a", submit_port=0,
                         lease_s=0.6).start()
        b = None
        try:
            assert a.wait_leader(DEADLINE), "the first replica must take the lease"
            joblog.record_event("inc-job", "slo", attainment=0.3, target=100.0)
            a.server.incidents.correlate()
            (inc,) = a.server.incidents.open_incidents()
            assert inc["subject"] == "inc-job" and inc["trigger_kind"] == "slo"
            assert inc["incident_id"] in ReplayState.from_entries(
                a.server.ha_log.entries()).incidents
            a.server._stop_tcp()
            a.lease.stop()
            b = HAController(_cpu_server, log_dir=ha_dir, replica_id="rep-b",
                             submit_port=0, lease_s=0.6).start()
            assert b.wait_leader(DEADLINE), "the standby must take over"
            status = CommandSender(b.port).send_status_command()
            assert status["incidents"]["adopted"] == 1
            (adopted,) = b.server.incidents.open_incidents()
            assert adopted["incident_id"] == inc["incident_id"]
            assert adopted["status"] == "open" and adopted["chain"] == inc["chain"]
            joblog.record_event("inc-job", "elastic_restore", recovery="restored")
            b.server.incidents.correlate()
            assert b.server.incidents.open_incidents() == []
            (done,) = [i for i in b.server.incidents.recent()
                       if i["incident_id"] == inc["incident_id"]]
            assert (done["status"], done["verdict"]) == ("resolved", "recovered")
        finally:
            if b is not None:
                b.stop()
            a.stop()
            joblog.clear_events("inc-job")


class TestDurableSink:
    def test_event_fields_never_clash_with_envelope(self, tmp_path):
        """Joblog events with envelope-named fields (an elastic fence's own
        ``epoch``, a diagnosis's ``job``) land as ``ev_*``."""
        server = _cpu_server()
        log = DurableJobLog(str(tmp_path / "job.walog"))
        try:
            server.enable_ha(log)
            joblog.record_event("j1", "elastic_shrink_fence", epoch=7, attempt=2)
            joblog.record_event("j1", "diagnosis", job="j1", rule="straggler")
            entries = log.entries()
            assert [e["kind"] for e in entries] == ["elastic_shrink_fence", "diagnosis"]
            fence = entries[0]
            assert fence["ev_epoch"] == 7
            assert fence["epoch"] == 0
            assert fence["attempt"] == 2
            assert entries[1]["ev_job"] == "j1"
        finally:
            server._stop_ha()

    def test_a_submission_and_its_completion_are_durable(self, tmp_path):
        """``submit`` writes the whole config before it acknowledges, the
        dispatch carries its executors and attempt, and the future's end
        writes ``job_done``; a log that refuses the record refuses the
        submission, registering nothing."""
        server = _cpu_server()
        log = DurableJobLog(str(tmp_path / "job.walog"))
        server.enable_ha(log)
        server.start()
        try:
            cfg = _laggy_job("dur", 1, lag=0.0)
            server.submit(cfg).result(timeout=DEADLINE)
            _wait_for(lambda: any(e["kind"] == "job_done" for e in log.entries()),
                      msg="job_done")
            kinds = {e["kind"]: e for e in log.entries()}
            assert kinds["submission"]["config"] == cfg.to_dict()
            assert kinds["dispatch"]["executors"] == ["executor-0"]
            assert kinds["dispatch"]["attempt"] == 0
            assert kinds["job_done"]["ok"] is True
            faults.arm(faults.FaultPlan([faults.FaultRule(
                "jobserver.log_append", match={"kind": "submission"}, count=1,
                action="raise")]))
            with pytest.raises(RuntimeError, match="not durable"):
                server.submit(_laggy_job("refused", 1, lag=0.0))
            assert "refused" not in server._jobs
        finally:
            faults.disarm()
            server.shutdown(timeout=DEADLINE)
        assert server.ha_log is None and log._closed


class TestNotLeaderRedirect:
    def test_standby_redirects_to_leader(self):
        from harmony_tpu_torch.jobserver.client import CommandSender, NotLeaderError
        from harmony_tpu_torch.jobserver.ha import StandbyEndpoint

        leader = _cpu_server()
        leader.start()
        lport = leader.serve_tcp(0)
        standby = StandbyEndpoint(0, info_fn=lambda: {"role": "standby"},
                                  leader_hint_fn=lambda: f"127.0.0.1:{lport}")
        sport = standby.start()
        try:
            st = CommandSender(sport).send_status_command()
            assert st["state"] == "STANDBY" and st["ok"] and st["ha"] == {"role": "standby"}
            with pytest.raises(NotLeaderError) as ei:
                CommandSender(sport).send_job_submit_command(_laggy_job("redir", 1, lag=0.0))
            assert ei.value.leader == f"127.0.0.1:{lport}"
            sender = CommandSender(addrs=[f"127.0.0.1:{sport}"])
            resp = sender.send_job_submit_command(_laggy_job("redir", 1, lag=0.0))
            assert resp.get("ok"), resp
            assert sender._leader_hint == f"127.0.0.1:{lport}"
            assert sender.wait_result("redir", timeout=60)["workers"]
        finally:
            standby.stop()
            leader.shutdown(timeout=60)

    def test_a_deposed_leader_gates_its_commands(self, tmp_path):
        """Once its lease lapsed and a successor holds it, a leader answers
        SUBMIT, WAIT, SERVING and POD_RESHARD with NOT_LEADER and the
        holder's address; STATUS (role ``deposed``) and SHUTDOWN pass."""
        from harmony_tpu_torch.jobserver.server import NotLeader

        mine = LeaseManager(str(tmp_path), "old", lease_s=0.3, addr="127.0.0.1:1")
        assert mine.try_acquire()
        server = _cpu_server()
        server.enable_ha(DurableJobLog(str(tmp_path / "job.walog")), lease=mine,
                         replica_id="old")
        server.start()
        port = server.serve_tcp(0)
        try:
            assert server.leader_epoch == 1
            assert _raw(port, {"command": "STATUS"})["ha"]["role"] == "leader"
            time.sleep(0.35)
            heir = LeaseManager(str(tmp_path), "new", lease_s=0.6, addr="127.0.0.1:4242")
            assert heir.try_acquire() and heir.epoch == 2
            for msg in ({"command": "SUBMIT", "conf": _laggy_job("x", 1).to_dict()},
                        {"command": "WAIT", "job_id": "x"}, {"command": "SERVING"},
                        {"command": "POD_RESHARD", "job_id": "x", "src": "a", "dst": "b",
                         "num_blocks": 1, "epoch": 9}):
                reply = _raw(port, msg)
                assert reply["not_leader"] is True and reply["ok"] is False, msg
                assert reply["leader"] == "127.0.0.1:4242", msg
            status = _raw(port, {"command": "STATUS"})
            assert status["ok"] and status["ha"]["role"] == "deposed"
            assert not server._ha_append("late")
            with pytest.raises(NotLeader):
                server.submit(_laggy_job("y", 1))
            assert "y" not in server._jobs
            assert [e["kind"] for e in server.ha_log.entries()] == []
            assert _raw(port, {"command": "SHUTDOWN"})["ok"]
            _wait_for(lambda: server.state == "CLOSED", msg="the shutdown")
        finally:
            server.shutdown(timeout=DEADLINE)
        assert lease.read_lease(str(tmp_path))["holder"] == "new"  # not released by "old"


# -- across packages -------------------------------------------------------------------


PAYLOADS = [b"", b"{}", json.dumps({"seq": 1, "kind": "submission", "job": "j",
                                    "config": {"user": {"x": [1, 2.5, None]}}},
                                   sort_keys=True).encode(),
            "{\"k\": \"\\u00e9\\u6f22\"}".encode(), bytes(range(256)) * 8]


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_encode_record_is_the_references_bytes(i):
    assert halog.encode_record(PAYLOADS[i]) == ref_halog.encode_record(PAYLOADS[i])


def _appends(log_cls, path):
    log = log_cls(path)
    log.append("submission", job_id="a", config={"job_id": "a", "user": {"n": 1.5}})
    log.append("dispatch", job_id="a", executors=["executor-0"], attempt=0)
    log.set_epoch(2)
    log.append("leader_takeover", old_leader="r0", new_leader="r1", rearmed=["a"])
    log.append("job_done", job_id="a", ok=True)
    log.close()


def test_the_same_appends_write_the_references_file(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    _appends(DurableJobLog, str(tmp_path / "port.walog"))
    _appends(ref_halog.DurableJobLog, str(tmp_path / "ref.walog"))
    assert (tmp_path / "port.walog").read_bytes() == (tmp_path / "ref.walog").read_bytes()


def _mixed_log(log_cls, path):
    """A log as two leaders leave it on a shared directory: epoch 1's
    entries, its successor's at epoch 2, the deposed leader's late writes at
    epoch 1 after them, and a torn tail."""
    old = log_cls(path)
    old.set_epoch(1)
    old.append("submission", job_id="a", config={"job_id": "a"})
    old.append("dispatch", job_id="a", attempt=0)
    old.append("submission", job_id="b", config={"job_id": "b"})
    new = log_cls(path)
    new.set_epoch(2)
    new.append("leader_takeover", old_leader="r0", new_leader="r1", rearmed=["a", "b"])
    new.append("elastic_shrink", job_id="a", attempt=1)
    new.append("chkp_chain", job_id="b", chkp_id="b:model-2-9")
    new.append("job_done", job_id="b", ok=True)
    old.append("job_done", job_id="a", ok=True)     # the deposed leader's late writes
    old.append("incident", incident_id="i1", state="open")
    new.append("submission", job_id="c", config={"job_id": "c"})
    old.close()
    new.close()
    with open(path, "ab") as f:
        f.write(b"\x10\x00\x00\x00\x01\x02\x03\x04{\"seq\":")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_log_replays_alike_in_both_packages(tmp_path, writer):
    path = str(tmp_path / "job.walog")
    _mixed_log(DurableJobLog if writer == "port" else ref_halog.DurableJobLog, path)
    mine, ref = halog.scan_records(path), ref_halog.scan_records(path)
    assert mine == ref
    entries, good, torn = mine
    assert torn > 0 and good + torn == os.path.getsize(path)
    st = ReplayState.from_entries(entries)
    want = ref_halog.ReplayState.from_entries(entries)
    assert st.to_dict() == want.to_dict()
    assert st.rejected_stale == 2 and st.in_flight() == ["a", "c"]
    assert (st.chains, st.attempts) == (want.chains, want.attempts)
    assert halog.replay_file(path).to_dict() == ref_halog.replay_file(path).to_dict()
    # and the other package's writer reopens it: the same torn bytes cut
    reader = ref_halog.DurableJobLog if writer == "port" else DurableJobLog
    reopened = reader(path)
    assert reopened.torn_recovered == torn and os.path.getsize(path) == good
    reopened.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_lease_file_is_read_by_the_other_package(tmp_path, writer):
    mgr_cls = LeaseManager if writer == "port" else ref_lease.LeaseManager
    mgr = mgr_cls(str(tmp_path), "w", lease_s=0.6, addr="127.0.0.1:7001")
    assert mgr.try_acquire() and mgr.renew()
    for read_lease, hint in ((lease.read_lease, lease.leader_hint),
                             (ref_lease.read_lease, ref_lease.leader_hint)):
        cur = read_lease(str(tmp_path))
        assert (cur["holder"], cur["epoch"], cur["addr"]) == ("w", 1, "127.0.0.1:7001")
        assert hint(str(tmp_path)) == "127.0.0.1:7001"
        assert hint(str(tmp_path), own_holder_id="w") is None
    assert lease.read_lease(str(tmp_path)) == ref_lease.read_lease(str(tmp_path))
    mgr.release()
    assert lease.leader_hint(str(tmp_path)) is None is ref_lease.leader_hint(str(tmp_path))


def test_epochs_stay_monotonic_when_the_packages_contend(tmp_path):
    port = LeaseManager(str(tmp_path), "port", lease_s=0.3)
    ref = ref_lease.LeaseManager(str(tmp_path), "ref", lease_s=0.3)
    epochs = []
    holders = [(port, ref), (ref, port), (port, ref), (ref, port)]
    for winner, loser in holders:
        deadline = time.monotonic() + DEADLINE
        while not winner.try_acquire():
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert not loser.try_acquire()  # a live peer of the other package holds it
        epochs.append(winner.epoch)
        if len(epochs) % 2:
            winner.release()   # a hand-off
        else:
            winner.stop()      # a death: the lease runs out
    assert epochs == [1, 2, 3, 4]
    # the last holder (the reference's, stopped but not lapsed yet) renews at
    # its epoch; the port's manager, deposed, does not
    assert ref.renew() and not port.renew()
    assert lease.read_lease(str(tmp_path))["epoch"] == 4
