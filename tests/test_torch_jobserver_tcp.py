"""harmony_tpu_torch's TCP command plane against harmony_tpu's, on the CPU.

The port's JobServer answers ``SUBMIT``, ``STATUS``, ``WAIT``, ``SERVING``,
``SHUTDOWN`` and ``POD_RESHARD`` over TCP; the CLI's ``start-jobserver``,
``submit``, ``status`` and ``shutdown`` drive it. The wire is the
reference's: the reference's ``CommandSender``, ``ServingClient`` and
``protocol.recv_frame`` talk to the port's server and serving endpoint, and
the port's client talks to the reference's server. A live read of a job
that is training leaves its losses the bits of an unread run. The overload
ladder takes the reference's steps on one scripted queue trace. Every
socket binds port 0 and has a timeout; every server is shut down by a
fixture finaliser.
"""
import json
import os
import select
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from harmony_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from harmony_tpu.config.params import TableConfig as JaxTableConfig
from harmony_tpu.jobserver.client import CommandSender as JaxCommandSender
from harmony_tpu.jobserver.overload import OverloadMonitor as JaxOverloadMonitor
from harmony_tpu.jobserver.policy import ActionGate as JaxActionGate
from harmony_tpu.jobserver.server import JobServer as JaxJobServer
from harmony_tpu.parallel import DevicePool as JaxDevicePool
from harmony_tpu.serving import ServingClient as JaxServingClient
from harmony_tpu.serving import protocol as jax_protocol
from harmony_tpu_torch import cli
from harmony_tpu_torch.checkpoint import CheckpointManager
from harmony_tpu_torch.jobserver.client import CommandSender, ServerBusyError
from harmony_tpu_torch.jobserver.overload import OverloadMonitor
from harmony_tpu_torch.jobserver.policy import ActionGate
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.serving import ServingClient


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 30.0
SMALL = ["--batches", "2", "--set", "vocab_size=512", "--set", "num_slots=4",
         "--data", "vocab_size=512", "--data", "num_slots=4", "--data", "n=512"]


def _wd_config(job_id, epochs, *extra):
    args = cli.build_parser().parse_args(
        ["run", "widedeep", "--job-id", job_id, "--epochs", str(epochs), *SMALL, *extra])
    return cli.build_config("widedeep", args)


class Servers:
    def __init__(self):
        self.started = []

    def port(self, chkp_root=None):
        server = JobServer(1, device_pool=DevicePool([torch.device("cpu")]),
                           chkp_root=chkp_root)
        server.start()
        self.started.append(server)
        return server, server.serve_tcp(0)

    def stop(self):
        for server in self.started:
            server.shutdown(timeout=120)


@pytest.fixture()
def servers():
    s = Servers()
    yield s
    s.stop()


def _losses(result):
    (w,) = result["workers"].values()
    return w["batch_losses"]


# -- the commands ----------------------------------------------------------------


def test_submit_status_wait_serving_shutdown_round_trips(servers, tmp_path):
    server, port = servers.port(chkp_root=str(tmp_path))
    sender = CommandSender(port, timeout=TIMEOUT)
    status = sender.send_status_command()
    # the fields of the subsystems the port has, and no others
    assert set(status) == {"ok", "state", "running", "evaluated", "serving", "overload",
                           "ha", "job_events", "fault_counters", "stragglers", "tenants",
                           "phase_budget", "metrics_port", "history", "diagnoses",
                           "incidents"}
    assert status["ok"] and status["state"] == "INIT" and status["serving"] is None
    assert status["ha"] == {"enabled": False}   # the reference's reply outside HA
    assert status["overload"]["ladder"] == "normal"
    reply = sender.send_job_submit_command(_wd_config("rt", 2, "--model-chkp-period", "1"))
    assert reply == {"ok": True, "job_id": "rt"}
    result = sender.wait_result("rt", timeout=TIMEOUT, poll=5.0)
    assert len(_losses(result)) == 4 and len(result["model_chkp_ids"]) == 2
    # the job's tenant row and phase budget ride STATUS, JSON and all
    status = sender.send_status_command()
    tenant, budget = status["tenants"]["rt"], status["phase_budget"]["rt"]
    assert tenant["steps_total"] >= 4 and tenant["mfu"] is None
    assert tenant["bytes"]["chkp_write"] > 0 and tenant["straggler_ratio"] == 1.0
    assert budget["classification"] in ("input-bound", "comm-bound", "dispatch-bound",
                                        "compute-bound", "balanced")
    assert status["stragglers"]["rt"]["ratio"] == 1.0
    # a finished job's WAIT answers at once; an unknown one is refused
    assert sender.send_wait_command("rt", timeout=1.0)["done"]
    assert sender.send_wait_command("ghost", timeout=1.0) == {
        "ok": False, "known": False, "error": "unknown job 'ghost'"}
    first = sender.send_serving_command()
    assert first["ok"] and first["port"] > 0 and first["host"] == "127.0.0.1"
    assert sender.send_serving_command() == first      # started once
    # the finished job's chain serves pinned reads
    rows, meta = ServingClient(port=port, timeout=TIMEOUT).lookup("rt", [0, 1, 5], "pinned")
    assert meta["mode"] == "pinned" and meta["epoch"] == 1 and rows.shape == (3, 9)
    assert sender.send_status_command()["serving"]["port"] == first["port"]
    assert sender.send_pod_reshard_command("rt", "a", "b", 1, 1) == {
        "ok": False, "error": "not a pod server"}
    assert sender._roundtrip({"command": "FROB"}) == {
        "ok": False, "error": "unknown command 'FROB'"}
    assert sender.send_shutdown_command() == {"ok": True}
    deadline = time.monotonic() + TIMEOUT
    while server.state != "CLOSED" and time.monotonic() < deadline:
        time.sleep(0.05)
    assert server.state == "CLOSED" and server.serving is None
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2.0).close()


def test_a_failed_job_reaches_wait_as_an_error(servers):
    server, port = servers.port()
    sender = CommandSender(port, timeout=TIMEOUT)
    bad = _wd_config("bad", 1).replace(trainer="harmony_tpu_torch.apps.widedeep:Nope")
    assert sender.send_job_submit_command(bad)["ok"]
    with pytest.raises(RuntimeError, match="job bad failed"):
        sender.wait_result("bad", timeout=TIMEOUT, poll=5.0)


def test_the_cli_submits_queries_and_shuts_down_a_server(servers, capsys):
    server, port = servers.port()
    assert cli.main(["submit", "widedeep", "--port", str(port), "--job-id", "c1",
                     "--epochs", "2", *SMALL]) == 0
    assert json.loads(capsys.readouterr().out) == {"ok": True, "job_id": "c1"}
    CommandSender(port, timeout=TIMEOUT).wait_result("c1", timeout=TIMEOUT, poll=5.0)
    assert cli.main(["status", "--port", str(port)]) == 0
    status = json.loads(capsys.readouterr().out)
    assert status["ok"] and status["running"] == []
    # a duplicate of a running id is refused with exit code 1
    assert cli.main(["submit", "widedeep", "--port", str(port), "--job-id", "c2",
                     "--epochs", "400", *SMALL]) == 0
    capsys.readouterr()
    assert cli.main(["submit", "widedeep", "--port", str(port), "--job-id", "c2",
                     "--epochs", "1", *SMALL]) == 1
    assert "duplicate job id c2" in json.loads(capsys.readouterr().out)["error"]
    assert cli.main(["shutdown", "--port", str(port)]) == 0
    assert json.loads(capsys.readouterr().out) == {"ok": True}


def test_start_jobserver_prints_its_port_and_exits_0_on_shutdown(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "harmony_tpu_torch.cli", "start-jobserver", "--device", "cpu",
         "--port", "0", "--chkp-root", str(tmp_path)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], TIMEOUT)
        assert ready, "no ready line within the timeout"
        line = proc.stdout.readline()
        assert line.startswith("jobserver ready on port "), (line, proc.stderr.read())
        port = int(line.split()[-1])
        assert CommandSender(port, timeout=TIMEOUT).send_status_command()["state"] == "INIT"
        assert cli.main(["shutdown", "--port", str(port)]) == 0
        assert proc.wait(timeout=TIMEOUT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)


def test_start_jobserver_refuses_the_card_it_does_not_have():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        cli.main(["start-jobserver", "--port", "0"])


# -- the wire against the reference -------------------------------------------------


def test_the_references_clients_talk_to_the_port(servers, tmp_path):
    """The reference's CommandSender submits, waits, finds the endpoint and
    shuts the port's server down; its ServingClient and recv_frame read the
    port's endpoint."""
    server, port = servers.port(chkp_root=str(tmp_path))
    sender = JaxCommandSender(port, timeout=TIMEOUT)
    assert sender.send_status_command()["state"] == "INIT"
    # the reference's client only calls config.to_dict()
    reply = sender.send_job_submit_command(_wd_config("x1", 2, "--model-chkp-period", "1"))
    assert reply == {"ok": True, "job_id": "x1"}
    result = sender.wait_result("x1", timeout=TIMEOUT, poll=5.0)
    assert len(_losses(result)) == 4
    srv = sender.send_serving_command()
    assert srv["ok"]
    client = JaxServingClient(port=port, timeout=TIMEOUT)
    try:
        rows, meta = client.lookup("x1", [0, 3, 3], mode="pinned")
        assert meta["epoch"] == 1 and rows.dtype == np.float32
        want = CheckpointManager.for_job(str(tmp_path), "x1")
        newest = max((want.info(c) for c in want.list_checkpoints()),
                     key=lambda i: i.app_meta["epoch"])
        assert meta["chkp"] == newest.chkp_id
        assert client.stats()["tenants"]["x1"]["pinned_epoch"] == 1
        assert client.ping()
    finally:
        client.close()
    sock = jax_protocol.connect(("127.0.0.1", srv["port"]), timeout=TIMEOUT)
    sock.settimeout(TIMEOUT)
    try:
        jax_protocol.send_arrays(sock, {"op": "lookup", "r": 5, "job": "x1",
                                        "mode": "pinned"}, (np.array([3], np.int32),))
        frame = jax_protocol.recv_frame(sock)
        assert frame["r"] == 5 and frame["data"][0].tobytes() == rows[1:2].tobytes()
        jax_protocol.send_arrays(sock, {"op": "lookup", "r": 6, "job": "x1",
                                        "mode": "live"}, (np.array([3], np.int32),))
        assert jax_protocol.recv_frame(sock)["error"] == (
            "LookupError: no live table for job 'x1'")
    finally:
        sock.close()
    assert sender.send_shutdown_command() == {"ok": True}


def test_the_ports_clients_talk_to_the_reference(tmp_path, devices):
    """The port's CommandSender and ServingClient against the reference's
    JobServer: STATUS, SERVING, and a pinned read of a chain the reference
    wrote."""
    master_root = str(tmp_path)
    from harmony_tpu.runtime import ETMaster as JaxETMaster

    master = JaxETMaster(JaxDevicePool(devices[:2]))
    exs = master.add_executors(2)
    h = master.create_table(JaxTableConfig(table_id="rj:m", capacity=32, value_shape=(2,),
                                           num_blocks=8), [e.id for e in exs])
    h.table.multi_update(list(range(32)),
                         np.random.default_rng(1).standard_normal((32, 2)).astype(np.float32))
    want = np.asarray(h.table.multi_get(list(range(32))))
    JaxCheckpointManager.for_job(master_root, "rj").checkpoint(
        h, commit=True, app_meta={"epoch": 0.0})
    server = JaxJobServer(num_executors=2, device_pool=JaxDevicePool(devices[2:4]),
                          chkp_root=master_root)
    server.start()
    try:
        port = server.serve_tcp()
        sender = CommandSender(port, timeout=TIMEOUT)
        assert sender.send_status_command()["ok"]
        client = ServingClient(port=port, timeout=TIMEOUT)
        try:
            rows, meta = client.lookup("rj", [0, 9, 31], mode="pinned")
        finally:
            client.close()
        assert meta["epoch"] == 0 and rows.tobytes() == want[[0, 9, 31]].tobytes()
    finally:
        if server.serving is not None and server.serving._sock is not None:
            server.serving._sock.shutdown(socket.SHUT_RDWR)
        server.shutdown(timeout=60.0)


# -- a job read while it trains -------------------------------------------------------


def test_a_live_read_of_a_training_job_leaves_its_losses_unchanged(servers, monkeypatch):
    """ServingClient reads a widedeep job's live table while it trains: the
    rows are finite, their data moves, and the job's losses are the bits of
    the same job run unread. Each step first sleeps 2 ms outside the table
    lock, so that the reads interleave with the steps on a loaded host."""
    from harmony_tpu_torch.table.table import DenseTable

    step = DenseTable.apply_step

    def paced(self, *args):
        time.sleep(0.002)
        return step(self, *args)

    monkeypatch.setattr(DenseTable, "apply_step", paced)
    server, port = servers.port()
    sender = CommandSender(port, timeout=TIMEOUT)
    epochs = 150
    assert sender.send_job_submit_command(_wd_config("read", epochs))["ok"]
    client = ServingClient(port=port, timeout=TIMEOUT)
    seen = []
    try:
        deadline = time.monotonic() + TIMEOUT
        while "read" in server.running_jobs() and len(seen) < 200:
            assert time.monotonic() < deadline
            try:
                rows, meta = client.lookup("read", [0, 5, 99, 5], timeout=5.0)
            except RuntimeError as e:   # before the set-up, or after the end
                assert "no live table" in str(e)
                continue
            assert meta == {"mode": "live", "layout_version": 0}
            assert rows.shape == (4, 9) and np.isfinite(rows).all()
            assert rows[1].tobytes() == rows[3].tobytes()
            seen.append(rows)
    finally:
        client.close()
    read = sender.wait_result("read", timeout=TIMEOUT, poll=5.0)
    assert len(seen) >= 5
    assert any(a.tobytes() != b.tobytes() for a, b in zip(seen, seen[1:]))
    assert sender.send_job_submit_command(_wd_config("unread", epochs))["ok"]
    unread = sender.wait_result("unread", timeout=TIMEOUT, poll=5.0)
    assert np.asarray(_losses(read), np.float32).tobytes() == np.asarray(
        _losses(unread), np.float32).tobytes()
    assert sender.send_status_command()["serving"]["tenants"]["read"]["requests"] == len(seen)


# -- admission ----------------------------------------------------------------------


def test_a_submit_shed_at_admission_leaves_no_trace(servers):
    server, port = servers.port()
    calls = [0]

    def flaky_admit(queue_depth, queue_cap, inflight):
        calls[0] += 1
        return 120 if calls[0] % 2 == 1 else None

    server.overload.admit_submit = flaky_admit
    sender = CommandSender(port, timeout=TIMEOUT)
    accepted, rejected = [], []
    for i in range(4):
        jid = f"shed-{i}"
        try:
            reply = sender._roundtrip_one(f"127.0.0.1:{port}", {
                "command": "SUBMIT", "conf": _wd_config(jid, 1).to_dict()})
        except ServerBusyError as e:
            assert e.retry_after_ms == 120
            rejected.append(jid)
            continue
        assert reply == {"ok": True, "job_id": jid}
        accepted.append(jid)
    assert accepted == ["shed-1", "shed-3"] and rejected == ["shed-0", "shed-2"]
    assert not set(rejected) & set(server._jobs)
    for jid in accepted:
        assert server._jobs[jid].result(timeout=TIMEOUT)


def _taken(server):
    """The command worker has dequeued a connection (the monitor saw its lag)."""
    return server.overload._lag_sec > 0


def test_a_full_accept_queue_answers_busy_at_the_door(monkeypatch):
    monkeypatch.setenv("HARMONY_CMD_WORKERS", "1")
    monkeypatch.setenv("HARMONY_CMD_QUEUE", "1")
    monkeypatch.setenv("HARMONY_CMD_DEADLINE_MS", "3000")
    server = JobServer(1, device_pool=DevicePool([torch.device("cpu")]))
    server.start()
    port = server.serve_tcp(0)
    hold = []
    try:
        # one connection holds the worker (it never sends), one fills the queue
        # the worker takes the first (the queue drains), the second waits in it
        for depth in (0, 1):
            hold.append(socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT))
            deadline = time.monotonic() + TIMEOUT
            while server._cmd_queue.qsize() != depth or len(hold) == 1 and not _taken(server):
                assert time.monotonic() < deadline
                time.sleep(0.01)
        with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as s:
            s.settimeout(TIMEOUT)
            reply = json.loads(s.makefile().readline())
        assert reply["busy"] and reply["retry_after_ms"] >= 100
        assert server.overload.status()["sheds"]["accept_shed"] == 1
        # the silent client is evicted at the command deadline
        hold[0].settimeout(TIMEOUT)
        evicted = json.loads(hold[0].makefile().readline())
        assert "deadline" in evicted["error"]
    finally:
        for s in hold:
            s.close()
        server.shutdown(timeout=60)


def test_the_overload_ladder_takes_the_references_steps():
    """One scripted queue trace into both monitors: the same levels, admission
    answers, retry hints, shed counts and gate state at every step."""
    mons = [OverloadMonitor(gate=ActionGate(cooldown_sec=5.0, confirm=3, stale_after=600.0),
                            enabled=True),
            JaxOverloadMonitor(gate=JaxActionGate(cooldown_sec=5.0, confirm=3,
                                                  stale_after=600.0), enabled=True)]
    rng = np.random.default_rng(20)
    trace = []
    for t in range(120):
        phase = (t // 20) % 3            # calm, storm, drain
        depth = int(rng.integers(0, 12)) if phase != 1 else int(rng.integers(40, 65))
        lag = float(rng.uniform(0, 0.2)) if phase != 1 else float(rng.uniform(1, 8))
        trace.append((depth, lag, float(t)))
    seen = [[], []]
    for depth, lag, now in trace:
        for mon, out in zip(mons, seen):
            mon.note_queue(depth, 64, lag_sec=lag)
            level = mon.step(now=now)
            admit = mon.admit_submit(depth, 64, inflight=int(depth // 8))
            st = mon.status()
            st["transitions"] = [{k: v for k, v in ev.items() if k != "ts"}
                                 for ev in st["transitions"]]
            st["gate"].pop("cooling")
            out.append((level, admit, mon.retry_after_ms(), mon.shedding(),
                        mon.degraded(), st))
    assert seen[0] == seen[1]
    levels = {s[0] for s in seen[0]}
    assert levels == {0, 1, 2}       # the trace walks the whole ladder and back
    assert seen[0][-1][-1]["sheds"]["busy_reject"] > 0
