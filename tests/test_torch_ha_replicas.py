"""A real leader loss on the CPU: two replica processes of the port's HA
control plane, the leader killed mid-epoch.

The port's counterpart of the reference's ``tests/test_ha_pod.py`` acceptance,
with fewer epochs: two ``cli start-jobserver --device cpu`` replicas
(``tests/torch_ha_worker.py``) share ``HARMONY_HA_LOG_DIR`` (a 1 s lease) and
a chain root. A chained MLR submission (an entry every epoch) goes to the
leader through the failover client, and a ``crash`` rule at ``worker.step``
(fired once a plan, its count in a state file both processes share) kills the
leader's process at its 7th step, in epoch 3 of 8. The standby must win the
lease, replay the log, re-arm the SAME submission from its chain and finish
it, the client reaching the result only through failover (the dead replica
stays first in its list). Held:

* the epochs tile exactly once: the successor starts at a committed epoch > 0
  and runs the rest;
* its per-batch losses are the bits of the port's uninterrupted run of the
  same config, and its final loss is within ``tests/test_torch_apps.py``'s
  RTOL = ATOL = 1e-5 of the reference's uninterrupted run;
* the successor's STATUS: role leader at epoch 2, one ``leader_takeover``
  event naming both replicas and the re-armed job;
* the killed replica exits with the rule's code, the successor 0 after a
  SHUTDOWN.
"""
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from harmony_tpu_torch import faults
from harmony_tpu_torch.config.params import JobConfig, TrainerParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ha_worker.py")
DEADLINE = 120
EPOCHS = 8
CRASH_AFTER = 6     # the 7th step: epoch 3's first batch (2 batches an epoch)
EXIT_CODE = 77
RTOL = ATOL = 1e-5
APP = {"num_classes": 4, "num_features": 16, "features_per_partition": 4, "step_size": 0.1}
DATA = {"n": 64, "num_features": 16, "num_classes": 4, "seed": 23}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _victim(job_id: str, package: str = "harmony_tpu_torch", period: int = 1):
    if package == "harmony_tpu":
        from harmony_tpu.config.params import JobConfig as Cfg
        from harmony_tpu.config.params import TrainerParams as Params
    else:
        Cfg, Params = JobConfig, TrainerParams
    return Cfg(job_id=job_id, app_type="dolphin", trainer=f"{package}.apps.mlr:MLRTrainer",
               params=Params(num_epochs=EPOCHS, num_mini_batches=2, model_chkp_period=period,
                             app_params=dict(APP)),
               num_workers=1,
               user={"data_fn": f"{package}.apps.mlr:make_synthetic", "data_args": dict(DATA)})


def _uninterrupted(root: str):
    """The port's run of the same config in this process, on the CPU."""
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    server = JobServer(1, device_pool=DevicePool(["cpu"]), chkp_root=root)
    server.start()
    try:
        (w,) = server.submit(_victim("hav-victim")).result(timeout=DEADLINE)["workers"].values()
    finally:
        server.shutdown(timeout=DEADLINE)
    return w


def _reference_losses():
    """The reference's uninterrupted run of the same config (JAX on the CPU)."""
    import jax

    from harmony_tpu.jobserver.server import JobServer as JaxJobServer
    from harmony_tpu.parallel.mesh import DevicePool as JaxDevicePool

    server = JaxJobServer(num_executors=1, device_pool=JaxDevicePool(jax.devices("cpu")[:1]))
    server.start()
    try:
        res = server.submit(_victim("hav-ref", "harmony_tpu", period=0)).result(timeout=DEADLINE)
    finally:
        server.shutdown(timeout=DEADLINE)
    (w,) = res["workers"].values()
    return [float(x) for x in w["losses"]]


class _Lines:
    """A replica's stdout, read on a thread of its own."""

    def __init__(self, proc) -> None:
        self.lines = []
        self._cond = threading.Condition()
        threading.Thread(target=self._read, args=(proc,), daemon=True).start()

    def _read(self, proc) -> None:
        for line in proc.stdout:
            with self._cond:
                self.lines.append(line.strip())
                self._cond.notify_all()

    def wait(self, needle: str, timeout: float = DEADLINE) -> str:
        with self._cond:
            ok = self._cond.wait_for(lambda: any(needle in ln for ln in self.lines), timeout)
            assert ok, f"no {needle!r} line within {timeout} s: {self.lines}"
            return next(ln for ln in self.lines if needle in ln)


def test_leader_killed_mid_epoch_standby_completes_same_submission(tmp_path):
    from harmony_tpu_torch.jobserver.client import CommandSender

    ha_dir, chkp = tmp_path / "ha", tmp_path / "chkp"
    ha_dir.mkdir()
    chkp.mkdir()
    plan = faults.FaultPlan(
        [faults.FaultRule("worker.step", match={"job": "hav-victim"}, after=CRASH_AFTER,
                          count=1, action="crash", exit_code=EXIT_CODE)],
        state_path=str(tmp_path / "fault-state.json"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env[faults.ENV_VAR] = plan.to_json()
    ports = [_free_port(), _free_port()]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    procs, outs, errs = [], [], []
    try:
        for i, port in enumerate(ports):  # replica 0 first: it takes the lease
            err = open(tmp_path / f"rep-{i}.err", "w")
            errs.append(err)
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(ha_dir), f"rep-{i}", str(port), "1.0", str(chkp)],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err, text=True))
            outs.append(_Lines(procs[-1]))
            outs[-1].wait("standing by")
            if i == 0:
                outs[0].wait("is LEADER")
        standby = CommandSender(ports[1]).send_status_command()
        assert standby["state"] == "STANDBY" and standby["ha"]["role"] == "standby"
        sender = CommandSender(addrs=addrs)
        assert sender.send_job_submit_command(_victim("hav-victim")).get("ok")
        assert procs[0].wait(timeout=DEADLINE) == EXIT_CODE, (
            (tmp_path / "rep-0.err").read_text()[-3000:])
        leader_line = outs[1].wait("is LEADER")
        assert "epoch 2" in leader_line and '["hav-victim"]' in leader_line, leader_line
        result = sender.wait_result("hav-victim", timeout=DEADLINE)
        (w,) = result["workers"].values()
        start = int(w["starting_epoch"])
        assert 0 < start <= 3
        assert int(w["epochs_run"]) == len(w["losses"]) == EPOCHS - start
        status = CommandSender(addrs=addrs).send_status_command()
        ha = status["ha"]
        assert ha["enabled"] and ha["role"] == "leader" and ha["leader_epoch"] == 2
        tk = ha["takeovers"][-1]
        assert (tk["old_leader"], tk["new_leader"], tk["rearmed"]) == (
            "rep-0", "rep-1", ["hav-victim"])
        assert tk["replayed_entries"] > 0 and tk["rejected_stale"] == 0
        assert CommandSender(addrs=addrs).send_shutdown_command().get("ok")
        assert procs[1].wait(timeout=DEADLINE) == 0, (
            (tmp_path / "rep-1.err").read_text()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for f in errs:
            f.close()
    whole = _uninterrupted(str(tmp_path / "whole"))
    assert w["batch_losses"] == whole["batch_losses"][2 * start:]
    assert w["losses"] == whole["losses"][start:]
    ref = _reference_losses()
    assert len(ref) == EPOCHS
    np.testing.assert_allclose(whole["losses"], ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w["losses"][-1], ref[-1], rtol=RTOL, atol=ATOL)
