"""harmony_tpu_torch's entry point and its import boundary.

``python -m harmony_tpu_torch.cli run`` goes CLI -> JobServer -> job entity
-> WorkerTasklet; on the CPU only when asked (``--device cpu``). The port
imports torch and numpy, never jax and nothing of harmony_tpu: checked on
the source (every import statement of the package and of chip_smoke.py) and
in a fresh interpreter (this test process already holds jax, from
tests/conftest.py).
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from harmony_tpu_torch import cli
from harmony_tpu_torch.config.params import JobConfig, TrainerParams
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.parallel.mesh import DevicePool

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "harmony_tpu_torch"
SMALL = ["--set", "vocab_size=512", "--set", "num_slots=4", "--set", "hidden=16",
         "--data", "n=512", "--data", "vocab_size=512", "--data", "num_slots=4"]


def test_run_widedeep_on_the_cpu_prints_the_result(capsys):
    assert cli.main(["run", "widedeep", "--device", "cpu", "--epochs", "2",
                     "--batches", "4", *SMALL]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["job_id"] == "widedeep-job"
    (worker,) = out["result"]["workers"].values()
    assert worker["epochs_run"] == 2 and len(worker["batch_losses"]) == 8
    assert all(np.isfinite(worker["batch_losses"]))


def test_run_matches_the_reference_cli(capsys):
    """The port's CLI and harmony_tpu's (on one executor, the port's one
    device), same preset and overrides: the same per-epoch losses (f32 sums
    in another order: 1e-5 absolute)."""
    from harmony_tpu import cli as jax_cli

    args = ["run", "fm", "--epochs", "2", "--batches", "2", *SMALL[:4], *SMALL[6:]]
    assert jax_cli.main(args + ["--num-executors", "1"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (jw,) = want["result"]["workers"].values()
    (tw,) = got["result"]["workers"].values()
    np.testing.assert_allclose(tw["losses"], jw["losses"], rtol=0, atol=1e-5)


def test_run_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run goes to it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["run", "widedeep", *SMALL])


def test_run_lm_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run goes to it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["run", "lm", "--epochs", "1", "--batches", "1"])


def test_jobserver_runs_jobs_in_order_and_reports_failures():
    server = JobServer(1, scheduler="fifo", device_pool=DevicePool(["cpu"]))
    server.start()
    try:
        ok = JobConfig(
            job_id="a", app_type="dolphin",
            trainer="harmony_tpu_torch.apps.widedeep:FMTrainer",
            params=TrainerParams(num_epochs=1, num_mini_batches=2,
                                 app_params={"vocab_size": 64, "num_slots": 2}),
            user={"data_fn": "harmony_tpu_torch.apps.widedeep:make_synthetic",
                  "data_args": {"n": 64, "vocab_size": 64, "num_slots": 2}})
        bad = ok.replace(job_id="b", user={})
        futures = [server.submit(ok), server.submit(bad), server.submit(ok.replace(job_id="c"))]
        assert futures[0].result(timeout=60)["job_id"] == "a"
        with pytest.raises(ValueError, match="data_fn"):
            futures[1].result(timeout=60)
        assert futures[2].result(timeout=60)["job_id"] == "c"
        assert server.master.table_ids() == []  # each job dropped its table
    finally:
        server.shutdown()
    with pytest.raises(RuntimeError):
        server.submit(ok)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_harmony_tpu():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 25
    for module in ("models/transformer.py", "models/pytree_trainer.py", "models/common.py",
                   "ops/attention.py", "dolphin/optim.py", "ops/mxu.py", "utils/prng.py",
                   "apps/mlr.py", "apps/nmf.py", "apps/lda.py", "parallel/mesh.py",
                   "jobserver/scheduler.py", "bench.py",
                   # the copies of the reference's jax-free modules
                   "utils/framing.py", "faults/partition.py", "serving/protocol.py",
                   "serving/service.py", "serving/client.py", "jobserver/client.py",
                   "jobserver/overload.py", "jobserver/policy.py", "data/parsers.py",
                   "data/splits.py", "data/storer.py", "utils/dag.py", "plan/ops.py",
                   "plan/plan.py", "plan/executor.py", "optimizer/api.py",
                   "optimizer/compiler.py", "optimizer/homogeneous.py",
                   "optimizer/hetero.py", "optimizer/sample.py",
                   "optimizer/orchestrator.py", "metrics/collector.py",
                   "metrics/manager.py", "table/blockmove.py"):
        assert PORT / module in files
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "harmony_tpu"), (
                f"{path.relative_to(REPO)} imports {mod}")


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    assert {"harmony_tpu_torch.models.transformer", "harmony_tpu_torch.ops.attention",
            "harmony_tpu_torch.dolphin.optim", "harmony_tpu_torch.utils.prng",
            "harmony_tpu_torch.apps.lda", "harmony_tpu_torch.bench",
            "harmony_tpu_torch.serving.service", "harmony_tpu_torch.serving.client",
            "harmony_tpu_torch.jobserver.client", "harmony_tpu_torch.jobserver.overload",
            "harmony_tpu_torch.utils.framing", "harmony_tpu_torch.faults.partition",
            "harmony_tpu_torch.data.parsers", "harmony_tpu_torch.data.splits",
            "harmony_tpu_torch.data.storer"} <= set(modules)
    code = ("import sys\n"
            f"for m in {modules!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'harmony_tpu'))\n"
            "print(len(bad)); print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "0", out.stdout


# -- the optimizer flags -------------------------------------------------------


def _jax_args(argv):
    """``argv`` parsed as the reference's ``run`` parses it (its parser is
    built inside its ``main``, from ``_common_job_flags``)."""
    import argparse

    from harmony_tpu import cli as jax_cli

    ap = argparse.ArgumentParser()
    ap.add_argument("cmd")
    ap.add_argument("app")
    jax_cli._common_job_flags(ap)
    return ap.parse_args(argv)


def _both_configs(argv):
    from harmony_tpu import cli as jax_cli

    app = argv[1]
    return (cli.build_config(app, cli.build_parser().parse_args(argv)),
            jax_cli.build_config(app, _jax_args(argv)))


@pytest.mark.parametrize("argv", [
    ["run", "pagerank", "--optimizer", "homogeneous"],
    ["run", "widedeep", "--optimizer", "no_such_optimizer"],
    ["run", "widedeep", "--optimizer", "harmony_tpu_torch.optimizer:Nope"],
])
def test_optimizer_flag_validation_is_the_references(argv):
    """A graph app refuses --optimizer, an unknown name fails before the
    job starts: both packages exit, and the messages name the same flag."""
    from harmony_tpu import cli as jax_cli

    app = argv[1]
    with pytest.raises(SystemExit) as got:
        cli.build_config(app, cli.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as want:
        jax_cli.build_config(app, _jax_args(argv))
    assert "--optimizer" in str(got.value) and "--optimizer" in str(want.value)


def test_optimizer_flags_reach_the_job_config():
    argv = ["run", "widedeep", "--optimizer", "add_one_server", "--optimizer-period", "0.5"]
    got, want = _both_configs(argv)
    assert (got.optimizer, got.optimizer_period) == (want.optimizer, want.optimizer_period) \
        == ("add_one_server", 0.5)
    got, want = _both_configs(["run", "widedeep"])
    assert (got.optimizer, got.optimizer_period) == (want.optimizer, want.optimizer_period) \
        == (None, 5.0)


def _owners_at_drop(master, drop_name):
    """Record each table's owning executors when it is dropped."""
    owners = {}
    drop = getattr(master, drop_name)

    def spy(tid):
        if tid in master.table_ids():
            h = master.table_handle(tid) if hasattr(master, "table_handle") \
                else master.get_table(tid)
            owners[tid] = len(h.owning_executors())
        drop(tid)

    setattr(master, drop_name, spy)
    return owners


@pytest.mark.parametrize("optimizer,executors,owners", [
    ("add_one_server", 2, 3), ("delete_one_server", 3, 2)])
def test_cli_run_with_an_optimizer_moves_blocks_mid_training(optimizer, executors, owners):
    """``run widedeep --optimizer ...`` under a JobServer of ``executors``
    executors on a pool of 4 slots (the reference's on 4 virtual devices):
    the loop moves the table while the job trains, and both end with the
    same owning executors."""
    import jax

    from harmony_tpu.jobserver import JobServer as JaxJobServer
    from harmony_tpu.parallel import DevicePool as JaxDevicePool

    argv = ["run", "widedeep", "--epochs", "3", "--batches", "4", "--optimizer",
            optimizer, "--optimizer-period", "0.05", *SMALL]
    got_cfg, want_cfg = _both_configs(argv)
    server = JobServer(executors, device_pool=DevicePool.virtual("cpu", 4))
    server.start()
    got_owners = _owners_at_drop(server.master, "drop_table")
    try:
        got = server.submit(got_cfg).result(timeout=300)
    finally:
        server.shutdown()
    ref = JaxJobServer(num_executors=executors,
                       device_pool=JaxDevicePool(jax.devices()[:4]))
    ref.start()
    want_owners = _owners_at_drop(ref.master, "_drop_table")
    try:
        want = ref.submit(want_cfg).result(timeout=300)
    finally:
        ref.shutdown()
    assert got["reconfigs"] == want["reconfigs"] == 1
    assert "optimizer_errors" not in got
    assert list(got_owners.values()) == list(want_owners.values()) == [owners]
    workers = got["workers"].values()
    assert len(workers) == executors   # --workers 0: one an executor
    assert all(w["epochs_run"] == 3 and np.all(np.isfinite(w["batch_losses"]))
               for w in workers)
    # the metric sources fed the server's manager: a BatchMetrics a batch and
    # a ServerMetrics an owning executor an epoch
    assert len(server.metrics.worker_batch_metrics(job_id=got_cfg.job_id)) == 12 * executors
    assert server.metrics.server_metrics(job_id=got_cfg.job_id)
