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
                   "jobserver/scheduler.py", "bench.py"):
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
            "harmony_tpu_torch.apps.lda", "harmony_tpu_torch.bench"} <= set(modules)
    code = ("import sys\n"
            f"for m in {modules!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'harmony_tpu'))\n"
            "print(len(bad)); print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "0", out.stdout
