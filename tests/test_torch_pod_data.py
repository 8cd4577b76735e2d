"""A data axis whose rows lie in different processes of the port's pod
(``BlockSharding.row_processes``, ``combine_owned`` and ``gather_shards`` over
a row's processes, ``collectives.process_all_gather_v``,
``dolphin/rows.py::RowExchange``, ``_DataParallelStep`` and ``run_split``
over processes), on the CPU.

* Units, in four fresh interpreters of one CPU slot each over one gloo world
  on a ``FileStore``: the variable-length all-gather (uneven counts, an
  empty part, every part empty) gives every process's tensor exactly, and a
  table on (data 2, model 2), whose row 0 is processes 0 and 1 and row 1
  processes 2 and 3, reads the one-process mesh's bytes while each process
  joins only the gathers of its own row's two processes; a
  :class:`RowExchange` carries each row's tensors (of several dtypes, a
  ``None``) to every process unchanged.
* Against the port's one process, exactly: a pod of two processes with two
  CPU slots each (``cli start-pod --device cpu,cpu``), each data row in its
  own process, runs NMF, sparse LDA (a hash table beside a local table),
  GBT and Wide&Deep at ``data_axis`` 2, and every process's per-batch losses
  and the final tables (every process's owned blocks of the model and local
  tables, joined) are the one-process data-2 job's on four virtual CPU
  slots, bit for bit; each process reports the row it computed, and no
  batch was restaged. A chain of Wide&Deep at data 2 is the one-process
  data-2 chain byte for byte, and its resume continues with the
  uninterrupted run's losses.
* A row across processes: four processes of one CPU slot each, NMF at
  (data 2, model 2), exactly the one-process data-2 bits.
* Moves, optimizer plans and elastic recovery of such a job:
  ``tests/test_torch_pod_data_moves.py``.
* Against the reference's own two-process pod at ``data_axis`` 2 (two
  virtual devices a process, ``tests/pod_worker.py``): Wide&Deep's and
  NMF's losses (the reference reports each epoch's, its last batch's) within
  ``LOSS_RTOL`` = 1e-5 x max(1, |loss|): the two frameworks add f32 sums in
  other orders.

Every socket binds port 0 with a timeout, every wait has a deadline, and
every child process is killed in a ``finally``; each pod starts once.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from harmony_tpu_torch.config.params import JobConfig, TrainerParams
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.parallel.mesh import DevicePool
from test_torch_pod import DEADLINE, Pod
from test_torch_pod_chain import assert_same_entries, entries, one_process
from torch_pod_trainers import kept_tables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5

APPS = {
    "nmf": ("NMFTrainer", "nmf:make_synthetic",
            {"num_rows": 128, "num_cols": 48, "rank": 8, "step_size": 0.05},
            {"num_rows": 128, "num_cols": 48, "rank": 8}),
    "sparse-lda": ("LDATrainer", "lda:make_synthetic_sparse",
                   {"vocab_size": 80, "num_topics": 5, "num_docs": 128, "max_doc_len": 12,
                    "sparse": True},
                   {"num_docs": 128, "vocab_size": 80, "doc_len": 12, "num_topics": 5}),
    "gbt": ("GBTTrainer", "gbt:make_binned_synthetic",
            {"num_features": 6, "num_examples": 256, "num_rounds": 8, "max_depth": 3,
             "step_size": 0.4},
            {"n": 256, "num_features": 6}),
    "wd": ("WideDeepTrainer", "widedeep:make_synthetic",
           {"vocab_size": 512, "num_slots": 4, "emb_dim": 8, "hidden": 16, "step_size": 0.5},
           {"n": 512, "vocab_size": 512, "num_slots": 4}),
}
REF_TRAINERS = {"nmf": "nmf:NMFTrainer", "wd": "widedeep:WideDeepTrainer"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def job(app, keep_dir, job_id=None, epochs=2, data_axis=2, **params):
    """``app`` at ``data_axis`` on a trainer that keeps its final tables in
    ``keep_dir``."""
    trainer, data_fn, app_params, data_args = APPS[app]
    return JobConfig(job_id=job_id or app, app_type="dolphin",
                     trainer=f"tests.torch_pod_trainers:Kept{trainer}",
                     params=TrainerParams(num_epochs=epochs, num_mini_batches=4,
                                          app_params=dict(app_params, keep_dir=keep_dir),
                                          **params),
                     num_workers=1,
                     user={"data_fn": f"harmony_tpu_torch.apps.{data_fn}",
                           "data_args": dict(data_args), "data_axis": data_axis})


def ref_job(app, epochs):
    from harmony_tpu.config.params import JobConfig as RefConfig
    from harmony_tpu.config.params import TrainerParams as RefParams

    _, data_fn, app_params, data_args = APPS[app]
    return RefConfig(job_id=app, app_type="dolphin",
                     trainer=f"harmony_tpu.apps.{REF_TRAINERS[app]}",
                     params=RefParams(num_epochs=epochs, num_mini_batches=4,
                                      app_params=dict(app_params)),
                     num_workers=1, user={"data_fn": f"harmony_tpu.apps.{data_fn}",
                                          "data_args": dict(data_args), "data_axis": 2})


_ONE = {}


def one_process_run(app, tmp_path_factory, epochs=2):
    """The port's one-process data-2 run on four virtual CPU slots: its
    batch losses and its final tables."""
    if (app, epochs) not in _ONE:
        keep = str(tmp_path_factory.mktemp(f"one-{app}"))
        server = JobServer(4, device_pool=DevicePool.virtual("cpu", 4))
        server.start()
        try:
            res = server.submit(job(app, keep, epochs=epochs)).result(timeout=DEADLINE)
        finally:
            server.shutdown(timeout=DEADLINE)
        (w,) = res["workers"].values()
        assert w["mesh"] == {"data": 2, "model": 2} and w["step_mode"] == "data_parallel"
        _ONE[app, epochs] = (w["batch_losses"], kept_tables(keep, app))
    return _ONE[app, epochs]


def _worker(report):
    (w,) = report["workers"].values()
    return w


# -- units over four processes -------------------------------------------------

UNITS = r'''
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.dolphin.rows import RowExchange
from harmony_tpu_torch.parallel import collectives, multihost
from harmony_tpu_torch.parallel.mesh import DevicePool, build_mesh
from harmony_tpu_torch.table.table import DenseTable, TableSpec

COUNTS = (3, 0, 5, 1)


def part(p):
    return torch.arange(COUNTS[p] * 2, dtype=torch.float32).reshape(-1, 2) * (p + 1) - 0.5


def hexes(t):
    return np.ascontiguousarray(t.numpy()).tobytes().hex()


def tables(slots):
    mesh = build_mesh(slots, data=2, model=2)
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 64, 40).astype(np.int32)
    t = DenseTable(TableSpec(TableConfig(table_id="d", capacity=64, value_shape=(3,),
                                         num_blocks=8, is_ordered=False, update_fn="add")), mesh)
    t.multi_update(keys, rng.standard_normal((40, 3)).astype(np.float32))
    r = DenseTable(TableSpec(TableConfig(table_id="r", capacity=30, value_shape=(2,),
                                         num_blocks=6, update_fn="add")), mesh)
    r.write_all(torch.arange(60, dtype=torch.float32).reshape(30, 2) - 7.0)
    return {"pull": hexes(torch.as_tensor(t.multi_get(keys))), "all": hexes(t.pull_array()),
            "range": hexes(r.pull_array())}


if len(sys.argv) == 1:   # the one-process versions
    out = {"parts": [hexes(part(p)) for p in range(4)]}
    out.update(tables(DevicePool.virtual("cpu", 4).slots))
    print("RESULT " + json.dumps(out))
    sys.exit(0)

store, pid = sys.argv[1], int(sys.argv[2])
assert multihost.initialize_distributed(store, 4, pid, devices=["cpu"])
slots = multihost.global_slots()
out = {"pid": pid}
calls = collectives.POD_STATS["calls"]
got = collectives.process_all_gather_v(part(pid), range(4))
out["parts"] = [hexes(g) for g in got]
out["v_calls"] = collectives.POD_STATS["calls"] - calls
calls = collectives.POD_STATS["calls"]
empty = collectives.process_all_gather_v(torch.zeros((0, 2)), range(4))
out["empty_shapes"] = [list(e.shape) for e in empty]
out["empty_calls"] = collectives.POD_STATS["calls"] - calls
groups = []
real = collectives.process_all_gather


def watched(t, processes):
    groups.append(sorted(set(processes)))
    return real(t, processes)


collectives.process_all_gather = watched
import harmony_tpu_torch.table.table as T
T.process_all_gather = watched
out.update(tables(slots))
out["groups"] = sorted({tuple(g) for g in groups})
# a RowExchange over the table's mesh: row r's tensors from its first process
t = DenseTable(TableSpec(TableConfig(table_id="x", capacity=8, value_shape=(1,), num_blocks=4)),
               build_mesh(slots, data=2, model=2))
sh = t.sharding
mine = {r: [torch.full((r + 2, 3), float(r), dtype=torch.float64),
            torch.arange(r + 1, dtype=torch.int32), None, torch.tensor(r % 2 == 0)]
        for r in sh.local_rows}
every = RowExchange(sh, torch.device("cpu"))(mine)
out["rows"] = sh.local_rows
out["exchange"] = [[None if x is None else [str(x.dtype), list(x.shape), hexes(x)] for x in r]
                   for r in every]
multihost.sync_global_devices()
multihost.shutdown_distributed()
print("RESULT " + json.dumps(out))
'''


def _result(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert lines, out[-2000:]
    return json.loads(lines[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    store = tmp_path_factory.mktemp("units") / "store"
    env = dict(os.environ, OMP_NUM_THREADS="1", HARMONY_POD_UNIT_TIMEOUT="60")
    procs = [subprocess.Popen([sys.executable, "-c", UNITS, f"file://{store}", str(p)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for p in range(4)]
    try:
        one = subprocess.run([sys.executable, "-c", UNITS], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=DEADLINE)
        assert one.returncode == 0, one.stderr[-3000:]
        deadline = time.monotonic() + DEADLINE
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, err[-3000:]
            outs.append(_result(out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs, _result(one.stdout)


def test_the_variable_length_all_gather_gives_every_part_exactly(units):
    outs, one = units
    for out in outs:
        assert out["parts"] == one["parts"]    # an empty part included
        assert out["v_calls"] == 2             # the counts, then the padded parts
        assert out["empty_shapes"] == [[0, 2]] * 4 and out["empty_calls"] == 1


def test_a_process_joins_only_its_own_rows_gathers(units):
    outs, one = units
    for pid, out in enumerate(outs):
        for key in ("pull", "all", "range"):
            assert out[key] == one[key], (pid, key)
        assert out["rows"] == [pid // 2]
        assert out["groups"] == ([[0, 1]] if pid < 2 else [[2, 3]]), out["groups"]


def test_a_row_exchange_carries_each_rows_tensors_unchanged(units):
    outs, _ = units
    want = [[["torch.float64", [r + 2, 3],
              np.full((r + 2, 3), float(r)).tobytes().hex()],
             ["torch.int32", [r + 1], np.arange(r + 1, dtype=np.int32).tobytes().hex()],
             None, ["torch.bool", [], np.asarray(r % 2 == 0).tobytes().hex()]]
            for r in range(2)]
    for out in outs:
        assert out["exchange"] == want


# -- jobs on a pod of two processes, a row each ------------------------------


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("poddata"))
    pod = Pod(tmp, devices="cpu,cpu", env={"HARMONY_POD_CHKP_ROOT": os.path.join(tmp, "chains")})
    pod.tmp_root = tmp
    pod.root = os.path.join(tmp, "chains")
    try:
        yield pod
        pod.finish()
    finally:
        pod.kill()


@pytest.mark.parametrize("app", ["nmf", "sparse-lda", "gbt", "wd"])
def test_a_data_axis_over_two_processes_is_the_one_process_bits(pod, app, tmp_path_factory):
    losses, tables = one_process_run(app, tmp_path_factory)
    keep = str(tmp_path_factory.mktemp(f"pod-{app}"))
    reps = pod.run(job(app, keep))[app]
    assert sorted(reps) == ["0", "1"]
    for pid, r in reps.items():
        assert r["ok"], r
        w = _worker(r)
        assert w["batch_losses"] == losses
        assert w["data_rows"] == [int(pid)] and w["restaged_batches"] == 0
        assert r["combine"]["calls"] > 0          # the rows' results crossed
    assert kept_tables(keep, app) == tables


def test_a_data_axis_chain_on_the_pod_is_the_one_process_chain(pod, tmp_path_factory):
    keep = str(tmp_path_factory.mktemp("chain-keep"))
    chained = job("wd", keep, job_id="wd-dx-chain", epochs=2, model_chkp_period=1)
    resumed = job("wd", keep, job_id="wd-dx-chain", epochs=4, model_chkp_period=1)
    resumed.user["resume_from_chain"] = True
    root = str(tmp_path_factory.mktemp("one-chain"))
    (one,) = one_process(root, job("wd", keep, job_id="wd-dx-chain", epochs=4,
                                   model_chkp_period=1))
    first = pod.run(chained)["wd-dx-chain"]
    cont = pod.run(resumed)["wd-dx-chain"]
    got = entries(pod.root, "wd-dx-chain")
    assert sorted(got) == [0, 1, 2, 3]
    assert_same_entries(got, entries(root, "wd-dx-chain"))
    (w_one,) = one["workers"].values()
    for p in ("0", "1"):
        assert first[p]["ok"] and cont[p]["ok"], (first[p], cont[p])
        assert _worker(first[p])["batch_losses"] + _worker(cont[p])["batch_losses"] == \
            w_one["batch_losses"]


def test_the_pod_is_near_the_references_two_process_pod_at_data_axis_2(pod, tmp_path_factory):
    from benchmarks.common import free_port, sanitized_cpu_env, wait_for_ready
    from harmony_tpu.jobserver.client import CommandSender as RefSender

    epochs = 3
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
        for app in REF_TRAINERS:
            assert sender.send_job_submit_command(ref_job(app, epochs)).get("ok")
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
    ref = _result(outs[0])
    keep = str(tmp_path_factory.mktemp("vs-ref"))
    mine = pod.run(*[job(app, keep, job_id=f"{app}-vs-ref", epochs=epochs)
                     for app in REF_TRAINERS])
    for app in REF_TRAINERS:
        (want,) = [w["losses"] for w in ref["local_results"][app].values()]
        for r in mine[f"{app}-vs-ref"].values():
            got = np.asarray(_worker(r)["losses"], np.float64)
            gap = np.abs(got - want) / np.maximum(1.0, np.abs(np.asarray(want)))
            assert len(got) == epochs and gap.max() <= LOSS_RTOL, (app, got, want)


# -- a row across processes ---------------------------------------------------


def test_a_row_across_two_processes_is_the_one_process_bits(tmp_path_factory):
    """Four processes of one CPU slot each: row 0 is processes 0 and 1, row 1
    processes 2 and 3; each row reads its model shards across its two
    processes, and both processes of a row compute it."""
    losses, tables = one_process_run("nmf", tmp_path_factory)
    tmp = str(tmp_path_factory.mktemp("across"))
    keep = str(tmp_path_factory.mktemp("across-keep"))
    pod = Pod(tmp, n=4)
    try:
        reps = pod.run(job("nmf", keep))["nmf"]
        pod.finish()
    finally:
        pod.kill()
    assert sorted(reps) == ["0", "1", "2", "3"]
    for pid, r in reps.items():
        assert r["ok"], r
        w = _worker(r)
        assert w["batch_losses"] == losses and w["data_rows"] == [int(pid) // 2]
    assert kept_tables(keep, "nmf") == tables
