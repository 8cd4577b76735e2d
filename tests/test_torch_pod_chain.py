"""Checkpoint chains on the port's pod (``CheckpointManager._pod_checkpoint``,
``restore`` and ``restore_partial`` over processes, the collective deferred
evaluation), on the CPU.

Pods of two ``cli start-pod --device cpu,cpu`` processes (two CPU slots a
process: executor-0 and -1 on process 0, -2 and -3 on process 1) over one
gloo world on a ``FileStore``, their chains under one shared
``HARMONY_POD_CHKP_ROOT``. The one-process runs are the port's on a virtual
mesh of four CPU slots, whose chain entries the pod's must equal byte for
byte.

* ``addressable_blocks``: over two processes (a spanning table built as each
  process sees it) the union of the owned blocks is every block exactly
  once, each the one-process table's bytes; dense sharded, dense replicated
  (every slot holds every block: process 0 owns them all) and hash tables.
* Chains of MLR, Wide&Deep and FM (a hash table): every entry's ``.blk``
  files and ``block_checksums`` are the one-process entry's of the same
  epoch, the ids end in ``-pod``, and the blocks the two processes staged
  (``model_chkp_stats``) are every block once, as ``block_owners`` gives
  them. A two-worker SSP chain is the one-process ``force_lockstep`` chain
  (the reference's
  ``tests/test_multihost.py::test_pod_multiworker_chkp_chain_matches_lockstep``).
* Resume: two epochs, then a resubmission with ``resume_from_chain`` to
  four, give the uninterrupted run's batch losses and its last entry's bytes.
  A reference one-process chain resumed on the pod continues as the port's
  one process continues it, and a pod entry restores in the reference's
  ``CheckpointManager`` (the JAX CPU backend) to the port's table exactly.
* ``restore_partial`` against the reference's: the three cases of
  ``tests/test_elastic.py`` (no cache, the whole cache, half of it) and the
  sparse fallback give equal stats and exact tables.
* The collective deferred evaluation, 1 and 2 workers: one metric dict an
  entry, within ``EVAL_ATOL`` = 1e-5 of the reference's ``ModelEvaluator``
  over the same files (f32 sums in another order, as
  ``tests/test_torch_chain.py`` allows); a follower that fails before its
  READY aborts that evaluation alone, and the pod is not broken. (A job
  wholly on a follower, evaluated there and sent back in EVAL_DONE:
  ``tests/test_torch_pod.py``.)
* The refusals kept, each naming its reason: sampling and
  ``checkpoint_async`` on a table over processes, a pod chain without a
  ``chkp_root`` and ``offline_model_eval`` on a multi-process grant without
  process 0, each before the job makes a table. The ``data-axis`` case is
  named for the refusal it replaced and checks that it is gone: a chained
  job at ``data_axis`` 2 over two processes makes its tables, a data row in
  each process (its chains: ``tests/test_torch_pod_data.py``).
* Against the reference's own two-process pod (two virtual devices a
  process, ``tests/pod_worker.py``): the same MLR chain has the same ids,
  block ids and ownership, its blocks within ``EVAL_ATOL``.

Every wait has a deadline and every child process is killed in a
``finally``; each pod starts once a module.
"""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from harmony_tpu_torch.checkpoint import manager as chkp
from harmony_tpu_torch.checkpoint.manager import CheckpointManager
from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.parallel import mesh as _mesh
from harmony_tpu_torch.parallel.mesh import DevicePool, Slot, build_mesh
from harmony_tpu_torch.runtime.master import ETMaster, TableHandle
from harmony_tpu_torch.table.blockmove import block_owners
from harmony_tpu_torch.table.hashtable import DeviceHashTable, HashTableSpec
from harmony_tpu_torch.table.table import DenseTable, TableSpec
from test_torch_pod import APPS, DEADLINE, Pod, job

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def chained(app, job_id, epochs=2, period=1, **kw):
    return job(app, job_id=job_id, epochs=epochs, model_chkp_period=period, **kw)


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("podchain"))
    pod = Pod(tmp, devices="cpu,cpu", env={"HARMONY_POD_CHKP_ROOT": os.path.join(tmp, "chains")})
    pod.root = os.path.join(tmp, "chains")
    try:
        yield pod
        pod.finish()
    finally:
        pod.kill()


def one_process(root, *configs, slots=4):
    """The configs on one process over a virtual mesh of ``slots`` CPU slots,
    chaining under ``root``: their results."""
    server = JobServer(slots, device_pool=DevicePool.virtual("cpu", slots), chkp_root=root)
    server.start()
    try:
        return [server.submit(c).result(timeout=DEADLINE) for c in configs]
    finally:
        server.shutdown(timeout=DEADLINE)


def entries(root, job_id):
    """epoch -> (chkp id, {block file: bytes}, manifest) of a job's chain."""
    commit = os.path.join(root, job_id, "commit")
    out = {}
    for cid in sorted(os.listdir(commit)):
        d = os.path.join(commit, cid)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        blocks = {}
        for name in os.listdir(d):
            if name != "manifest.json":
                with open(os.path.join(d, name), "rb") as f:
                    blocks[name] = f.read()
        out[int(manifest["app_meta"]["epoch"])] = (cid, blocks, manifest)
    return out


def assert_same_entries(got, want):
    assert sorted(got) == sorted(want)
    for epoch in want:
        cid, blocks, manifest = got[epoch]
        assert cid.endswith("-pod"), cid
        assert blocks == want[epoch][1], epoch
        assert manifest["block_checksums"] == want[epoch][2]["block_checksums"]
        assert manifest["block_ids"] == list(range(len(blocks)))


def batch_losses(report):
    return {w[-2:]: v["batch_losses"] for w, v in report["workers"].items()}


# -- addressable_blocks --------------------------------------------------------


def _as_process(monkeypatch, pid):
    """This process seen as process ``pid`` of a pod."""
    monkeypatch.setattr(_mesh, "_THIS_PROCESS", [pid])


@pytest.mark.parametrize("kind", ["dense", "dense-replicated", "hash"])
def test_addressable_blocks_cover_every_block_once_over_two_processes(monkeypatch, kind):
    """Each process's view of one table over four slots, two a process,
    holding the one-process table's blocks: the owned blocks of the two
    views are every block once, with its bytes, as ``block_owners`` says."""
    cpu = torch.device("cpu")
    nb = 6 if kind == "dense-replicated" else 8
    cfg = TableConfig(table_id=kind, capacity=64, value_shape=(3,), num_blocks=nb,
                      sparse=kind == "hash")
    if kind == "hash":
        whole = DeviceHashTable(HashTableSpec(cfg), cpu)
        keys = np.arange(1, 60, 3)
        whole.multi_update(keys, np.random.default_rng(0).normal(size=(len(keys), 3)))
    else:
        whole = DenseTable(TableSpec(cfg), cpu)
        whole.multi_put(np.arange(64), np.random.default_rng(0).normal(size=(64, 3)))
    blocks = whole.export_blocks()
    slots = [Slot(i, cpu, i // 2) for i in range(4)]
    mesh = build_mesh(slots, data=1)
    union = {}
    for pid in (0, 1):
        _as_process(monkeypatch, pid)
        table = (DeviceHashTable(HashTableSpec(cfg), mesh) if kind == "hash"
                 else DenseTable(TableSpec(cfg), mesh))
        table.import_blocks(blocks)
        mine = table.addressable_blocks()
        assert not set(mine) & set(union)
        owners = block_owners(table.sharding, (nb,))
        assert sorted(mine) == sorted(b for b, p in owners.items() if p == pid)
        union.update(mine)
    assert sorted(union) == list(range(nb))
    if kind == "dense-replicated":
        assert set(block_owners(table.sharding, (nb,)).values()) == {0}
    for b, got in union.items():
        want = blocks[b]
        for g, w in zip(got if kind == "hash" else (got,), want if kind == "hash" else (want,)):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


# -- chains --------------------------------------------------------------------


@pytest.mark.parametrize("app", ["mlr", "wd", "fm"])
def test_a_pod_chain_is_the_one_process_chain_byte_for_byte(pod, tmp_path, app):
    job_id = f"{app}-chain"
    reps = pod.run(chained(app, job_id))[job_id]
    assert all(r["ok"] for r in reps.values()), reps
    one = str(tmp_path / "one")
    (res,) = one_process(one, chained(app, job_id))
    got = entries(pod.root, job_id)
    assert_same_entries(got, entries(one, job_id))
    # the two processes staged every block once, each its owned ones: the
    # first half of the blocks lies on process 0's two slots
    nb = len(got[0][1])
    for i, cid in enumerate(reps["0"]["model_chkp_ids"]):
        staged = {p: r["model_chkp_stats"][i] for p, r in reps.items()}
        assert all(s["chkp_id"] == cid for s in staged.values())
        ids = [b for s in staged.values() for b in s["block_ids"]]
        assert sorted(ids) == list(range(nb))
        assert staged["0"]["block_ids"] == list(range(nb // 2))
        assert all(s["bytes"] > 0 and s["blocks"] == nb // 2 for s in staged.values())
    for r in reps.values():
        assert batch_losses(r) == {w[-2:]: v["batch_losses"] for w, v in res["workers"].items()}


def test_a_two_worker_ssp_pod_chain_is_the_one_process_lockstep_chain(pod, tmp_path):
    config = chained("mlr", "mlr-2w", epochs=4, period=2, workers=2, clock_slack=1)
    reps = pod.run(config)["mlr-2w"]
    assert all(r["ok"] for r in reps.values()), reps
    assert len(reps["0"]["model_chkp_ids"]) == 2
    one = str(tmp_path / "one")
    one_process(one, chained("mlr", "mlr-2w", epochs=4, period=2, workers=2, clock_slack=1,
                             lockstep=True))
    assert_same_entries(entries(pod.root, "mlr-2w"), entries(one, "mlr-2w"))


def test_a_resume_on_the_pod_gives_the_uninterrupted_bits(pod):
    whole = pod.run(chained("wd", "wd-whole", epochs=4))["wd-whole"]
    first = pod.run(chained("wd", "wd-res", epochs=2))["wd-res"]
    again = chained("wd", "wd-res", epochs=4)
    again.user["resume_from_chain"] = True
    resumed = pod.run(again)["wd-res"]
    res = pod.sender.wait_result("wd-res", timeout=DEADLINE)
    (w,) = res["workers"].values()
    assert w["starting_epoch"] == 2 and w["epochs_run"] == 2
    for p in ("0", "1"):
        assert resumed[p]["ok"], resumed[p]
        assert (batch_losses(first[p])["w0"] + batch_losses(resumed[p])["w0"]
                == batch_losses(whole[p])["w0"])
    # the resumed chain continues past the first run's entries
    assert [c.rsplit("-", 2)[1:] for c in resumed["0"]["model_chkp_ids"]] == [
        ["3", "pod"], ["4", "pod"]]
    got, want = entries(pod.root, "wd-res"), entries(pod.root, "wd-whole")
    assert got[3][1] == want[3][1] and got[3][2]["block_checksums"] == want[3][2][
        "block_checksums"]


def test_entries_cross_the_packages_and_the_topologies(pod, tmp_path):
    """A reference one-process chain resumed on the pod continues exactly as
    the port's one process continues it; a pod entry restores in the
    reference's CheckpointManager to the port's one-process restore."""
    import jax

    from harmony_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
    from harmony_tpu.jobserver import JobServer as JaxJobServer
    from harmony_tpu.parallel import DevicePool as JaxDevicePool
    from harmony_tpu.runtime import ETMaster as JaxETMaster

    ref_root = str(tmp_path / "ref")
    server = JaxJobServer(1, device_pool=JaxDevicePool(jax.devices()[:1]), chkp_root=ref_root)
    server.start()
    try:
        server.submit(chained("mlr", "mlr-from-ref", pkg="harmony_tpu")).result(timeout=DEADLINE)
    finally:
        server.shutdown(timeout=DEADLINE)
    one = str(tmp_path / "one")
    for root in (pod.root, one):
        shutil.copytree(os.path.join(ref_root, "mlr-from-ref"),
                        os.path.join(root, "mlr-from-ref"))
    cont = chained("mlr", "mlr-from-ref", epochs=3)
    cont.user["resume_from_chain"] = True
    reps = pod.run(cont)["mlr-from-ref"]
    (res,) = one_process(one, cont)
    got, want = entries(pod.root, "mlr-from-ref"), entries(one, "mlr-from-ref")
    assert got[2][1] == want[2][1]
    for r in reps.values():
        assert batch_losses(r) == {w[-2:]: v["batch_losses"] for w, v in res["workers"].items()}

    # the pod entry of epoch 2 in the reference's manager and in the port's
    cid = got[2][0]
    jmgr = JaxCheckpointManager(os.path.join(pod.root, "mlr-from-ref", "temp"),
                                os.path.join(pod.root, "mlr-from-ref", "commit"))
    jmaster = JaxETMaster(JaxDevicePool(jax.devices()[:2]))
    theirs = jmgr.restore(jmaster, cid, [e.id for e in jmaster.add_executors(2)])
    master = ETMaster(DevicePool.virtual("cpu", 2))
    ours = CheckpointManager.for_job(pod.root, "mlr-from-ref").restore(
        master, cid, [e.id for e in master.add_executors(2)])
    assert np.array_equal(np.asarray(theirs.table.pull_array()),
                          ours.table.pull_array().numpy())


# -- restore_partial -----------------------------------------------------------


def _partial_case(case, mgr, master, make_table, recovery_put, recovery_blocks, tid):
    """One of the reference's partial-restore cases on either package's
    manager and master: (stats, the restored table's values)."""
    exs = master.add_executors(4)
    sparse = case == "sparse"
    cfg = make_table(tid, sparse)
    h = master.create_table(cfg, [e.id for e in exs])
    if not hasattr(h, "table"):   # the port's master gives the table, the reference's a handle
        h = TableHandle(master, h, [e.id for e in exs])
    keys = list(range(1, 65)) if sparse else list(range(64))
    vals = np.arange(64, dtype=np.float32)[:, None] * np.ones((2,), np.float32)
    h.table.multi_update(keys, vals)
    mgr.recovery_retain = case == "warm"
    cid = mgr.checkpoint(h, commit=True)
    if case == "half":
        mine = {b: np.asarray(h.table.export_blocks([b])[b]) for b in range(8)}
        recovery_put(tid, cid, mine)
    if case == "warm":
        assert recovery_blocks(cid) is not None
    h2, stats = mgr.restore_partial(master, cid, master.executor_ids()[:2],
                                    table_id=tid + "-2")
    if sparse:
        values = {int(k): np.asarray(v) for k, v in h2.table.items().items()}
    else:
        values = np.asarray(h2.table.pull_array())
    return stats, values


@pytest.mark.parametrize("case", ["cold", "warm", "half", "sparse"])
def test_restore_partial_is_the_references(tmp_path, case):
    import jax

    from harmony_tpu.checkpoint import manager as jchkp
    from harmony_tpu.config.params import TableConfig as JaxTableConfig
    from harmony_tpu.parallel import DevicePool as JaxDevicePool
    from harmony_tpu.runtime import ETMaster as JaxETMaster

    def cfg_of(cls):
        return lambda tid, sparse: cls(table_id=tid, capacity=64, value_shape=(2,),
                                       num_blocks=16, sparse=sparse)

    tid = f"pr-{case}"
    chkp.drop_recovery_cache()
    jchkp.drop_recovery_cache()
    try:
        ours = _partial_case(
            case, CheckpointManager(str(tmp_path / "t"), str(tmp_path / "c")),
            ETMaster(DevicePool.virtual("cpu", 8)), cfg_of(TableConfig),
            chkp._recovery_put, chkp.recovery_blocks, tid)
        theirs = _partial_case(
            case, jchkp.CheckpointManager(str(tmp_path / "jt"), str(tmp_path / "jc")),
            JaxETMaster(JaxDevicePool(jax.devices()[:8])), cfg_of(JaxTableConfig),
            jchkp._recovery_put, jchkp.recovery_blocks, tid)
    finally:
        chkp.drop_recovery_cache()
        jchkp.drop_recovery_cache()
    assert ours[0] == theirs[0]
    want = {"cold": (16, 0), "warm": (0, 16), "half": (8, 8), "sparse": (16, 0)}[case]
    assert (ours[0]["blocks_read"], ours[0]["blocks_local"]) == want
    if case == "sparse":
        assert ours[0]["partial"] == 0
        assert ours[1].keys() == theirs[1].keys()
        for k in ours[1]:
            assert np.array_equal(ours[1][k], theirs[1][k])
    else:
        assert np.array_equal(ours[1], theirs[1])


# -- the collective deferred evaluation ---------------------------------------


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """A pod that runs Wide&Deep chains with ``offline_model_eval`` for 1 and
    2 workers, and an MLR one whose follower cannot read its test data, then
    shuts down: (results, eval_results, broken, the chains' copies)."""
    tmp = str(tmp_path_factory.mktemp("podeval"))
    root = os.path.join(tmp, "chains")
    pod = Pod(tmp, devices="cpu,cpu", env={"HARMONY_POD_CHKP_ROOT": root})
    try:
        configs = [chained("wd", "wd-eval-1w", offline_model_eval=True),
                   chained("wd", "wd-eval-2w", workers=2, offline_model_eval=True),
                   chained("mlr", "mlr-eval-abort", offline_model_eval=True)]
        configs[-1].user.update(test_data_fn="tests.torch_pod_trainers:leader_only_test_data",
                                test_data_args=dict(APPS["mlr"][3]))
        reps = pod.run(*configs)
        copies = {}
        for c in configs:
            copies[c.job_id] = os.path.join(tmp, "copies", c.job_id)
            shutil.copytree(os.path.join(root, c.job_id), copies[c.job_id])
        closed = pod.finish()
        yield reps, closed["eval_results"], closed["broken"], copies
    finally:
        pod.kill()


@pytest.mark.parametrize("workers", [1, 2])
def test_the_collective_evaluation_is_the_references_evaluator(evaluated, workers):
    import jax

    from harmony_tpu.apps.widedeep import WideDeepTrainer as JaxWideDeepTrainer
    from harmony_tpu.apps.widedeep import make_synthetic as jax_wd_data
    from harmony_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
    from harmony_tpu.dolphin.evaluator import ModelEvaluator as JaxModelEvaluator
    from harmony_tpu.parallel import DevicePool as JaxDevicePool
    from harmony_tpu.runtime import ETMaster as JaxETMaster

    reps, evals, broken, copies = evaluated
    job_id = f"wd-eval-{workers}w"
    ids = reps[job_id]["0"]["model_chkp_ids"]
    assert len(ids) == 2 and all(r["ok"] for r in reps[job_id].values())
    ours = evals[job_id]
    assert isinstance(ours, list) and len(ours) == 2, ours
    copy = copies[job_id]
    jmgr = JaxCheckpointManager(os.path.join(copy, "temp"), os.path.join(copy, "commit"))
    jmaster = JaxETMaster(JaxDevicePool(jax.devices()[:1]))
    _, _, app_params, data_args = APPS["wd"]
    theirs = JaxModelEvaluator(jmaster, jmgr).evaluate_checkpoints(
        ids, JaxWideDeepTrainer(**app_params), jax_wd_data(**data_args),
        [e.id for e in jmaster.add_executors(1)])
    for o, t in zip(ours, theirs):
        assert o.keys() == t.keys()
        for k in o:
            assert abs(o[k] - t[k]) <= EVAL_ATOL, (k, o, t)
    assert broken is None


def test_a_follower_that_fails_before_ready_aborts_only_its_evaluation(evaluated):
    reps, evals, broken, _ = evaluated
    assert all(r["ok"] for r in reps["mlr-eval-abort"].values())
    err = evals["mlr-eval-abort"]["error"]
    assert "collective eval aborted" in err and "test data" in err, err
    assert broken is None
    # the evaluations beside it ran
    assert all(isinstance(evals[j], list) for j in ("wd-eval-1w", "wd-eval-2w"))


# -- the refusals kept ---------------------------------------------------------


def _spanning_master():
    cpu = torch.device("cpu")
    master = ETMaster(DevicePool([Slot(0, cpu, 0), Slot(1, cpu, 1)]))
    return master, [e.id for e in master.add_executors(2)]


@pytest.mark.parametrize("what, match", [
    ("sampling", "sampling is single-process only"),
    ("async", "checkpoint_async is single-process only"),
    ("no-root", "needs a SHARED chkp_root"),
    ("eval-without-0", "needs the grant to include the pod leader"),
    ("data-axis", "a data axis whose rows lie in different processes waits for ROADMAP A item 3b"),
])
def test_the_kept_refusals_name_their_reasons(tmp_path, what, match):
    if what in ("sampling", "async"):
        master, ids = _spanning_master()
        cfg = TableConfig(table_id="spanning", capacity=64, value_shape=(2,), num_blocks=8)
        handle = TableHandle(master, master.create_table(cfg, ids), ids)
        mgr = CheckpointManager(str(tmp_path / "t"), str(tmp_path / "c"))
        with pytest.raises(ValueError, match=match):
            if what == "sampling":
                mgr.checkpoint(handle, sampling_ratio=0.5)
            else:
                mgr.checkpoint_async(handle)
        return
    cpu = torch.device("cpu")
    slots = ([Slot(0, cpu, 0), Slot(1, cpu, 1), Slot(2, cpu, 2)] if what == "eval-without-0"
             else [Slot(0, cpu, 0), Slot(1, cpu, 1)])
    master = ETMaster(DevicePool(slots))
    ids = [e.id for e in master.add_executors(len(slots))]
    config = chained("mlr", f"refused-{what}", offline_model_eval=what == "eval-without-0")
    entity = DolphinJobEntity(config, chkp_root=None if what == "no-root" else str(tmp_path))
    if what == "data-axis":
        config.user["data_axis"] = 2
        entity.setup(master, ids)
        try:
            sh = entity._table.sharding
            assert master.table_ids() and sh.data_rows == 2
            assert sh.rows_apart and sh.local_rows == [0] and sh.row_processes(1) == (1,)
        finally:
            entity.cleanup()
        return
    with pytest.raises(ValueError, match=match):
        entity.setup(master, ids[1:] if what == "eval-without-0" else ids)
    assert master.table_ids() == []   # refused before any table


# -- against the reference's own pod -----------------------------------------


def test_the_chain_is_the_references_two_process_pods(pod, tmp_path):
    from benchmarks.common import free_port, sanitized_cpu_env, wait_for_ready
    from harmony_tpu.jobserver.client import CommandSender as RefSender

    ref_root = str(tmp_path / "ref")
    coord, pod_port, tcp_port = free_port(), free_port(), free_port()
    worker = os.path.join(REPO, "tests", "pod_worker.py")
    env = dict(sanitized_cpu_env(2), OMP_NUM_THREADS="1", HARMONY_POD_CHKP_ROOT=ref_root)
    procs = [subprocess.Popen([sys.executable, worker, f"127.0.0.1:{coord}", "2", str(p),
                               str(pod_port), str(tcp_port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env)
             for p in range(2)]
    try:
        assert wait_for_ready(procs[0], DEADLINE), "the reference's pod never became ready"
        sender = RefSender(tcp_port)
        assert sender.send_job_submit_command(
            chained("mlr", "mlr-vs-ref", pkg="harmony_tpu")).get("ok")
        deadline = time.monotonic() + DEADLINE
        while sender.send_status_command().get("running"):
            assert time.monotonic() < deadline, "the reference's pod never drained"
            time.sleep(0.3)
        sender.send_shutdown_command()
        for p in procs:
            _, err = p.communicate(timeout=DEADLINE)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    pod.run(chained("mlr", "mlr-vs-ref"))
    got, want = entries(pod.root, "mlr-vs-ref"), entries(ref_root, "mlr-vs-ref")
    assert sorted(got) == sorted(want) == [0, 1]
    mgr = CheckpointManager.for_job(pod.root, "mlr-vs-ref")
    for epoch in want:
        assert got[epoch][0] == want[epoch][0]
        for key in ("block_ids", "ownership", "executors"):
            assert got[epoch][2][key] == want[epoch][2][key], key
        d = os.path.join(ref_root, "mlr-vs-ref", "commit", want[epoch][0])
        for b in want[epoch][2]["block_ids"]:
            theirs = chkp._read_block(d, b)
            ours = chkp._read_block(mgr._dir_of(got[epoch][0]), b)
            np.testing.assert_allclose(ours, theirs, rtol=0, atol=EVAL_ATOL)
