"""Moves of a job at data axis 2 in one process, on the CPU: the yardstick
of the pod's moves (``tests/test_torch_pod_data_moves.py``).

Phase 3x (b)'s jobs (NMF, LDA, sparse LDA, GBT, Lasso) and Wide&Deep, at the
small sizes of ``tests/test_torch_dp_local.py``, on a table made with
``ETMaster.create_table(..., data_axis=2)`` over 4 virtual CPU slots, moved
at epoch boundaries by plans (``plan/``) through the worker's epoch
callback, as ``tests/test_torch_migration.py`` moves its data-1 tables:

* Plans that leave the data rows as they were (their count and their order)
  give the unmoved data-2 run's bits: every per-batch loss and every byte of
  the final model and local tables. ``within_a_row`` moves a block between
  the two slots of row 0 of (data 2, model 2) and back (the owners stay
  four); ``halve_the_rows`` drains each row's second slot into its first, so
  (2, 2) becomes (2, 1) over the same two rows, and grows them back.
* ``tests/test_torch_migration.py``'s plans (``grow``, ``shrink``,
  ``grow_then_shrink``) from two owners, (data 2, model 1), change the rows:
  three owners or one give data 1 (``_mesh_over``), and ``grow_then_shrink``
  comes back to data 2. Such a run gives the same bits twice, and Wide&Deep
  and Lasso come within ``ATOL`` = 1e-5 of the reference's ``JaxWorker`` with
  the same plan on its data-2 mesh (final model and every epoch's loss: the
  two frameworks add f32 sums in other orders).
* The jobs that keep a worker-local table (NMF, LDA, sparse LDA, GBT): the
  reference cannot move them (its jitted step takes the model table on the
  new mesh and the local table on the old one, and its worker gives up after
  ``MAX_RESHARD_RETRIES``: pinned here, ROADMAP C's known differences). The
  port's row-changing runs give the same bits twice, every batch loss within
  ``RTOL`` = 1e-5 x max(1, |loss|) of the unmoved data-2 run (the rows' sums
  add in another order on data 1), LDA's counts and assignments exactly
  (integer-valued), and the local table's replicas alike.
* A data-2 run's bits do not depend on the model axis: (data 2, model m)
  for m of 1 to 4 give the same losses and tables, which is why a move that
  keeps the rows keeps the bits, and why the pod's four-card layouts are
  held to the same yardstick as its one-card ones.
* A batch staged for rows this process no longer computes is re-staged from
  its host arrays; a reshard onto meshes whose blocks are replicated over
  data rows gives every slot of every row its blocks, byte for byte.
"""
import jax
import numpy as np
import pytest
import torch

from harmony_tpu import plan as jplan
from harmony_tpu.config.params import TrainerParams as JaxTrainerParams
from harmony_tpu.dolphin import TrainerContext as JaxTrainerContext
from harmony_tpu.dolphin import TrainingDataProvider as JaxProvider
from harmony_tpu.dolphin import WorkerTasklet as JaxWorker
from harmony_tpu.parallel import DevicePool as JaxDevicePool
from harmony_tpu.runtime import ETMaster as JaxETMaster
from harmony_tpu_torch import plan as tplan
from harmony_tpu_torch.config.base import resolve_symbol
from harmony_tpu_torch.config.params import TableConfig, TrainerParams
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.rows import RowBatch, stage_rows
from harmony_tpu_torch.dolphin.trainer import TrainerContext
from harmony_tpu_torch.dolphin.worker import WorkerTasklet
from harmony_tpu_torch.parallel.mesh import DevicePool, build_mesh
from harmony_tpu_torch.runtime.master import ETMaster
from harmony_tpu_torch.table.table import DenseTable, TableSpec
from test_torch_dp_local import APPS as DP_APPS
from test_torch_migration import PLANS as ROW_PLANS
from test_torch_migration import grow_then_shrink

ATOL = 1e-5
RTOL = 1e-5
EPOCHS, NB = 4, 4
CPU = torch.device("cpu")

APPS = dict(DP_APPS, wd=("widedeep:WideDeepTrainer", "widedeep:make_synthetic",
                         {"vocab_size": 512, "num_slots": 4, "emb_dim": 8, "hidden": 16,
                          "step_size": 0.5},
                         {"n": 512, "vocab_size": 512, "num_slots": 4}))
LOCAL = ("nmf", "lda", "sparse-lda", "gbt")      # the jobs with a worker-local table
NO_LOCAL = ("lasso", "wd")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _move(P, plan, handle, src, dst, n, after=()):
    return plan.add_op(P.MoveOp(handle.table_id, src, dst, n), depends_on=list(after))


def within_a_row(P, handle, exs, epoch):
    """Row 0 of (2, 2) is executors 0 and 1: one block from 1 to 0 at epoch
    1, and back at 2; the owners stay four."""
    if epoch not in (1, 2):
        return None
    plan = P.ETPlan()
    src, dst = (exs[1].id, exs[0].id) if epoch == 1 else (exs[0].id, exs[1].id)
    _move(P, plan, handle, src, dst, 1)
    return plan


def halve_the_rows(P, handle, exs, epoch):
    """(2, 2) over executors 0-3 (rows [0, 1] and [2, 3]): each row's second
    slot drained into its first at epoch 1, (2, 1) over executors 0 and 2;
    at epoch 2 each first slot gives its second back as many blocks."""
    if epoch not in (1, 2):
        return None
    plan = P.ETPlan()
    counts = handle.block_manager.block_counts()
    if epoch == 1:
        first = _move(P, plan, handle, exs[1].id, exs[0].id, counts[exs[1].id])
        _move(P, plan, handle, exs[3].id, exs[2].id, counts[exs[3].id], after=[first])
    else:
        half = counts[exs[0].id] // 2
        first = _move(P, plan, handle, exs[0].id, exs[1].id, half)
        _move(P, plan, handle, exs[2].id, exs[3].id, half, after=[first])
    return plan


KEEP_PLANS = {"within_a_row": within_a_row, "halve_the_rows": halve_the_rows}


def shrink_to_one(P, handle, exs, epoch):
    """``tests/test_torch_migration.py``'s ``shrink`` but for its
    ``DeallocateOp``: the drained executor still holds the job's local
    table, and an executor is closed only once no table is associated with
    it (ROADMAP C, "A refused remove_executor")."""
    if epoch != 2:
        return None
    victim = exs[1].id
    plan = P.ETPlan()
    mv = _move(P, plan, handle, victim, exs[0].id, handle.block_manager.block_counts()[victim])
    plan.add_op(P.UnassociateOp(handle.table_id, victim), depends_on=[mv])
    return plan


# the row-changing plans beside a local table
LOCAL_PLANS = {"grow": ROW_PLANS["grow"][0], "shrink": shrink_to_one,
               "grow_then_shrink": grow_then_shrink}


def build(pkg, app):
    trainer, data_fn, app_params, data_args = APPS[app]
    # the reference's lasso data function returns its ground truth too: both
    # read the port's copy of the same draws (tests/test_torch_dp_local.py)
    data_pkg = "harmony_tpu_torch" if app == "lasso" else pkg
    arrays = resolve_symbol(f"{data_pkg}.apps.{data_fn}")(**data_args)
    return (resolve_symbol(f"{pkg}.apps.{trainer}")(**app_params),
            [np.asarray(a) for a in arrays])


def _state(table):
    if table is None:
        return None
    if hasattr(table, "items"):
        return {int(k): np.asarray(v) for k, v in table.items().items()}
    return np.asarray(table.pull_array())


def port_run(app, make_plan=None, owners=2, slots=4):
    """``app`` at data_axis 2 on ``owners`` of ``slots`` virtual CPU slots'
    executors (2: (data 2, model 1); 4: (2, 2)), ``make_plan`` fired after
    each epoch. Returns (result, final model state, final local state, local
    table, the meshes after each epoch)."""
    trainer, arrays = build("harmony_tpu_torch", app)
    master = ETMaster(DevicePool.virtual("cpu", slots))
    exs = master.add_executors(owners)      # a grow allocates a free slot
    ids = [e.id for e in exs]
    table = master.create_table(trainer.model_table_config(), ids, data_axis=2)
    local = (master.create_table(trainer.local_table_config(), ids, data_axis=2)
             if trainer.uses_local_table else None)
    handle = master.table_handle(table.spec.table_id)
    errors, meshes = [], []

    def on_epoch(epoch):
        plan = make_plan(tplan, handle, exs, epoch) if make_plan else None
        if plan is not None:
            result = tplan.PlanExecutor(master).execute(plan)
            if not result.success:
                errors.append(result.error)
        meshes.append(dict(table.mesh.shape))

    ctx = TrainerContext(params=TrainerParams(num_epochs=EPOCHS, num_mini_batches=NB),
                         model_table=table, local_table=local)
    worker = WorkerTasklet("dpm", ctx, trainer, TrainingDataProvider(arrays, NB),
                           epoch_callback=on_epoch)
    result = worker.run()
    assert not errors, errors
    return result, _state(table), _state(local), local, meshes


def jax_run(app, make_plan):
    """The reference's ``JaxWorker`` on its data-2 mesh over 2 of 4 virtual
    devices' executors, ``make_plan`` after each epoch: (result, final
    model)."""
    trainer, arrays = build("harmony_tpu", app)
    master = JaxETMaster(JaxDevicePool(jax.devices()[:4]))
    exs = master.add_executors(2)
    ids = [e.id for e in exs]
    handle = master.create_table(trainer.model_table_config(), ids, data_axis=2)
    local = (master.create_table(trainer.local_table_config(), ids, data_axis=2).table
             if getattr(trainer, "uses_local_table", False) else None)
    errors = []

    def on_epoch(epoch):
        plan = make_plan(jplan, handle, exs, epoch)
        if plan is not None:
            result = jplan.PlanExecutor(master).execute(plan)
            if not result.success:
                errors.append(result.error)

    worker = JaxWorker("dpm", JaxTrainerContext(
        params=JaxTrainerParams(num_epochs=EPOCHS, num_mini_batches=NB),
        model_table=handle.table, local_table=local), trainer, JaxProvider(arrays, NB),
        handle.table.mesh, epoch_callback=on_epoch)
    result = worker.run()
    assert not errors, errors
    return result, _state(handle.table)


_UNMOVED = {}


def unmoved(app, owners):
    if (app, owners) not in _UNMOVED:
        _UNMOVED[app, owners] = port_run(app, owners=owners)
    return _UNMOVED[app, owners]


def same_bits(got, want):
    if want is None:
        return got is None
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            got[k].tobytes() == want[k].tobytes() for k in want)
    return got.tobytes() == want.tobytes()


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    gap = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert gap.max() <= RTOL, (gap.max(), got, want)


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("plan", sorted(KEEP_PLANS))
def test_a_plan_that_keeps_the_rows_gives_the_unmoved_data_2_bits(app, plan):
    res, model, local, _, meshes = port_run(app, KEEP_PLANS[plan], owners=4)
    base, base_model, base_local, _, _ = unmoved(app, 4)
    want = {"within_a_row": {"data": 2, "model": 2},
            "halve_the_rows": {"data": 2, "model": 1}}[plan]
    assert meshes[1] == want and meshes[-1] == {"data": 2, "model": 2}
    assert res["step_mode"] == "data_parallel" and res["data_rows"] == [0, 1]
    assert res["batch_losses"] == base["batch_losses"]
    assert same_bits(model, base_model) and same_bits(local, base_local)


@pytest.mark.parametrize("app", NO_LOCAL)
@pytest.mark.parametrize("plan", sorted(ROW_PLANS))
def test_a_plan_that_changes_the_rows_is_near_the_references_worker(app, plan):
    make_plan = ROW_PLANS[plan][0]
    res, model, _, _, meshes = port_run(app, make_plan)
    again, model2, _, _, _ = port_run(app, make_plan)
    assert any(m["data"] == 1 for m in meshes) and meshes[0] == {"data": 2, "model": 1}
    assert res["batch_losses"] == again["batch_losses"] and same_bits(model, model2)
    ref, ref_model = jax_run(app, make_plan)
    np.testing.assert_allclose(model, ref_model, atol=ATOL, rtol=0)
    np.testing.assert_allclose(res["losses"], ref["losses"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("app", LOCAL)
@pytest.mark.parametrize("plan", sorted(LOCAL_PLANS))
def test_a_plan_that_changes_the_rows_beside_a_local_table(app, plan):
    make_plan = LOCAL_PLANS[plan]
    res, model, local, ltable, meshes = port_run(app, make_plan)
    again, model2, local2, _, _ = port_run(app, make_plan)
    assert res["batch_losses"] == again["batch_losses"]
    assert same_bits(model, model2) and same_bits(local, local2)
    base, base_model, base_local, _, _ = unmoved(app, 2)
    if all(m["data"] == 2 for m in meshes):
        # GBT's two blocks: the grow drains executor 0 (it owned one), and
        # the rows move to other slots, as many and in the same order
        assert (app, plan) == ("gbt", "grow")
        assert res["batch_losses"] == base["batch_losses"]
        assert same_bits(model, base_model) and same_bits(local, base_local)
    close(res["batch_losses"], base["batch_losses"])
    if app == "lda":
        assert same_bits(model, base_model) and same_bits(local, base_local)
    # the local table stays on its data-2 mesh: its replicas alike
    sh = ltable.sharding
    shards = ltable.array.shards
    for slot, t in shards.items():
        twins = [u for s, u in shards.items() if sh.shard_of(s) == sh.shard_of(slot)]
        assert all(torch.equal(t, u) for u in twins)


@pytest.mark.parametrize("app", sorted(APPS))
def test_the_data_2_bits_do_not_depend_on_the_model_axis(app):
    base, model, local, _, _ = unmoved(app, 4)
    for owners in (2, 6, 8):
        res, m, loc, _, meshes = port_run(app, owners=owners, slots=8)
        assert meshes[0] == {"data": 2, "model": owners // 2}
        assert res["batch_losses"] == base["batch_losses"]
        assert same_bits(m, model) and same_bits(loc, local)


def test_the_reference_cannot_move_a_job_that_keeps_a_local_table():
    """The reference's NMF on its data-2 mesh, grown onto a third executor
    at epoch 1: its step meets the model table on three devices and the
    local table on two, and the worker gives up (ROADMAP C's known
    differences). The port's run of the same plan finishes."""
    with pytest.raises(RuntimeError, match="resharded .* during one epoch dispatch"):
        jax_run("nmf", ROW_PLANS["grow"][0])
    res, *_ = port_run("nmf", ROW_PLANS["grow"][0])
    assert res["epochs_run"] == EPOCHS


def test_a_batch_staged_for_rows_this_process_no_longer_computes_is_restaged_from_its_host_arrays():
    rng = np.random.default_rng(2)
    host = (rng.integers(0, 9, (12, 2)).astype(np.int32),
            rng.standard_normal((12, 3)).astype(np.float32))
    # staged for row 1 only (row 0 computed by another process), knowing its host arrays
    mine = stage_rows(host, [None, CPU], host=lambda: host)
    assert mine.parts[0] is None
    # the layout moved: this process now computes both rows, then one
    both = mine.restage([CPU, CPU])
    assert both.devices == (CPU, CPU)
    for r, (lo, hi) in enumerate(((0, 6), (6, 12))):
        for got, want in zip(both.parts[r], host):
            assert np.array_equal(got.numpy(), want[lo:hi])
    assert both.parts[1][0] is mine.parts[1][0]   # the staged part is kept
    for got, want in zip(mine.joined(CPU), host):
        assert np.array_equal(got.numpy(), want)
    three = mine.restage([None, CPU, CPU])
    assert three.parts[0] is None
    assert np.array_equal(three.parts[2][1].numpy(), host[1][8:])
    # with no host arrays, a missing row's part cannot be made
    with pytest.raises(ValueError, match="no host arrays"):
        RowBatch(mine.parts, 12).restage([CPU, CPU])


@pytest.mark.parametrize("layouts", [
    [(2, [0, 1, 2, 3]), (1, [0, 1, 2]), (2, [0, 1, 2, 3])],
    [(2, [0, 1, 2, 3]), (2, [0, 2]), (2, [2, 0, 3, 1]), (1, [3])],
], ids=["rows-fall-to-one-and-back", "rows-halved-then-swapped"])
def test_a_reshard_gives_every_slot_of_every_data_row_its_blocks(layouts):
    """A table replicated over data rows, resharded through meshes whose
    rows and blocks differ: after each reshard every slot of every row holds
    exactly its blocks of the table, byte for byte."""
    slots = DevicePool.virtual(CPU, 4).slots
    spec = TableSpec(TableConfig(table_id="rows", capacity=48, value_shape=(3,),
                                 num_blocks=12, update_fn="add"))
    data, order = layouts[0]
    table = DenseTable(spec, build_mesh([slots[i] for i in order], data=data))
    table.write_all(torch.arange(144, dtype=torch.float32).reshape(48, 3) * 0.5 - 7.0)
    blocks = {b: np.ascontiguousarray(a) for b, a in table.export_blocks().items()}
    for data, order in layouts[1:]:
        table.reshard(build_mesh([slots[i] for i in order], data=data))
        sh = table.sharding
        arr = table.array
        shards = arr.shards if hasattr(arr, "shards") else {sh.mesh.slots[0]: arr}
        assert sh.data_rows == data and len(shards) == len(order)
        for slot, t in shards.items():
            want = np.stack([blocks[b] for b in sh.slot_blocks(slot)])
            assert t.numpy().tobytes() == want.tobytes(), (slot, list(sh.slot_blocks(slot)))
