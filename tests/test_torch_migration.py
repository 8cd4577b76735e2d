"""Live migration of a job's model table while it trains, on the CPU.

The port's ``ETMaster`` over 4 virtual CPU slots against the reference's over
4 of the 8 virtual CPU devices ``tests/conftest.py`` sets up, the analogue of
the reference's ``tests/test_migration.py``: a worker trains on a table owned
by 2 executors while plans (``plan/``: Allocate, Associate, Move,
Unassociate, Deallocate) grow the table onto a third executor, drain one, or
both, at epoch boundaries, between per-batch units, inside a fused window,
and while a reader reads the table. Tables: AddVector's (16 blocks, exact
sums), Wide&Deep's dense embedding table cut to 16 blocks (2 and 4 owners
shard it, 3 replicate it: 16 is not a multiple of 3) and FM's hash table (16
blocks).

Tolerances:

* The port's moved run against its unmoved run (the table on its first 2
  executors throughout): the bits of every per-batch loss and of the final
  table. At a data axis of 1 every layout folds each key in its original
  order and gathers the same rows.
* The port against the reference's run with the same plans: the final table
  within 1e-5 absolutely (f32 sums in another order in the two frameworks,
  as tests/test_torch_widedeep.py allows); AddVector's sums exactly. The
  hash table: the same keys present, their values within 1e-5.
* The owning executors at the end: the reference's count.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from harmony_tpu import plan as jplan
from harmony_tpu.apps import addvector as jaddvector
from harmony_tpu.apps import widedeep as jwidedeep
from harmony_tpu.config.params import TrainerParams as JaxTrainerParams
from harmony_tpu.dolphin import TrainerContext as JaxTrainerContext
from harmony_tpu.dolphin import TrainingDataProvider as JaxProvider
from harmony_tpu.dolphin import WorkerTasklet as JaxWorker
from harmony_tpu.parallel import DevicePool as JaxDevicePool
from harmony_tpu.runtime import ETMaster as JaxETMaster
from harmony_tpu_torch import plan as tplan
from harmony_tpu_torch.apps import addvector as taddvector
from harmony_tpu_torch.apps import widedeep as twidedeep
from harmony_tpu_torch.config.params import TrainerParams
from harmony_tpu_torch.dolphin.data import TrainingDataProvider
from harmony_tpu_torch.dolphin.trainer import TrainerContext
from harmony_tpu_torch.dolphin.worker import WorkerTasklet
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.runtime.master import ETMaster
from harmony_tpu_torch.table import blockmove

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
EPOCHS, NB = 6, 4


def addvector(mod):
    return mod.AddVectorTrainer(num_keys=16, vector_dim=2, delta=1.0), list(mod.make_marks(128))


def widedeep(mod):
    tr = mod.WideDeepTrainer(vocab_size=64, num_slots=4, emb_dim=4, hidden=8, step_size=0.5)
    return tr, list(mod.make_synthetic(256, vocab_size=64, num_slots=4, seed=3))


def fm_hash(mod):
    tr = mod.FMTrainer(vocab_size=64, num_slots=4, emb_dim=4, step_size=2.0, sparse=True)
    return tr, list(mod.make_synthetic_sparse(256, vocab_size=64, num_slots=4, seed=5))


APPS = {"addvector": (addvector, taddvector, jaddvector),
        "widedeep": (widedeep, twidedeep, jwidedeep),
        "fm_hash": (fm_hash, twidedeep, jwidedeep)}


def grow(P, handle, exs, epoch):
    if epoch != 1:
        return None
    plan = P.ETPlan()
    alloc = plan.add_op(P.AllocateOp("new"))
    assoc = plan.add_op(P.AssociateOp(handle.table_id, "new"), depends_on=[alloc])
    plan.add_op(P.MoveOp(handle.table_id, exs[0].id, "new", 4), depends_on=[assoc])
    return plan


def shrink(P, handle, exs, epoch):
    if epoch != 2:
        return None
    victim = exs[1].id
    n = handle.block_manager.block_counts()[victim]
    plan = P.ETPlan()
    mv = plan.add_op(P.MoveOp(handle.table_id, victim, exs[0].id, n))
    un = plan.add_op(P.UnassociateOp(handle.table_id, victim), depends_on=[mv])
    plan.add_op(P.DeallocateOp(victim), depends_on=[un])
    return plan


def grow_then_shrink(P, handle, exs, epoch):
    if epoch == 1:
        plan = P.ETPlan()
        alloc = plan.add_op(P.AllocateOp("v"))
        assoc = plan.add_op(P.AssociateOp(handle.table_id, "v"), depends_on=[alloc])
        plan.add_op(P.MoveOp(handle.table_id, exs[0].id, "v", 3), depends_on=[assoc])
        return plan
    if epoch == 3:
        new_id = next(e for e in handle.block_manager.executors
                      if e not in {x.id for x in exs})
        n = handle.block_manager.block_counts()[new_id]
        plan = P.ETPlan()
        mv = plan.add_op(P.MoveOp(handle.table_id, new_id, exs[1].id, n))
        un = plan.add_op(P.UnassociateOp(handle.table_id, new_id), depends_on=[mv])
        plan.add_op(P.DeallocateOp(new_id), depends_on=[un])
        return plan
    return None


PLANS = {"grow": (grow, 3), "shrink": (shrink, 1), "grow_then_shrink": (grow_then_shrink, 2)}


def table_config(trainer):
    cfg = trainer.model_table_config()
    return cfg.replace(num_blocks=16)


def final_state(table):
    """A dense table's key-order values, a hash table's {key: value}."""
    if hasattr(table, "items"):
        return {int(k): np.asarray(v) for k, v in table.items().items()}
    return np.asarray(table.pull_array())


def port_run(app, make_plan=None, worker_args=None, hook=None):
    """Train ``app`` on a table of 2 of 4 virtual slots' executors, firing
    ``make_plan(plan_pkg, handle, executors, epoch)`` after each epoch.
    Returns (result, final state, owning executors, master)."""
    build, mod, _ = APPS[app]
    trainer, arrays = build(mod)
    master = ETMaster(DevicePool.virtual("cpu", 4))
    exs = master.add_executors(2)
    table = master.create_table(table_config(trainer), [e.id for e in exs])
    handle = master.table_handle(table.spec.table_id)
    errors = []

    def on_epoch(epoch):
        plan = make_plan(tplan, handle, exs, epoch) if make_plan else None
        if plan is not None:
            result = tplan.PlanExecutor(master).execute(plan)
            if not result.success:
                errors.append(result.error)

    params = TrainerParams(num_epochs=EPOCHS, num_mini_batches=NB,
                           **(worker_args or {}).pop("params", {}))
    worker = WorkerTasklet("mig", TrainerContext(params=params, model_table=table),
                           trainer, TrainingDataProvider(arrays, NB),
                           epoch_callback=on_epoch if make_plan else None,
                           **(worker_args or {}))
    if hook is not None:
        hook(worker, master, handle, exs)
    result = worker.run()
    assert not errors, errors
    return result, final_state(table), handle.owning_executors(), master


def jax_run(app, make_plan):
    build, _, mod = APPS[app]
    trainer, arrays = build(mod)
    master = JaxETMaster(JaxDevicePool(jax.devices()[:4]))
    exs = master.add_executors(2)
    handle = master.create_table(table_config(trainer), [e.id for e in exs])
    errors = []

    def on_epoch(epoch):
        plan = make_plan(jplan, handle, exs, epoch)
        if plan is not None:
            result = jplan.PlanExecutor(master).execute(plan)
            if not result.success:
                errors.append(result.error)

    worker = JaxWorker("mig", JaxTrainerContext(
        params=JaxTrainerParams(num_epochs=EPOCHS, num_mini_batches=NB),
        model_table=handle.table), trainer, JaxProvider(arrays, NB),
        handle.table.mesh, epoch_callback=on_epoch)
    worker.run()
    assert not errors, errors
    return final_state(handle.table), handle.owning_executors()


_unmoved = {}


def unmoved(app):
    if app not in _unmoved:
        _unmoved[app] = port_run(app)[:2]
    return _unmoved[app]


def assert_same_bits(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
    else:
        assert got.tobytes() == want.tobytes()


def assert_close(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_moves_at_epoch_boundaries_match_the_reference_and_the_unmoved_bits(app, plan):
    make_plan, owners = PLANS[plan]
    result, state, owning, _ = port_run(app, make_plan)
    ref_state, ref_owning = jax_run(app, make_plan)
    assert len(owning) == len(ref_owning) == owners
    base_result, base_state = unmoved(app)
    assert result["batch_losses"] == base_result["batch_losses"]
    assert_same_bits(state, base_state)
    assert_close(state, ref_state)


def test_a_three_owner_table_is_replicated_and_every_replica_alike():
    """16 blocks over 3 owners do not divide: every slot holds every block,
    and after training every replica holds the same bytes."""
    _, _, owning, master = port_run("widedeep", grow)
    assert len(owning) == 3
    (tid,) = master.table_ids()
    table = master.get_table(tid)
    assert table.sharding.spec == () and len(table.array.shards) == 3
    shards = list(table.array.shards.values())
    assert all(t.numpy().tobytes() == shards[0].numpy().tobytes() for t in shards)


def concurrent_plan(handle, exs):
    plan = tplan.ETPlan()
    alloc = plan.add_op(tplan.AllocateOp("m"))
    assoc = plan.add_op(tplan.AssociateOp(handle.table_id, "m"), depends_on=[alloc])
    plan.add_op(tplan.MoveOp(handle.table_id, exs[0].id, "m", 4), depends_on=[assoc])
    return plan


def mid_run_move(start_at, done_by, errors):
    """A hook for ``port_run``: the move starts on a thread of its own when
    the worker reaches dispatch ``start_at`` and has finished by dispatch
    ``done_by``, so it lands while steps are dispatching."""

    def hook(worker, master, handle, exs):
        calls = [0]
        box = {}
        dispatch = worker._dispatch

        def counted(*args):
            if calls[0] == start_at:
                def migrate():
                    r = tplan.PlanExecutor(master).execute(concurrent_plan(handle, exs))
                    if not r.success:
                        errors.append(r.error)
                box["t"] = threading.Thread(target=migrate)
                box["t"].start()
            if calls[0] == done_by:
                box["t"].join(timeout=30)
            calls[0] += 1
            return dispatch(*args)

        worker._dispatch = counted

    return hook


@pytest.mark.parametrize("app", ["addvector", "widedeep", "fm_hash"])
def test_a_move_during_per_batch_units(app):
    errors = []
    result, state, owning, _ = port_run(
        app, worker_args={"batch_barrier": lambda i: False},
        hook=mid_run_move(5, 9, errors))
    assert not errors, errors
    assert len(owning) == 3 and result["fused_epochs"] is False
    base_result, base_state = unmoved(app)
    assert result["batch_losses"] == base_result["batch_losses"]
    assert_same_bits(state, base_state)


@pytest.mark.parametrize("app", ["addvector", "widedeep"])
def test_a_move_inside_a_fused_window(app):
    errors = []
    result, state, owning, _ = port_run(
        app, worker_args={"params": {"comm_probe_period": 0}},
        hook=mid_run_move(5, 9, errors))
    assert not errors, errors
    assert len(owning) == 3 and result["fused_epochs"] is True
    assert result["windows"][0] > 1
    base_result, base_state = unmoved(app)
    assert result["batch_losses"] == base_result["batch_losses"]
    assert_same_bits(state, base_state)


def test_a_reader_never_sees_a_torn_layout():
    """AddVector adds the same delta to every key each step, so every
    committed table holds one value in every row. A reader's multi_get of
    all keys while the table moves back and forth must see one value in
    every row, never decreasing."""
    trainer, arrays = addvector(taddvector)
    master = ETMaster(DevicePool.virtual("cpu", 4))
    exs = master.add_executors(2)
    table = master.create_table(table_config(trainer), [e.id for e in exs])
    handle = master.table_handle(table.spec.table_id)
    (extra,) = master.add_executors(1)
    handle.associate(extra.id)
    stop = threading.Event()
    seen, bad = [], []

    def read():
        while not stop.is_set():
            rows = table.multi_get(list(range(16)))
            if not np.all(rows == rows[0, 0]) or (seen and rows[0, 0] < seen[-1]):
                bad.append(rows)
            seen.append(rows[0, 0])
            time.sleep(0.0005)

    def move():
        for i in range(6):
            src, dst = (exs[0].id, extra.id) if i % 2 == 0 else (extra.id, exs[0].id)
            handle.move_blocks(src, dst, 4)

    reader = threading.Thread(target=read)
    mover = threading.Thread(target=move)
    reader.start()
    params = TrainerParams(num_epochs=EPOCHS, num_mini_batches=NB)
    worker = WorkerTasklet("rd", TrainerContext(params=params, model_table=table), trainer,
                           TrainingDataProvider(arrays, NB), batch_barrier=lambda i: False)
    mover.start()
    worker.run()
    mover.join(timeout=30)
    stop.set()
    reader.join(timeout=30)
    assert not bad and len(seen) > 1
    np.testing.assert_array_equal(table.pull_array().numpy(),
                                  np.full((16, 2), trainer.expected_value(128 * EPOCHS)))


def test_move_blocks_copies_only_the_blocks_that_leave_a_slot():
    """2 owners of 16 blocks (8 each) to 4 (4 each): the first slot keeps a
    shard of 4 of its blocks (a local copy), the second takes 4 blocks of the
    first and the others 4 each; nothing else travels."""
    trainer, _ = widedeep(twidedeep)
    master = ETMaster(DevicePool.virtual("cpu", 4))
    exs = master.add_executors(4)
    table = master.create_table(table_config(trainer), [e.id for e in exs[:2]])
    handle = master.table_handle(table.spec.table_id)
    before = final_state(table)
    handle.associate(exs[2].id)
    handle.associate(exs[3].id)
    handle.rebalance([e.id for e in exs])
    stats = dict(blockmove.last_move_stats)
    assert table.mesh.shape == {"data": 1, "model": 4}
    assert stats["blocks_moved"] == 12 and stats["blocks_copied_locally"] == 4
    assert stats["shards_reused"] == 0
    assert_same_bits(final_state(table), before)
    # the same layout again: a no-op, nothing copied
    handle.rebalance([e.id for e in exs])
    assert blockmove.last_move_stats == stats
    # one executor drained: its 4 blocks move to the owners that take them
    handle.move_blocks(exs[3].id, exs[0].id, 4)
    assert table.mesh.shape == {"data": 1, "model": 3}
    assert_same_bits(final_state(table), before)


def test_a_move_between_processes_is_refused_naming_the_pod(monkeypatch):
    from harmony_tpu_torch.table import blockmove as bm

    trainer, _ = addvector(taddvector)
    master = ETMaster(DevicePool.virtual("cpu", 4))
    exs = master.add_executors(3)
    table = master.create_table(table_config(trainer), [e.id for e in exs[:2]])
    handle = master.table_handle(table.spec.table_id)
    handle.associate(exs[2].id)
    # the route goes between processes: outside a pod it is refused
    monkeypatch.setattr(bm, "spans_processes", lambda old, new: True)
    before = final_state(table)
    with pytest.raises(RuntimeError, match="needs the pod's runtime"):
        handle.move_blocks(exs[0].id, exs[2].id, 4)
    # transfer first, mutate after: the table is untouched
    assert table.mesh.size == 2
    assert_same_bits(final_state(table), before)


def test_commit_rehomes_a_result_from_the_layout_before_a_reshard():
    trainer, _ = widedeep(twidedeep)
    master = ETMaster(DevicePool.virtual("cpu", 4))
    exs = master.add_executors(3)
    table = master.create_table(table_config(trainer), [e.id for e in exs[:2]])
    handle = master.table_handle(table.spec.table_id)
    stale = table.array.clone()       # a result on the 2-slot layout
    want = final_state(table)
    handle.associate(exs[2].id)
    handle.move_blocks(exs[0].id, exs[2].id, 4)
    assert table.mesh.size == 3
    with table._lock:
        table.commit(stale)
    assert table.array.sharding == table.sharding
    assert_same_bits(final_state(table), want)
