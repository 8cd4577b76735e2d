"""harmony_tpu_torch.plan and utils/dag against harmony_tpu's, on the CPU.

The same scripted inputs (seeded numpy draws) go through both packages: the
DAG's roots, releases and topological order, the plan executor's op order
and its failure rule, and the ownership ops (Allocate, Associate, Move,
Unassociate, Deallocate) on the port's ETMaster over 4 virtual CPU slots
against the reference's over 4 virtual CPU devices. Everything here is
exact: vertex sets, op orders, block counts, and table values (integer-valued
adds, moved block for block).
"""
import threading

import jax
import numpy as np
import pytest
import torch

from harmony_tpu import plan as jplan
from harmony_tpu.config.params import TableConfig as JaxTableConfig
from harmony_tpu.parallel import DevicePool as JaxDevicePool
from harmony_tpu.runtime import ETMaster as JaxETMaster
from harmony_tpu.utils.dag import DAG as JaxDAG
from harmony_tpu.utils.dag import CyclicDependencyError as JaxCycle
from harmony_tpu_torch import plan as tplan
from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.runtime.master import ETMaster
from harmony_tpu_torch.utils.dag import DAG, CyclicDependencyError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_edges(rng, n):
    """Edges of a random DAG over ``n`` vertices (i -> j only for i < j, so no
    cycle) in a random order, plus some back edges that would close one."""
    fwd = [(i, j) for i in range(n) for j in range(i + 1, n) if rng.random() < 0.3]
    order = rng.permutation(len(fwd))
    back = [(j, i) for i, j in fwd[:3]]
    return [fwd[k] for k in order], back


@pytest.mark.parametrize("seed", range(6))
def test_dag_roots_releases_and_order_are_the_references(seed):
    rng = np.random.default_rng(seed)
    n = 12
    edges, back = random_edges(rng, n)
    dags = (DAG(), JaxDAG())
    for d in dags:
        for v in range(n):
            d.add_vertex(v)
        for a, b in edges:
            d.add_edge(a, b)
    for a, b in back:
        with pytest.raises(JaxCycle):
            dags[1].add_edge(a, b)
        with pytest.raises(CyclicDependencyError):
            dags[0].add_edge(a, b)
    assert dags[0].topological_order() == dags[1].topological_order()
    # pop in a seeded order: remove one root at a time, or a non-root vertex
    while len(dags[1]):
        roots = sorted(dags[1].roots())
        assert sorted(dags[0].roots()) == roots
        pool = roots if rng.random() < 0.8 else sorted(dags[1].vertices())
        v = pool[int(rng.integers(len(pool)))]
        assert sorted(dags[0].remove(v)) == sorted(dags[1].remove(v))
        assert len(dags[0]) == len(dags[1])
    with pytest.raises(KeyError):
        dags[0].remove(0)


def probe_plan(P, log, lock, gate):
    """A diamond and a chain: a, b (concurrent; each waits for the other at
    ``gate``) -> c -> d, and e -> f independent of them."""

    class Probe(P.Op):
        def __init__(self, name, barrier=None):
            super().__init__()
            self.name = name
            self.barrier = barrier

        def execute(self, ctx):
            if self.barrier is not None:
                self.barrier.wait()
            with lock:
                log.append(self.name)

    plan = P.ETPlan()
    a = plan.add_op(Probe("a", gate))
    b = plan.add_op(Probe("b", gate))
    c = plan.add_op(Probe("c"), depends_on=[a, b])
    plan.add_op(Probe("d"), depends_on=[c])
    plan.add_chain([Probe("e"), Probe("f")])
    return plan


def test_the_executor_runs_ready_ops_together_and_dependents_after():
    orders = []
    for P in (tplan, jplan):
        log, lock = [], threading.Lock()
        plan = probe_plan(P, log, lock, threading.Barrier(2, timeout=10))
        assert plan.num_ops == 6
        result = P.PlanExecutor(None).execute(plan)
        assert result.success and plan.remaining() == 0
        assert sorted(o.name for o in result.executed) == sorted("abcdef")
        orders.append(log)
    for log in orders:
        # a and b overlap (the barrier), c after both, d after c, f after e
        assert set(log[:2]) <= set("abe") and {"a", "b"} <= set(log[:3])
        assert log.index("c") > max(log.index("a"), log.index("b"))
        assert log.index("d") > log.index("c") and log.index("f") > log.index("e")
    # the dependency chain's order is the same in both packages
    assert [x for x in orders[0] if x in "abcd"][2:] == [x for x in orders[1] if x in "abcd"][2:]


def test_a_failed_op_stops_its_dependents_as_the_reference_does():
    out = []
    for P in (tplan, jplan):
        ran = []

        class Fail(P.Op):
            def execute(self, ctx):
                raise RuntimeError("boom")

        class Mark(P.Op):
            def execute(self, ctx):
                ran.append(1)

        plan = P.ETPlan()
        f = plan.add_op(Fail())
        plan.add_op(Mark(), depends_on=[f])
        result = P.PlanExecutor(None).execute(plan)
        out.append((result.success, type(result.error), ran, len(result.executed)))
    assert out[0] == out[1] == (False, RuntimeError, [], 0)


def masters():
    return (ETMaster(DevicePool.virtual("cpu", 4)),
            JaxETMaster(JaxDevicePool(jax.devices()[:4])))


def tables(port, ref, n, tid="t", blocks=16):
    kw = dict(table_id=tid, capacity=64, value_shape=(2,), num_blocks=blocks)
    pex, rex = port.add_executors(n), ref.add_executors(n)
    pt = port.create_table(TableConfig(**kw), [e.id for e in pex])
    rh = ref.create_table(JaxTableConfig(**kw), [e.id for e in rex])
    vals = np.random.default_rng(3).integers(-8, 9, size=(64, 2)).astype(np.float32)
    pt.multi_update(list(range(64)), vals)
    rh.table.multi_update(list(range(64)), vals)
    return port.table_handle(tid), rh, pex, rex


def assert_same_tables(ph, rh):
    assert list(ph.block_manager.block_counts().values()) == \
        list(rh.block_manager.block_counts().values())
    assert ph.block_manager.ownership_vector() == rh.block_manager.ownership_vector()
    assert len(ph.owning_executors()) == len(rh.owning_executors())
    np.testing.assert_array_equal(ph.table.pull_array().numpy(),
                                  np.asarray(rh.table.pull_array()))


def test_add_server_plan_is_the_references():
    """Allocate -> Associate -> Move (the AddOneServer plan)."""
    port, ref = masters()
    ph, rh, pex, rex = tables(port, ref, 2)
    for P, m, ex in ((tplan, port, pex), (jplan, ref, rex)):
        plan = P.ETPlan()
        alloc = plan.add_op(P.AllocateOp("v0"))
        assoc = plan.add_op(P.AssociateOp("t", "v0"), depends_on=[alloc])
        plan.add_op(P.MoveOp("t", ex[0].id, "v0", 4), depends_on=[assoc])
        result = P.PlanExecutor(m).execute(plan)
        assert result.success, result.error
        assert [o.kind for o in result.executed] == ["allocate", "associate", "move"]
    assert_same_tables(ph, rh)
    assert ph.table.mesh.shape == {"data": 1, "model": 3}


def test_delete_server_plan_is_the_references():
    """Move -> Unassociate -> Deallocate (the DeleteOneServer plan); 12
    blocks over 3 owners, then 2."""
    port, ref = masters()
    ph, rh, pex, rex = tables(port, ref, 3, tid="t2", blocks=12)
    for P, m, ex in ((tplan, port, pex), (jplan, ref, rex)):
        victim = ex[2].id
        plan = P.ETPlan()
        mv = plan.add_op(P.MoveOp("t2", victim, ex[0].id, 4))
        un = plan.add_op(P.UnassociateOp("t2", victim), depends_on=[mv])
        plan.add_op(P.DeallocateOp(victim), depends_on=[un])
        result = P.PlanExecutor(m).execute(plan)
        assert result.success, result.error
        assert [o.kind for o in result.executed] == ["move", "unassociate", "deallocate"]
        assert victim not in m.executor_ids()
    assert_same_tables(ph, rh)


def test_grow_shrink_cycle_and_the_association_guard():
    port, ref = masters()
    ph, rh, pex, rex = tables(port, ref, 2)
    for m, h, ex in ((port, ph, pex), (ref, rh, rex)):
        (new,) = m.add_executors(1)
        h.associate(new.id)
        h.move_blocks(ex[0].id, new.id, 4)
        assert h.block_manager.block_counts()[new.id] == 4
        if m is port:
            # still associated: refused, and the executor stays (the
            # reference pops it before it checks, so a refused remove there
            # loses the executor; not repeated here)
            with pytest.raises(RuntimeError):
                m.remove_executor(new.id)
            assert new.id in m.executor_ids()
        h.move_blocks(new.id, ex[1].id, 4)
        h.unassociate(new.id)
        m.remove_executor(new.id)
        assert new.id not in m.executor_ids()
    assert_same_tables(ph, rh)
    # an executor id is never handed out twice
    assert len(set(port.executor_ids()) | {e.id for e in port.add_executors(2)}) == 4


def test_create_drop_and_rebalance_ops():
    port, ref = masters()
    for P, m in ((tplan, port), (jplan, ref)):
        cfg = (TableConfig if P is tplan else JaxTableConfig)(
            table_id="c", capacity=32, value_shape=(2,), num_blocks=8)
        plan = P.ETPlan()
        a0 = plan.add_op(P.AllocateOp("x"))
        a1 = plan.add_op(P.AllocateOp("y"))
        plan.add_op(P.CreateOp(cfg, ["x", "y"]), depends_on=[a0, a1])
        assert P.PlanExecutor(m).execute(plan).success
    ph, rh = port.table_handle("c"), ref.get_table("c")
    assert_same_tables(ph, rh)
    for h in (ph, rh):
        h.rebalance(list(h.block_manager.executors[:1]))
    assert_same_tables(ph, rh)
    assert ph.table.mesh.size == 1
    for P, m in ((tplan, port), (jplan, ref)):
        plan = P.ETPlan()
        plan.add_op(P.DropOp("c"))
        assert P.PlanExecutor(m).execute(plan).success
        assert "c" not in m.table_ids()
