"""The Pregel engine on a mesh of slots (``pregel/master.py`` given a mesh,
``jobserver/entity.py::PregelJobEntity``) against harmony_tpu's on the CPU.

The port's master on 4 virtual CPU slots (``build_mesh(slots, data=1)``, the
reference entity's mesh: the vertex and message tables block-sharded over the
model axis) against the reference's ``PregelMaster`` on
``build_mesh(4 of the 8 virtual CPU devices, data=1)``, and against the
port's own one-slot run. Tolerances:

* Against the one-slot run: the bits, for every app and graph. Each shard
  folds the messages of its destinations in the original edge order (the
  edges are partitioned by destination shard with a stable partition), and
  the compute is per vertex.
* Against the reference: ``tests/test_torch_pregel.py``'s: supersteps,
  distances and labels exact, PageRank's ranks within 1e-6 relative.
"""
import jax
import numpy as np
import pytest
import torch

from harmony_tpu.apps.concomp import ConnectedComponentsComputation as JaxCC
from harmony_tpu.apps.pagerank import PageRankComputation as JaxPR
from harmony_tpu.apps.sssp import ShortestPathComputation as JaxSSSP
from harmony_tpu.parallel import build_mesh as jax_build_mesh
from harmony_tpu.pregel import PregelMaster as JaxMaster
from harmony_tpu.pregel import graph as jax_graph
from harmony_tpu_torch import cli
from harmony_tpu_torch.apps.concomp import ConnectedComponentsComputation
from harmony_tpu_torch.apps.pagerank import PageRankComputation
from harmony_tpu_torch.apps.sssp import ShortestPathComputation
from harmony_tpu_torch.config.params import JobConfig, TrainerParams
from harmony_tpu_torch.jobserver.entity import build_entity
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.parallel.mesh import DevicePool, build_mesh
from harmony_tpu_torch.pregel import Graph, PregelMaster
from harmony_tpu_torch.pregel import graph as graph_mod
from harmony_tpu_torch.pregel import master as master_mod
from harmony_tpu_torch.runtime.master import ETMaster

PR_RTOL = 1e-6
TIMEOUT = 120
CPU = torch.device("cpu")

APPS = {
    "pagerank": (lambda g: PageRankComputation(g, 10), lambda g: JaxPR(g, 10), False),
    "sssp": (lambda g: ShortestPathComputation(7), lambda g: JaxSSSP(7), True),
    "concomp": (lambda g: ConnectedComponentsComputation(), lambda g: JaxCC(), False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def slots_mesh(n):
    return build_mesh(DevicePool.virtual(CPU, n).slots, data=1)


def _assert_same(got, want, pagerank: bool) -> None:
    assert got["supersteps"] == want["supersteps"]
    a, b = got["vertex_values"], np.asarray(want["vertex_values"])
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    if pagerank:
        np.testing.assert_allclose(a, b, rtol=PR_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("num_vertices,seed", [(400, 2), (1000, 4)])
def test_four_slots_give_the_one_slot_bits_and_the_references_values(app, num_vertices, seed):
    make, jmake, weighted = APPS[app]
    g = graph_mod.random_graph(num_vertices, 5, seed=seed, weighted=weighted)
    jg = jax_graph.random_graph(num_vertices, 5, seed=seed, weighted=weighted)
    master = PregelMaster(g, make(g), slots_mesh(4))
    sh = master.vertex_table.sharding
    assert sh.spec == ("model",) and sh.num_shards == 4 and len(master._shards) == 4
    got = master.run()
    one = PregelMaster(g, make(g), "cpu").run()
    assert got["supersteps"] == one["supersteps"]
    np.testing.assert_array_equal(got["vertex_values"], one["vertex_values"])
    want = JaxMaster(jg, jmake(jg), jax_build_mesh(jax.devices()[:4], data=1)).run()
    _assert_same(got, want, pagerank=app == "pagerank")


@pytest.mark.parametrize("slots", [2, 3, 4])
@pytest.mark.parametrize("num_vertices", [4, 7, 30])
def test_small_graphs_shard_or_replicate_and_keep_the_bits(slots, num_vertices):
    """A vertex count whose blocks do not split over the slots replicates
    the tables (the reference's rule): one slot computes and the others hold
    copies, alike after the run; one that splits gives shards of a block or
    two. Both give the one-slot run's bits."""
    for app, (make, _, weighted) in APPS.items():
        g = graph_mod.random_graph(num_vertices, 3, seed=1, weighted=weighted)
        if app == "sssp":
            comp, one_comp = ShortestPathComputation(num_vertices - 1), \
                ShortestPathComputation(num_vertices - 1)
        else:
            comp, one_comp = make(g), make(g)
        master = PregelMaster(g, comp, slots_mesh(slots))
        got = master.run()
        one = PregelMaster(g, one_comp, "cpu").run()
        assert got["supersteps"] == one["supersteps"], app
        np.testing.assert_array_equal(got["vertex_values"], one["vertex_values"])
        sh = master.vertex_table.sharding
        assert sh.num_shards == (slots if num_vertices % slots == 0 else 1)
        if sh.num_shards == 1:
            shards = [t for t in master.vertex_table.array.shards.values()]
            for t in shards[1:]:
                assert torch.equal(t, shards[0])


@pytest.mark.parametrize("app,k2", [("pagerank", 1), ("sssp", 0), ("concomp", 0)])
def test_each_shard_gathers_with_k1_and_folds_adds_with_k2(monkeypatch, app, k2):
    """A superstep on 4 shards: gather_rows (K1) once a shard for its edges'
    sources, and for the "add" combiner segment_sum_rows (K2) once a shard
    into the shard's own range."""
    calls = {"gather_rows": [], "segment_sum_rows": []}
    for name in calls:
        real = getattr(master_mod, name)

        def spy(*args, _real=real, _name=name):
            calls[_name].append(tuple(a.shape for a in args if isinstance(a, torch.Tensor)))
            return _real(*args)

        monkeypatch.setattr(master_mod, name, spy)
    make, _, weighted = APPS[app]
    g = graph_mod.random_graph(256, 4, seed=3, weighted=weighted)
    master = PregelMaster(g, make(g), slots_mesh(4))
    res = master.run()
    s = res["supersteps"]
    assert len(calls["gather_rows"]) == 4 * s
    assert len(calls["segment_sum_rows"]) == 4 * k2 * s
    # K1 reads the gathered [V, state] rows; K2 folds into 64 rows a shard
    assert {shape[0] for shape in calls["gather_rows"]} == {(256, make(g).state_dim)}
    if k2:
        edges = sum(int(sh.src.shape[0]) for sh in master._shards)
        assert edges == g.num_edges
    for shard in master._shards:
        dst = shard.dst.numpy()
        assert ((dst >= 0) & (dst < shard.n)).all()


def test_the_edge_partition_is_stable_by_destination_shard():
    g = graph_mod.random_graph(200, 6, seed=8, weighted=True)
    master = PregelMaster(g, ShortestPathComputation(0), slots_mesh(4))
    for shard in master._shards:
        mine = np.flatnonzero((g.dst >= shard.lo) & (g.dst < shard.lo + shard.n))
        np.testing.assert_array_equal(shard.src.numpy(), g.src[mine])
        np.testing.assert_array_equal(shard.dst.numpy() + shard.lo, g.dst[mine])
        np.testing.assert_array_equal(shard.weight.numpy(), g.weight[mine])
    assert sum(s.n for s in master._shards) == 200


def _config(job_id="pr", app="pagerank", **user):
    trainer = {"pagerank": "harmony_tpu_torch.apps.pagerank:PageRankComputation",
               "sssp": "harmony_tpu_torch.apps.sssp:ShortestPathComputation"}[app]
    params = {"num_iterations": 6} if app == "pagerank" else {"source": 3}
    return JobConfig(
        job_id=job_id, app_type="pregel", trainer=trainer,
        params=TrainerParams(app_params=params),
        user={"graph_fn": "harmony_tpu_torch.pregel.graph:random_graph",
              "graph_args": {"num_vertices": 300, "avg_degree": 4,
                             "weighted": app == "sssp"}, **user})


@pytest.mark.parametrize("data_axis", [None, 2])
def test_the_entity_shards_over_every_executor_and_ignores_a_data_axis(data_axis):
    """The reference's entity builds ``build_mesh(devices, data=1)`` for every
    graph job: all executors on the model axis, whatever user["data_axis"]
    says. Cleanup drops every shard of every table."""
    master = ETMaster(DevicePool.virtual(CPU, 4))
    ids = [e.id for e in master.add_executors(4)]
    user = {} if data_axis is None else {"data_axis": data_axis}
    entity = build_entity(_config(**user))
    entity.setup(master, ids)
    pm = entity._pregel_master
    assert pm.mesh.shape == {"data": 1, "model": 4}
    assert [s.index for s in pm.mesh.slots] == [0, 1, 2, 3]
    tables = [pm.vertex_table, *pm._msg_tables, *pm._has_msg]
    assert all(len(t.array.shards) == 4 for t in tables)
    res = entity.run()
    entity.cleanup()
    assert all(t.array is None for t in tables) and pm._shards == []
    one = ETMaster(DevicePool(["cpu"]))
    (ex,) = one.add_executors(1)
    solo = build_entity(_config())
    solo.setup(one, [ex.id])
    try:
        want = solo.run()
    finally:
        solo.cleanup()
    assert res["supersteps"] == want["supersteps"]
    np.testing.assert_array_equal(res["vertex_values"], want["vertex_values"])


def test_a_jobserver_of_four_executors_runs_graph_jobs_sharded():
    server = JobServer(4, device_pool=DevicePool.virtual(CPU, 4))
    server.start()
    try:
        got = {app: server.submit(_config(f"{app}-job", app)).result(timeout=TIMEOUT)
               for app in ("pagerank", "sssp")}
    finally:
        server.shutdown(timeout=TIMEOUT)
    for app, res in got.items():
        g = graph_mod.random_graph(300, 4, weighted=app == "sssp")
        comp = PageRankComputation(g, 6) if app == "pagerank" else ShortestPathComputation(3)
        want = PregelMaster(g, comp, "cpu").run()
        assert res["supersteps"] == want["supersteps"]
        np.testing.assert_array_equal(res["vertex_values"], want["vertex_values"])


def test_the_cli_passes_data_axis_on_a_graph_preset_and_the_entity_ignores_it():
    args = cli.build_parser().parse_args(
        ["run", "pagerank", "--device", "cpu", "--set", "data_axis=2",
         "--data", "num_vertices=128"])
    cfg = cli.build_config(args.app, args)
    assert cfg.user["data_axis"] == 2 and "data_axis" not in cfg.params.app_params
    master = ETMaster(DevicePool.virtual(CPU, 4))
    ids = [e.id for e in master.add_executors(4)]
    entity = build_entity(cfg)
    entity.setup(master, ids)
    try:
        assert entity._pregel_master.mesh.shape == {"data": 1, "model": 4}
        res = entity.run()
    finally:
        entity.cleanup()
    g = graph_mod.random_graph(128, 5)
    want = PregelMaster(g, PageRankComputation(g, 10), "cpu").run()
    np.testing.assert_array_equal(res["vertex_values"], want["vertex_values"])


def test_a_device_is_still_the_one_slot_mesh():
    g = Graph.from_edge_list(3, [(0, 1), (1, 2)])
    master = PregelMaster(g, ConnectedComponentsComputation(), "cpu")
    assert master.mesh.size == 1 and len(master._shards) == 1
    assert master.device == CPU
    np.testing.assert_array_equal(master.run()["vertex_values"][:, 0], [0.0, 0.0, 0.0])
