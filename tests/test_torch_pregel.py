"""The Pregel engine (``pregel/``, ``apps/{pagerank,sssp,concomp}.py``) against
harmony_tpu's on the CPU.

The same graphs go through the JAX ``PregelMaster`` on a one-device CPU mesh
and the port's. Tolerances:

* Graphs, error texts, superstep counts, shortest-path distances and
  component labels: exact (a byte copy, f32 adds of the same two operands,
  and mins).
* PageRank ranks: 1e-6 relative. The port folds each destination's messages
  in edge order from 0.0; XLA's CPU scatter and its fused ``base + d * msg``
  round differently in the last bit (about 4e-7 relative, measured), so the
  ranks are not bit-identical.
"""
import json

import jax
import numpy as np
import pytest
import torch

from harmony_tpu.apps.concomp import ConnectedComponentsComputation as JaxCC
from harmony_tpu.apps.pagerank import PageRankComputation as JaxPR
from harmony_tpu.apps.sssp import ShortestPathComputation as JaxSSSP
from harmony_tpu.config.params import TableConfig as JaxTableConfig
from harmony_tpu.parallel import build_mesh
from harmony_tpu.pregel import PregelMaster as JaxMaster
from harmony_tpu.pregel import graph as jax_graph
from harmony_tpu.table import DenseTable as JaxDenseTable
from harmony_tpu.table import TableSpec as JaxTableSpec
from harmony_tpu_torch import cli, convert
from harmony_tpu_torch.apps.concomp import ConnectedComponentsComputation
from harmony_tpu_torch.apps.pagerank import PageRankComputation
from harmony_tpu_torch.apps.sssp import INF, ShortestPathComputation
from harmony_tpu_torch.config.params import JobConfig, TableConfig, TrainerParams
from harmony_tpu_torch.jobserver.entity import PregelJobEntity, build_entity
from harmony_tpu_torch.jobserver.server import JobServer
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.pregel import Graph, PregelMaster
from harmony_tpu_torch.pregel import graph as graph_mod
from harmony_tpu_torch.pregel import master as master_mod
from harmony_tpu_torch.runtime.master import ETMaster
from harmony_tpu_torch.table.table import DenseTable, TableSpec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PR_RTOL = 1e-6
TIMEOUT = 120


def _mesh():
    return build_mesh(jax.devices()[:1])


def _graphs(num_vertices, edges):
    """The same edge list as a Graph of each package."""
    return (Graph.from_edge_list(num_vertices, edges),
            jax_graph.Graph.from_edge_list(num_vertices, edges))


def _run_both(g, jg, make, jmake, max_supersteps=100):
    got = PregelMaster(g, make(g), "cpu", max_supersteps=max_supersteps).run()
    want = JaxMaster(jg, jmake(jg), _mesh(), max_supersteps=max_supersteps).run()
    return got, want


def _assert_same(got, want, pagerank: bool) -> None:
    assert got["supersteps"] == want["supersteps"]
    a, b = got["vertex_values"], np.asarray(want["vertex_values"])
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    if pagerank:
        np.testing.assert_allclose(a, b, rtol=PR_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(a, b)


# -- Graph --------------------------------------------------------------------


def test_graph_construction_matches():
    for mod in (graph_mod, jax_graph):
        g = mod.Graph.from_edge_list(3, [(0, 1), (1, 2, 2.5)])
        assert g.num_edges == 2 and g.out_degree.tolist() == [1.0, 1.0, 0.0]
        assert g.src.dtype == g.dst.dtype == np.int32 and g.weight.dtype == np.float32
    u = Graph.from_edge_list(3, [(0, 1, 2.0), (1, 2, 3.0)]).undirected()
    ju = jax_graph.Graph.from_edge_list(3, [(0, 1, 2.0), (1, 2, 3.0)]).undirected()
    for attr in ("src", "dst", "weight", "out_degree"):
        np.testing.assert_array_equal(getattr(u, attr), getattr(ju, attr))


@pytest.mark.parametrize("weighted", [False, True])
def test_random_graph_is_byte_identical(weighted):
    a = graph_mod.random_graph(500, avg_degree=6, seed=3, weighted=weighted)
    b = jax_graph.random_graph(500, avg_degree=6, seed=3, weighted=weighted)
    assert a.num_vertices == b.num_vertices
    for attr in ("src", "dst", "weight", "out_degree"):
        x, y = getattr(a, attr), getattr(b, attr)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (a.src != a.dst).all()


@pytest.mark.parametrize("build", [
    lambda m: m.Graph.from_edge_list(2, [(0, 5)]),
    lambda m: m.Graph.from_edge_list(2, [(-1, 0)]),
    lambda m: m.Graph(3, np.array([0, 1]), np.array([1])),
])
def test_bad_graphs_raise_the_references_errors(build):
    with pytest.raises(ValueError) as want:
        build(jax_graph)
    with pytest.raises(ValueError) as got:
        build(graph_mod)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("text", [
    "# a comment\n0 1\n1 2\n\n2 0\n",
    "0 1 0.5\n1 2 1.5\n",
    "0 1 2 3\n",
    "0 1 0.5\n1 2\n",
    "0 1\n1 2 0.5\n",
    "",
])
def test_load_edge_list_matches(tmp_path, text):
    path = tmp_path / "edges.txt"
    path.write_text(text)
    try:
        want = jax_graph.load_edge_list(str(path))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            graph_mod.load_edge_list(str(path))
        assert str(got.value) == str(e)
        return
    got = graph_mod.load_edge_list(str(path))
    assert got.num_vertices == want.num_vertices
    for attr in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))


# -- the JAX package's tests/test_pregel.py cases, against its master ----------

SSSP_CASES = {
    "line graph": (4, [(0, 1, 1.0), (1, 2, 2.0), (2, 3, 3.0)]),
    "shorter path wins": (4, [(0, 3, 10.0), (0, 1, 1.0), (1, 2, 1.0), (2, 3, 1.0)]),
    "unreachable stays INF": (3, [(0, 1, 1.0)]),
    "cycle terminates": (3, [(0, 1, 1.0), (1, 2, 1.0), (2, 0, 1.0)]),
}


@pytest.mark.parametrize("case", sorted(SSSP_CASES))
def test_shortest_path_matches(case):
    v, edges = SSSP_CASES[case]
    g, jg = _graphs(v, edges)
    got, want = _run_both(g, jg, lambda g: ShortestPathComputation(0),
                          lambda g: JaxSSSP(0))
    _assert_same(got, want, pagerank=False)
    dist = got["vertex_values"][:, 0]
    expected = {"line graph": [0, 1, 3, 6], "shorter path wins": [0, 1, 2, 3],
                "unreachable stays INF": [0, 1, INF], "cycle terminates": [0, 1, 2]}
    np.testing.assert_array_equal(dist, np.float32(expected[case]))


def test_pagerank_ranks_sum_to_one():
    g, jg = _graphs(4, [(0, 1), (1, 2), (2, 0), (2, 3), (3, 0)])
    got, want = _run_both(g, jg, lambda g: PageRankComputation(g, num_iterations=15),
                          lambda g: JaxPR(g, num_iterations=15), max_supersteps=20)
    _assert_same(got, want, pagerank=True)
    assert got["supersteps"] == 16      # the seed superstep + 15 rank updates
    np.testing.assert_allclose(got["vertex_values"][:, 0].sum(), 1.0, atol=1e-3)


def test_pagerank_matches_power_iteration():
    rng = np.random.default_rng(9)
    V, E = 12, 40
    src = np.concatenate([rng.integers(0, V, E), np.arange(V)])
    dst = np.concatenate([rng.integers(0, V, E), (np.arange(V) + 1) % V])
    g, jg = Graph(V, src, dst), jax_graph.Graph(V, src, dst)
    got, want = _run_both(g, jg, lambda g: PageRankComputation(g, num_iterations=30),
                          lambda g: JaxPR(g, num_iterations=30), max_supersteps=40)
    _assert_same(got, want, pagerank=True)
    M = np.zeros((V, V))
    for s, d in zip(g.src, g.dst):
        M[d, s] += 1.0 / g.out_degree[s]
    r = np.full(V, 1.0 / V)
    for _ in range(30):
        r = 0.15 / V + 0.85 * M @ r
    np.testing.assert_allclose(got["vertex_values"][:, 0], r, atol=1e-4)


CC_CASES = {
    "two components": (6, [(0, 1), (1, 0), (1, 2), (2, 1), (3, 4), (4, 3)], [0, 0, 0, 3, 3, 5]),
    "directed chain": (5, [(i, i + 1) for i in range(4)], [0] * 5),
    "reversed chain": (5, [(i + 1, i) for i in range(4)], [0] * 5),
}


@pytest.mark.parametrize("case", sorted(CC_CASES))
def test_connected_components_match(case):
    v, edges, labels = CC_CASES[case]
    g, jg = _graphs(v, edges)
    got, want = _run_both(g, jg, lambda g: ConnectedComponentsComputation(),
                          lambda g: JaxCC())
    _assert_same(got, want, pagerank=False)
    np.testing.assert_array_equal(got["vertex_values"][:, 0], np.float32(labels))
    assert got["supersteps"] <= 6


@pytest.mark.parametrize("app", ["pagerank", "sssp", "concomp"])
def test_random_graph_runs_match(app):
    """The CLI presets' graph shape (random, 5 out-edges a vertex) at 400
    vertices: supersteps, distances and labels exact, ranks within 1e-6."""
    g = graph_mod.random_graph(400, 5, seed=2, weighted=app == "sssp")
    jg = jax_graph.random_graph(400, 5, seed=2, weighted=app == "sssp")
    make, jmake = {
        "pagerank": (lambda g: PageRankComputation(g, 10), lambda g: JaxPR(g, 10)),
        "sssp": (lambda g: ShortestPathComputation(7), lambda g: JaxSSSP(7)),
        "concomp": (lambda g: ConnectedComponentsComputation(), lambda g: JaxCC()),
    }[app]
    got, want = _run_both(g, jg, make, jmake)
    _assert_same(got, want, pagerank=app == "pagerank")


def test_connected_components_refuse_more_than_two_to_the_24_vertices():
    with pytest.raises(ValueError) as want:
        JaxCC().initial_state(2 ** 24 + 1)
    with pytest.raises(ValueError, match=r"2\^24"):
        ConnectedComponentsComputation().initial_state(2 ** 24 + 1, torch.device("cpu"))
    assert str(want.value).startswith(f"{2 ** 24 + 1} vertices exceed")


@pytest.mark.parametrize("app,k1,k2", [("pagerank", 1, 1), ("sssp", 1, 0)])
def test_a_superstep_gathers_with_k1_and_folds_adds_with_k2(monkeypatch, app, k1, k2):
    """The wiring on the CPU: each superstep calls gather_rows (K1) once for
    the edge gather and, for the "add" combiner only, segment_sum_rows (K2)
    once; min/max folds take scatter_reduce_."""
    calls = {"gather_rows": 0, "segment_sum_rows": 0}
    for name in calls:
        real = getattr(master_mod, name)

        def spy(*args, _real=real, _name=name):
            calls[_name] += 1
            return _real(*args)

        monkeypatch.setattr(master_mod, name, spy)
    g = graph_mod.random_graph(100, 4, weighted=True)
    comp = PageRankComputation(g, 5) if app == "pagerank" else ShortestPathComputation(0)
    res = PregelMaster(g, comp, "cpu").run()
    assert calls == {"gather_rows": k1 * res["supersteps"],
                     "segment_sum_rows": k2 * res["supersteps"]}


def test_runs_start_alike_from_the_same_vertex_state():
    """convert.pregel_vertex_state_from_numpy: both masters start from the same
    (non-initial) distances and relax to the same result."""
    g = graph_mod.random_graph(200, 4, seed=5, weighted=True)
    jg = jax_graph.random_graph(200, 4, seed=5, weighted=True)
    state = np.full((200, 1), INF, np.float32)
    state[:20, 0] = np.arange(20, dtype=np.float32) * 0.25
    mine = PregelMaster(g, ShortestPathComputation(0), "cpu")
    convert.pregel_vertex_state_from_numpy(mine, state)
    with pytest.raises(ValueError, match="vertex state"):
        convert.pregel_vertex_state_from_numpy(mine, state[:10])
    theirs = JaxMaster(jg, JaxSSSP(0), _mesh())
    theirs.vertex_table.write_all(state)
    _assert_same(mine.run(), theirs.run(), pagerank=False)


# -- tables -------------------------------------------------------------------


def test_apply_step_multi_commits_every_table_under_its_lock():
    tables = [DenseTable(TableSpec(TableConfig(table_id=f"t{i}", capacity=5,
                                               num_blocks=2)), "cpu")
              for i in range(3)]
    seen = []

    def step(a, b, c, scale):
        for t in tables:
            seen.append(t._lock._is_owned())
        return (a.add_(scale), b.add_(2 * scale), c), "aux"

    assert DenseTable.apply_step_multi(tables, step, 1.0) == "aux"
    assert seen == [True, True, True]
    assert [t.data_version for t in tables] == [1, 1, 1]
    assert [t.pull_array().tolist() for t in tables] == [[1.0] * 5, [2.0] * 5, [0.0] * 5]
    assert not any(t._lock._is_owned() for t in tables)


@pytest.mark.parametrize("is_ordered", [True, False])
@pytest.mark.parametrize("update", ["add", "min", "max"])
def test_scalar_tables_pull_push_and_write_all_like_the_references(is_ordered, update):
    """value_shape=() tables (Lasso, AddInteger, the message tables): keyed
    pull, a push with duplicate keys, write_all and pull_all, exact against
    the JAX table on integer-valued deltas."""
    kw = dict(table_id="s", capacity=10, value_shape=(), num_blocks=4,
              is_ordered=is_ordered, update_fn=update)
    spec, jspec = TableSpec(TableConfig(**kw)), JaxTableSpec(JaxTableConfig(**kw))
    mine, theirs = DenseTable(spec, "cpu"), JaxDenseTable(jspec, _mesh())
    values = np.arange(10, dtype=np.float32) * 3 - 7
    mine.write_all(values)
    theirs.write_all(values)
    keys = np.array([3, 1, 3, 9, 0, 3], np.int32)
    deltas = np.array([1, -2, 5, 4, 8, -3], np.float32)
    mine.multi_update(keys, deltas)
    theirs.multi_update(keys, deltas)
    np.testing.assert_array_equal(mine.multi_get([9, 3, 0, 3]),
                                  np.asarray(theirs.multi_get([9, 3, 0, 3])))
    np.testing.assert_array_equal(mine.pull_array().numpy(),
                                  np.asarray(theirs.pull_array()))
    assert mine.pull_array().shape == (10,)


# -- the job entity, the JobServer and the CLI ----------------------------------


def _pregel_config(job_id="pr", **user):
    return JobConfig(
        job_id=job_id, app_type="pregel",
        trainer="harmony_tpu_torch.apps.pagerank:PageRankComputation",
        params=TrainerParams(app_params={"num_iterations": 6}),
        user={"graph_fn": "harmony_tpu_torch.pregel.graph:random_graph",
              "graph_args": {"num_vertices": 300, "avg_degree": 4}, **user})


def test_pregel_entity_runs_and_drops_its_tables():
    master = ETMaster(DevicePool(["cpu"]))
    (ex,) = master.add_executors(1)
    entity = build_entity(_pregel_config(max_supersteps=4))
    assert isinstance(entity, PregelJobEntity)
    entity.setup(master, [ex.id])
    tables = [entity._pregel_master.vertex_table, *entity._pregel_master._msg_tables,
              *entity._pregel_master._has_msg]
    assert all(t.array is not None for t in tables)
    result = entity.run()
    assert result["supersteps"] == 4 and result["vertex_values"].shape == (300, 2)
    entity.cleanup()
    assert all(t.array is None for t in tables)
    entity.cleanup()  # idempotent
    with pytest.raises(ValueError, match="graph_fn"):
        build_entity(_pregel_config().replace(user={})).setup(master, [ex.id])
    with pytest.raises(ValueError, match="unknown app_type 'bogus'"):
        build_entity(_pregel_config().replace(app_type="bogus"))


def test_pregel_jobs_run_through_the_jobserver_beside_a_dolphin_job():
    server = JobServer(1, device_pool=DevicePool(["cpu"]))
    server.start()
    try:
        pr = server.submit(_pregel_config())
        mlr = server.submit(JobConfig(
            job_id="mlr", app_type="dolphin",
            trainer="harmony_tpu_torch.apps.mlr:MLRTrainer",
            params=TrainerParams(num_epochs=1, num_mini_batches=2, app_params={
                "num_classes": 4, "num_features": 32, "features_per_partition": 8}),
            user={"data_fn": "harmony_tpu_torch.apps.mlr:make_synthetic",
                  "data_args": {"n": 64, "num_features": 32, "num_classes": 4}}))
        got = pr.result(timeout=TIMEOUT)
        assert mlr.result(timeout=TIMEOUT)["job_id"] == "mlr"
    finally:
        server.shutdown(timeout=TIMEOUT)
    jg = jax_graph.random_graph(300, 4)
    want = JaxMaster(jg, JaxPR(jg, 6), _mesh()).run()
    _assert_same(got, want, pagerank=True)
    assert server.master.table_ids() == []


@pytest.mark.parametrize("app", ["pagerank", "connected-components", "shortest-path"])
def test_cli_runs_the_graph_presets_like_the_reference(capsys, app):
    from harmony_tpu import cli as jax_cli

    args = ["run", app, "--data", "num_vertices=500"]
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(args + ["--num-executors", "1"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["job_id"] == want["job_id"] == f"{app}-job"
    got_r, want_r = got["result"], want["result"]
    want_r["vertex_values"] = np.asarray(want_r["vertex_values"], np.float32)
    got_r["vertex_values"] = np.asarray(got_r["vertex_values"], np.float32)
    _assert_same(got_r, want_r, pagerank=app == "pagerank")


def test_cli_reads_a_graph_file_and_bounds_supersteps(tmp_path, capsys):
    path = tmp_path / "g.txt"
    path.write_text("0 1 1.0\n1 2 2.0\n2 3 0.5\n3 4 1.0\n")
    assert cli.main(["run", "shortest-path", "--device", "cpu", "--graph-file", str(path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["result"]
    assert out["vertex_values"] == [[0.0], [1.0], [3.0], [3.5], [4.5]]
    assert cli.main(["run", "shortest-path", "--device", "cpu", "--graph-file", str(path),
                     "--max-supersteps", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["result"]
    assert out["supersteps"] == 2 and out["vertex_values"][3] == [INF]


def test_graph_presets_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run goes to it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["run", "pagerank"])
