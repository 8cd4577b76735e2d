"""The pod's runtime (``parallel/multihost.py``) and the cross-process forms
of the collectives and the table ops, on the CPU.

Two (and three) fresh interpreters join one gloo world through a
``FileStore`` under ``tmp_path`` (no port to race for), each driving one CPU
slot, and run the same seeded script; the parent runs the one-process
versions on a virtual mesh of as many CPU slots and holds every process's
results to them, bit for bit:

* ``process_all_gather`` gives every process's tensor in process order, and
  ``process_psum`` their left-to-right sum, as ``collectives.psum`` sums the
  same tensors in one process; ``process_broadcast`` gives the source's;
* ``mesh_sum`` over the whole pod and over a carve of two processes (the
  third never calls it);
* a dense table (hash-partitioned, each keyed push route) and a hash table
  sharded over the processes: the pulled rows, the whole table and the
  lookups are the one-process mesh's bytes (a ``-0.0`` included).

The half-configured launches fail with the reference's errors, held against
the reference's ``initialize_distributed`` on the same arguments.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from harmony_tpu_torch.parallel import collectives, multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 150


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# The script each process runs (and, given only the process count, the
# one-process versions over a virtual mesh of as many slots).
SCRIPT = r'''
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.parallel import collectives, multihost
from harmony_tpu_torch.parallel.mesh import DevicePool, build_mesh
from harmony_tpu_torch.table.hashtable import DeviceHashTable, HashTableSpec
from harmony_tpu_torch.table.table import DenseTable, TableSpec


def tensor_of(p):
    t = torch.from_numpy(np.random.default_rng(10 + p).standard_normal((5, 3)).astype(np.float32))
    t[0, 0] = -0.0
    return t


def hexes(x):
    return np.ascontiguousarray(x.numpy() if isinstance(x, torch.Tensor) else x).tobytes().hex()


def tables(slots):
    mesh = build_mesh(slots, data=1)
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.integers(0, 64, 40).astype(np.int32))
    deltas = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32))
    deltas[:3] = -0.0
    out = {}
    for via in ("scatter", "mxu", "sparse"):
        t = DenseTable(TableSpec(TableConfig(table_id=f"d-{via}", capacity=64, value_shape=(3,),
                                             num_blocks=8, is_ordered=False, update_fn="add")), mesh)
        t.apply_step(lambda a, k, d: (t.spec.push(a, k, d, via=via), None), keys, deltas)
        t.apply_step(lambda a, k, d: (t.spec.push(a, k, d, via=via), None), keys[:9], deltas[:9] * 3)
        out[f"dense-{via}-pull"] = hexes(t.multi_get(keys.numpy()))
        out[f"dense-{via}-all"] = hexes(t.pull_array())
    r = DenseTable(TableSpec(TableConfig(table_id="r", capacity=30, value_shape=(2,),
                                         num_blocks=6, update_fn="add")), mesh)
    r.write_all(torch.arange(60, dtype=torch.float32).reshape(30, 2) - 7.0)
    out["range-all"] = hexes(r.pull_array())
    h = DeviceHashTable(HashTableSpec(TableConfig(
        table_id="h", capacity=128, value_shape=(3,), num_blocks=4, is_ordered=False,
        update_fn="add", sparse=True)), mesh)
    hk = (keys.numpy() * 7 + 1).astype(np.int64)
    out["hash-dropped"] = h.multi_update(hk, deltas.numpy())
    out["hash-pull"] = hexes(h.multi_get_or_init(hk[::2]))
    out["hash-lookup"] = hexes(h.multi_get(np.concatenate([hk[:10], [999, 1001]])))
    return out


if len(sys.argv) == 2:   # the one-process versions, on a virtual mesh
    n = int(sys.argv[1])
    parts = [tensor_of(p) for p in range(n)]
    out = {"gather": [hexes(p) for p in parts],
           "psum": hexes(collectives.psum(parts, torch.device("cpu"))),
           "bcast": hexes(parts[n - 1]),
           "mesh_sum": float(sum(p + 1.0 for p in range(n))),
           "carve_sum": 10.0 * 1 + 10.0 * n}
    out.update(tables(DevicePool.virtual("cpu", n).slots))
    print("RESULT " + json.dumps(out))
    sys.exit(0)

store, n, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
assert multihost.initialize_distributed(store, n, pid, devices=["cpu"])
slots = multihost.global_slots()
out = {"pid": pid, "backend": multihost.backend(),
       "processes": [s.process_index for s in slots], "count": multihost.process_count(),
       "mesh_group": multihost.global_mesh().process_group() is multihost.group_of(range(n))}
t = tensor_of(pid)
out["gather"] = [hexes(p) for p in collectives.process_all_gather(t, range(n))]
out["psum"] = hexes(collectives.process_psum(t, range(n)))
out["bcast"] = hexes(collectives.process_broadcast(t, n - 1, range(n)))
out["mesh_sum"] = multihost.mesh_sum(multihost.global_mesh(), float(pid + 1))
carve = build_mesh([s for s in slots if s.process_index in (0, n - 1)], data=1)
if pid in (0, n - 1):
    out["carve_sum"] = multihost.mesh_sum(carve, 10.0 * (pid + 1))
out.update(tables(slots))
out["stats"] = dict(collectives.POD_STATS)
multihost.sync_global_devices()
multihost.shutdown_distributed()
print("RESULT " + json.dumps(out))
'''


def _result(out: str):
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert lines, out[-2000:]
    return json.loads(lines[-1][len("RESULT "):])


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", HARMONY_POD_UNIT_TIMEOUT="60")


@pytest.fixture(scope="module", params=[2, 3], ids=["2-processes", "3-processes"])
def pod_run(request, tmp_path_factory):
    """(the processes' results, the one-process results) of SCRIPT."""
    n = request.param
    store = tmp_path_factory.mktemp(f"store{n}") / "store"
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT, f"file://{store}", str(n), str(p)],
                              cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for p in range(n)]
    try:
        one = subprocess.run([sys.executable, "-c", SCRIPT, str(n)], cwd=REPO, env=_env(),
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
    return n, outs, _result(one.stdout)


def test_processes_join_one_gloo_world_with_the_global_slots(pod_run):
    n, outs, _ = pod_run
    for pid, out in enumerate(outs):
        assert out["pid"] == pid and out["count"] == n
        assert out["backend"] == "gloo"
        assert out["processes"] == list(range(n))
        assert out["mesh_group"]


def test_all_gather_psum_and_broadcast_are_the_one_process_bits(pod_run):
    n, outs, one = pod_run
    for out in outs:
        assert out["gather"] == one["gather"]
        assert out["psum"] == one["psum"]
        assert out["bcast"] == one["bcast"]
        assert out["stats"]["calls"] > 0 and out["stats"]["bytes_in"] > out["stats"]["bytes_out"]


def test_mesh_sum_over_the_pod_and_over_a_carve(pod_run):
    n, outs, one = pod_run
    for pid, out in enumerate(outs):
        assert out["mesh_sum"] == one["mesh_sum"]
        if pid in (0, n - 1):
            assert out["carve_sum"] == one["carve_sum"]
        else:
            assert "carve_sum" not in out


@pytest.mark.parametrize("key", [
    "dense-scatter-pull", "dense-scatter-all", "dense-mxu-pull", "dense-mxu-all",
    "dense-sparse-pull", "dense-sparse-all", "range-all", "hash-dropped", "hash-pull",
    "hash-lookup"])
def test_tables_over_processes_are_the_one_process_meshs_bytes(pod_run, key):
    _, outs, one = pod_run
    for out in outs:
        assert out[key] == one[key], key


def test_choose_backend_follows_the_topology():
    assert multihost.choose_backend([["cuda-a"], ["cuda-b"]]) == (
        "nccl", "each process drives cards of its own")
    assert multihost.choose_backend([["cuda-a"], ["cuda-a"]])[0] == "gloo"
    assert multihost.choose_backend([["cpu"], ["cpu"]])[0] == "gloo"
    assert multihost.choose_backend([["cuda-a", "cuda-b"], ["cuda-c"]])[0] == "nccl"


def test_outside_a_pod_the_runtime_is_one_process():
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    assert not multihost.is_multihost() and multihost.backend() is None
    t = torch.arange(4.0)
    assert collectives.process_all_gather(t, [0])[0] is t
    with pytest.raises(RuntimeError, match="not in a pod"):
        multihost.global_slots()


HALF = [
    pytest.param(dict(coordinator_address=None, num_processes=2, process_id=0),
                 id="no-coordinator"),
    pytest.param(dict(coordinator_address="127.0.0.1:1", num_processes=1, process_id=0),
                 id="one-process"),
    pytest.param(dict(coordinator_address="127.0.0.1:1", num_processes=2, process_id=None),
                 id="no-process-id"),
]


@pytest.mark.parametrize("kwargs", HALF)
def test_half_configured_launches_fail_as_the_references(kwargs, monkeypatch):
    from harmony_tpu.parallel import multihost as ref

    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(ref, "_initialized", False)
    with pytest.raises(ValueError, match="incomplete multi-host config") as want:
        ref.initialize_distributed(**kwargs)
    with pytest.raises(ValueError, match="incomplete multi-host config") as got:
        multihost.initialize_distributed(**kwargs)
    # the reference's words, torchrun's RANK in place of JAX_PROCESS_ID
    assert str(got.value).replace("RANK", "JAX_PROCESS_ID") == str(want.value)


def test_no_configuration_is_the_single_process_form_as_the_references(monkeypatch):
    from harmony_tpu.parallel import multihost as ref

    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(ref, "_initialized", False)
    assert ref.initialize_distributed() is False
    assert multihost.initialize_distributed() is False
