"""Every kernel launch of harmony_tpu_torch runs under its operands' device.

A kernel launch goes to the CUDA current device, whatever card its operands
lie on, and the fold and the flash kernels set their shared-memory attribute
for the current device. So every call of ``cuda_lib.launch`` must sit inside
a ``with torch.cuda.device(...)`` block (the wrappers pass their operands'
``get_device()``). A CPU tensor never reaches ``cuda_lib.launch``, so this
reads the source with ``ast``; ``chip_smoke.py``'s phase 3t (e) checks the
bytes on two cards. The test also holds the wrappers' refusal of operands
on two devices.
"""
import ast
import pathlib

import pytest
import torch

import harmony_tpu_torch
from harmony_tpu_torch.ops.histogram import weighted_histogram
from harmony_tpu_torch.ops.sparse import segment_sum_rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PACKAGE = pathlib.Path(harmony_tpu_torch.__file__).resolve().parent


def _is_launch(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == "launch"
            and isinstance(f.value, ast.Name) and f.value.id == "cuda_lib")


def _is_device_guard(item: ast.withitem) -> bool:
    c = item.context_expr
    return (isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
            and c.func.attr == "device" and ast.unparse(c.func.value) == "torch.cuda")


def _unguarded_launches(tree: ast.AST):
    """Launch calls with no enclosing ``with torch.cuda.device(...)``, and
    the functions that hold them; a helper that enters the guard and calls
    the launch inside it counts as guarded."""
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_launch(node)):
            continue
        p, guarded, func = parents.get(node), False, None
        while p is not None:
            if isinstance(p, ast.With) and any(_is_device_guard(i) for i in p.items):
                guarded = True
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)) and func is None:
                func = p.name
            p = parents.get(p)
        if not guarded:
            out.append((func, node.lineno))
    return out


def test_every_launch_in_the_package_runs_under_a_device_guard():
    launches, unguarded = 0, {}
    for path in sorted(PACKAGE.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        launches += sum(1 for n in ast.walk(tree)
                        if isinstance(n, ast.Call) and _is_launch(n))
        bad = _unguarded_launches(tree)
        if bad:
            unguarded[str(path.relative_to(PACKAGE))] = bad
    assert not unguarded, f"cuda_lib.launch outside torch.cuda.device: {unguarded}"
    # K1, K2, K3 and the six flash entry points
    assert launches == 9


def test_the_check_finds_an_unguarded_launch():
    bare = ast.parse("def f(t):\n    cuda_lib.launch('x', t.data_ptr())\n")
    guarded = ast.parse(
        "def f(t):\n    with torch.cuda.device(t.get_device()):\n"
        "        cuda_lib.launch('x', t.data_ptr())\n")
    other = ast.parse(
        "def f(t):\n    with torch.cuda.stream(s):\n        cuda_lib.launch('x')\n")
    assert _unguarded_launches(bare) == [("f", 2)]
    assert _unguarded_launches(guarded) == []
    assert _unguarded_launches(other) == [("f", 3)]


@pytest.mark.parametrize("wrapper", ["fold", "histogram"])
def test_operands_on_two_devices_are_refused(wrapper):
    """Operands on two devices raise, naming both, before any launch
    (``meta`` stands for a second device here)."""
    ids = torch.zeros(4, dtype=torch.int32)
    w = torch.zeros((4, 3), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="different devices: (cpu and meta|meta and cpu)"):
        if wrapper == "fold":
            segment_sum_rows(w, ids, 5)
        else:
            weighted_histogram(ids, w, 5)
