"""harmony_tpu_torch.ops against harmony_tpu.ops on the CPU.

The port's kernel wrappers take their plain PyTorch versions for CPU tensors;
each is held against the JAX function on the same numpy inputs, on its CPU
route: gather_rows (K1) and segment_sum_rows (K2, the jnp route) from
harmony_tpu.ops.sparse, weighted_histogram / segment_sum (K3, the one-hot
matmul) from harmony_tpu.ops.histogram.

Tolerances: gathers are exact (bytes are copied), and so are folds of
integer-valued rows (every partial sum is an integer below 2**24). Folds of
float rows differ only in the order of their f32 additions, so two results
lie within 2 * (n - 1) * 2**-24 * sum(|x|) of each other for a row that
receives n terms.
"""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.ops import histogram as jax_histogram
from harmony_tpu.ops import sparse as jax_sparse
from harmony_tpu_torch.ops import cuda_lib
from harmony_tpu_torch.ops.histogram import segment_sum, weighted_histogram
from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows, value_width
from harmony_tpu_torch.utils.platform import use_kernel

U_F32 = 2.0 ** -24


def _ids(rng, n, num_rows, kind):
    if kind == "in_range":
        return rng.integers(0, num_rows, size=n).astype(np.int32)
    if kind == "out_of_range":   # negatives and ids past the end, mixed in
        return rng.integers(-num_rows, 2 * num_rows, size=n).astype(np.int32)
    if kind == "duplicates":     # every id many times over
        return rng.integers(0, 4, size=n).astype(np.int32)
    raise ValueError(kind)


def _fold_bound(x, ids, num_rows):
    """2 * (n - 1) * U * sum(|x|) per destination row (ids out of range drop)."""
    ok = (ids >= 0) & (ids < num_rows)
    abs_sum = np.zeros((num_rows, x.shape[1]))
    np.add.at(abs_sum, ids[ok], np.abs(x[ok]).astype(np.float64))
    count = np.bincount(ids[ok], minlength=num_rows)[:, None]
    return 2.0 * np.maximum(count - 1, 0) * U_F32 * abs_sum


ID_KINDS = ["in_range", "out_of_range", "duplicates"]
WIDTHS = [1, 17, 128]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", ID_KINDS)
def test_gather_rows_matches_jax(kind, width, dtype):
    rng = np.random.default_rng(width)
    R, N = 97, 300
    table = rng.standard_normal((R, width)).astype(np.float32)
    idx = _ids(rng, N, R, kind)
    want = np.asarray(jax_sparse.gather_rows(
        jnp.asarray(table, dtype=getattr(jnp, dtype)), jnp.asarray(idx)))
    before = gather_rows.launches
    got = gather_rows(torch.as_tensor(table).to(getattr(torch, dtype)),
                      torch.as_tensor(idx))
    assert gather_rows.launches == before  # a CPU tensor takes the plain version
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    got_bits = got.view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy()
    assert got.shape == (N, width)
    np.testing.assert_array_equal(got_bits.view(bits), want.view(bits))


def test_gather_rows_empty_ids():
    table = torch.ones((5, 3))
    assert gather_rows(table, torch.zeros((0,), dtype=torch.int32)).shape == (0, 3)


@pytest.mark.parametrize("integer_valued", [True, False])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", ID_KINDS)
def test_segment_sum_rows_matches_jax(kind, width, integer_valued):
    rng = np.random.default_rng(100 + width)
    num_rows, N = 61, 400
    idx = _ids(rng, N, num_rows, kind)
    x = (rng.integers(-8, 9, size=(N, width)) if integer_valued
         else rng.standard_normal((N, width))).astype(np.float32)
    # the jnp route (sparse.py:170-174): the Pallas body no longer traces on
    # the installed jax, and off a TPU the reference takes this route anyway
    want = np.asarray(jax_sparse.segment_sum_rows(
        jnp.asarray(x), jnp.asarray(idx), num_rows, interpret=False))
    before = segment_sum_rows.launches
    got = segment_sum_rows(torch.as_tensor(x), torch.as_tensor(idx), num_rows).numpy()
    assert segment_sum_rows.launches == before
    assert got.shape == (num_rows, width) and got.dtype == np.float32
    if integer_valued:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= _fold_bound(x, idx, num_rows))


@pytest.mark.parametrize("integer_valued", [True, False])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", ID_KINDS)
def test_weighted_histogram_matches_jax(kind, width, integer_valued):
    rng = np.random.default_rng(200 + width)
    num_bins, N = 53, 400
    ids = _ids(rng, N, num_bins, kind)
    w = (rng.integers(-8, 9, size=(N, width)) if integer_valued
         else rng.standard_normal((N, width))).astype(np.float32)
    want = np.asarray(jax_histogram.weighted_histogram(
        jnp.asarray(ids), jnp.asarray(w), num_bins))
    before = weighted_histogram.launches
    got = weighted_histogram(torch.as_tensor(ids), torch.as_tensor(w), num_bins).numpy()
    assert weighted_histogram.launches == before
    assert got.shape == (num_bins, width) and got.dtype == np.float32
    if integer_valued:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= _fold_bound(w, ids, num_bins))


def test_weighted_histogram_accumulates_bf16_in_f32():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 7, size=500).astype(np.int32)
    w = rng.integers(-4, 5, size=(500, 3)).astype(np.float32)
    want = np.asarray(jax_histogram.weighted_histogram(
        jnp.asarray(ids), jnp.asarray(w, dtype=jnp.bfloat16), 7))
    got = weighted_histogram(torch.as_tensor(ids),
                             torch.as_tensor(w).to(torch.bfloat16), 7)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("vector", [False, True])
def test_segment_sum_matches_jax(vector):
    rng = np.random.default_rng(4)
    seg = rng.integers(-2, 12, size=64).astype(np.int32)
    data = rng.integers(-8, 9, size=(64, 5) if vector else (64,)).astype(np.float32)
    want = np.asarray(jax_histogram.segment_sum(jnp.asarray(data), jnp.asarray(seg), 10))
    got = segment_sum(torch.as_tensor(data), torch.as_tensor(seg), 10).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_shape_errors_and_value_width():
    with pytest.raises(ValueError):
        gather_rows(torch.ones(4), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        segment_sum_rows(torch.ones((3, 2)), torch.zeros(4, dtype=torch.int32), 5)
    with pytest.raises(ValueError):
        weighted_histogram(torch.zeros(4, dtype=torch.int32), torch.ones((3, 2)), 5)
    for shape in [(), (17,), (2, 3)]:
        assert value_width(shape) == jax_sparse.value_width(shape)


def test_kernel_route_follows_the_tensor_device():
    cpu = torch.ones(2)
    assert use_kernel(cpu, cpu) is False
    with pytest.raises(ValueError):
        use_kernel(torch.ones(2, device="meta"))
    with pytest.raises(ValueError):
        use_kernel(cpu, torch.ones(2, device="meta"))


_CTYPE_OF = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


@pytest.mark.parametrize("entry", sorted(cuda_lib.SIGNATURES))
def test_ctypes_signatures_match_the_cuda_sources(entry):
    """Each entry point's ctypes argtypes agree with its C declaration: a
    pointer or stream is c_void_p (a 32-bit int would cut it), an int c_int,
    a long long c_longlong. Read from the source; nothing is compiled here."""
    stem, argtypes = cuda_lib.SIGNATURES[entry]
    src = (cuda_lib.CSRC_DIR / f"{stem}.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m, f"{entry} not declared in {stem}.cu"
    expected = [
        ctypes.c_void_p if ("*" in p or "cudaStream_t" in p)
        else _CTYPE_OF[" ".join(p.split()[:-1])]
        for p in m.group(1).split(",")
    ]
    assert list(argtypes) == expected


def test_build_targets_hopper_and_names_libraries_by_content(monkeypatch):
    monkeypatch.setattr(cuda_lib, "nvcc", lambda: "nvcc")
    cmd = cuda_lib.nvcc_command("gather_rows", Path("/x.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cuda_lib.sources() == ["flash_attention", "gather_rows", "keyed_fold"]
    a, b = (cuda_lib.library_path(s) for s in ("gather_rows", "keyed_fold"))
    assert a.parent == cuda_lib.BUILD_DIR and a != b
    assert cuda_lib.library_path("gather_rows") == a  # stable for the same source
