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
receives n terms. The port's plain folds add in index order from 0.0, the
contract its CUDA fold keeps on the card, and are held bit for bit to a
plain numpy loop that does the same.
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
from harmony_tpu_torch.ops import sparse as torch_sparse
from harmony_tpu_torch.ops.histogram import (
    segment_sum,
    weighted_histogram,
    weighted_histogram_plain,
)
from harmony_tpu_torch.ops.sparse import (
    gather_rows,
    segment_sum_rows,
    segment_sum_rows_plain,
    value_width,
)
from harmony_tpu_torch.utils.platform import use_kernel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@pytest.mark.parametrize("dtype,elem_bytes", [
    (torch.float32, 4), (torch.int32, 4),        # LDA's local table is int32
    (torch.bfloat16, 2), (torch.float16, 2),
    (torch.float64, TypeError), (torch.int64, TypeError), (torch.uint8, TypeError),
])
def test_gather_rows_launches_k1_on_any_two_or_four_byte_table(monkeypatch, dtype,
                                                                elem_bytes):
    """K1's wiring without a card: with use_kernel forced True, a table of 2- or
    4-byte elements launches harmony_gather_rows once, with its element size
    and as many arguments as its SIGNATURES row declares; 1- and 8-byte
    elements raise and launch nothing."""
    calls = []
    monkeypatch.setattr(torch_sparse, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(torch_sparse, "_stream", lambda t: 0)
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *args: calls.append((name, args)))
    table = torch.zeros((6, 5), dtype=dtype)
    idx = torch.tensor([0, 5, 2], dtype=torch.int32)
    launches = gather_rows.launches
    if not isinstance(elem_bytes, int):
        with pytest.raises(elem_bytes, match="2- or 4-byte"):
            gather_rows(table, idx)
        assert calls == [] and gather_rows.launches == launches
        return
    out = gather_rows(table, idx)
    assert [name for name, _ in calls] == ["harmony_gather_rows"]
    args = calls[0][1]
    assert len(args) == len(cuda_lib.SIGNATURES["harmony_gather_rows"][1])
    assert args[3:7] == (6, 5, 3, elem_bytes)    # R, W, N, element bytes
    assert out.shape == (3, 5) and out.dtype == dtype
    assert gather_rows.launches == launches + 1


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
    assert cuda_lib.sources() == [
        "flash_attention", "flash_attention_mma", "gather_rows", "keyed_fold"]
    a, b = (cuda_lib.library_path(s) for s in ("gather_rows", "keyed_fold"))
    assert a.parent == cuda_lib.BUILD_DIR and a != b
    assert cuda_lib.library_path("gather_rows") == a  # stable for the same source


def _fold_in_index_order(x, ids, num_rows):
    """A plain f32 loop: out[ids[i]] = out[ids[i]] + x[i] for i in index order,
    from 0.0; ids out of range add nothing."""
    out = np.zeros((num_rows, x.shape[1]), dtype=np.float32)
    for i, k in enumerate(ids):
        if 0 <= k < num_rows:
            out[k] = out[k] + x[i]  # f32 + f32 -> f32, rounded each add
    return out


def _slice_like_ids(rng, n, num_rows):
    """Ids like the Wide&Deep slice's, with duplicates, negatives and ids at or
    past num_rows mixed in."""
    ids = rng.integers(0, num_rows, size=n)
    hot = rng.random(n) < 0.25
    ids[hot] = rng.integers(0, 6, size=int(hot.sum()))
    bad = rng.random(n) < 0.1
    ids[bad] = rng.choice([-1, -7, num_rows, num_rows + 3], size=int(bad.sum()))
    return ids.astype(np.int32)


FOLD_IDS = ["slice_like", "one_row"]


@pytest.mark.parametrize("ids_kind", FOLD_IDS)
@pytest.mark.parametrize("width", [1, 17, 40])
@pytest.mark.parametrize("fold", ["segment_sum_rows", "weighted_histogram_f32",
                                  "weighted_histogram_bf16"])
def test_plain_folds_add_in_index_order_bit_for_bit(fold, width, ids_kind):
    """The card's fold is held to the CPU's plain version bit for bit
    (chip_smoke.py phase 2); this holds the plain version to index order."""
    rng = np.random.default_rng(7 + width)
    num_rows, n = 97, 600
    ids = (_slice_like_ids(rng, n, num_rows) if ids_kind == "slice_like"
           else np.zeros(n, dtype=np.int32))
    x = rng.standard_normal((n, width)).astype(np.float32) * rng.uniform(0.01, 100, (n, 1))
    x = x.astype(np.float32)
    if fold == "segment_sum_rows":
        got = segment_sum_rows_plain(torch.as_tensor(x), torch.as_tensor(ids), num_rows)
        xs = x
    else:
        w = torch.as_tensor(x)
        if fold.endswith("bf16"):
            w = w.to(torch.bfloat16)
        xs = w.float().numpy()
        got = weighted_histogram_plain(torch.as_tensor(ids), w, num_rows)
    want = _fold_in_index_order(xs, ids, num_rows)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.fixture
def fake_scratch_ints(monkeypatch):
    """``cuda_lib.call`` answering harmony_fold_scratch_ints with a set count
    (or a set error code), as the library would, without a card."""
    answer = {"ints": 0, "rc": 0}

    def call(name, n, width, num_rows, out):
        assert name == "harmony_fold_scratch_ints"
        out._obj.value = answer["ints"]
        return answer["rc"]

    torch_sparse.fold_scratch_ints.cache_clear()
    monkeypatch.setattr(cuda_lib, "call", call)
    yield answer
    torch_sparse.fold_scratch_ints.cache_clear()


@pytest.mark.parametrize("n, width, num_rows, ints", [
    (1, 1, 1, 7), (67480, 17, 102144, 390409), (600, 17, 97, 3000), (5, 3, 1, 100),
    (4096, 300, 5000, 20000), (10, 1, 3, 41), (300000, 3, 102144, 10 ** 6), (8, 2, 2, 1),
])
def test_fold_buffers_put_the_scratch_after_the_output(fake_scratch_ints, n, width,
                                                       num_rows, ints):
    fake_scratch_ints["ints"] = ints
    out, scratch = torch_sparse.fold_buffers(n, width, num_rows, torch.device("cpu"))
    assert out.shape == (num_rows, width) and out.dtype == torch.float32
    assert out.is_contiguous() and out.storage_offset() == 0
    end_of_out = out.data_ptr() + 4 * num_rows * width
    assert scratch % 16 == 0 and end_of_out <= scratch < end_of_out + 16
    storage = out.untyped_storage()
    assert scratch + 4 * ints == storage.data_ptr() + storage.nbytes()


def test_fold_scratch_ints_raises_where_the_library_refuses(fake_scratch_ints):
    fake_scratch_ints["rc"] = 1  # cudaErrorInvalidValue
    with pytest.raises(ValueError, match="does not take 10 ids of width 3000000"):
        torch_sparse.fold_scratch_ints(10, 3_000_000, 5)


class _FakeEntry:
    def __init__(self, rc):
        self.rc, self.calls = rc, 0

    def __call__(self, *args):
        self.calls += 1
        return self.rc


class _FakeLibrary:
    def __init__(self, rc):
        self.harmony_gather_rows = _FakeEntry(rc)

    @staticmethod
    def harmony_cuda_error_string(err):
        return b"an illegal memory access was encountered"


def test_launch_raises_with_the_cuda_error_string(monkeypatch):
    monkeypatch.setattr(cuda_lib, "_entries", {})
    monkeypatch.setattr(cuda_lib, "_library", lambda stem: _FakeLibrary(700))
    with pytest.raises(RuntimeError) as info:
        cuda_lib.launch("harmony_gather_rows", 1, 2, 3)
    assert str(info.value) == (
        "harmony_gather_rows: CUDA error 700 (an illegal memory access was encountered)")


def test_launch_binds_each_entry_point_once(monkeypatch):
    libs = []

    def library(stem):
        libs.append(_FakeLibrary(0))
        return libs[-1]

    monkeypatch.setattr(cuda_lib, "_entries", {})
    monkeypatch.setattr(cuda_lib, "_library", library)
    cuda_lib.launch("harmony_gather_rows", 1)
    first = cuda_lib.entry("harmony_gather_rows")
    cuda_lib.launch("harmony_gather_rows", 2)
    assert len(libs) == 1  # loaded (and bound) on the first launch only
    assert cuda_lib.entry("harmony_gather_rows") is first
    assert first.calls == 2  # the same function object took both launches
    assert cuda_lib.call("harmony_gather_rows", 3) == 0  # and takes a call as is
    assert first.calls == 3 and len(libs) == 1
