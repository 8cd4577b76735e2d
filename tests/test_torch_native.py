"""harmony_tpu_torch's block codec (``native/``) against harmony_tpu's.

Both packages build the same C++ source (each its own copy), so a block file
must come out byte for byte the same for every dtype code, in the
uncompressed v1 format and the zlib v2 format, and each package must read the
other's files. A torn header, a CRC mismatch and a truncated v2 payload are
corruption (``BlockCorruptError``), never a transient I/O error. Exact
comparisons throughout: the codec moves bytes.
"""
import os
import struct
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from harmony_tpu import native as ref_native
from harmony_tpu_torch import native
from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.table.table import DenseTable, TableSpec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the suite runs beside other workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_, np.float16]


def reference_codec_built() -> bool:
    """The reference's loader builds its library in place, so a process that
    loads it while another test process is still building it finds a partial
    file and marks the codec unavailable; probe again until the build is
    done."""
    for _ in range(100):
        if ref_native.available():
            return True
        ref_native._tried = False
        time.sleep(0.2)
    return False


@pytest.fixture(scope="module", autouse=True)
def codecs_built():
    assert native.available(), "the port's native codec did not build"
    assert reference_codec_built(), "the reference's native codec did not build"


def _block(dtype, shape=(37, 5), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if np.issubdtype(dtype, np.integer):
        return rng.integers(0, 100, size=shape).astype(dtype)
    # a compressible block: repeated rows, so the v2 format really deflates
    row = rng.normal(size=shape[1:]).astype(dtype)
    return np.broadcast_to(row, shape).copy()


def _read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_dtype_codes_are_the_references():
    assert native._DTYPE_CODES == ref_native._DTYPE_CODES


@pytest.mark.parametrize("level", [0, 1], ids=["v1", "v2"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_blk_write_bytes_match_the_reference(tmp_path, dtype, level):
    arr = _block(dtype)
    ours, theirs = str(tmp_path / "ours.blk"), str(tmp_path / "theirs.blk")
    native.blk_write(ours, arr, level=level)
    ref_native.blk_write(theirs, arr, level=level)
    assert _read_bytes(ours) == _read_bytes(theirs)
    magic = struct.unpack("<I", _read_bytes(ours)[:4])[0]
    assert magic == (0x48544231 if level == 0 else 0x48544232)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_each_package_reads_the_others_blocks(tmp_path, dtype):
    arr = _block(dtype, seed=1)
    ours, theirs = str(tmp_path / "ours.blk"), str(tmp_path / "theirs.blk")
    native.blk_write(ours, arr)
    ref_native.blk_write(theirs, arr)
    for got in (native.blk_read(theirs), native._py_blk_read(theirs),
                ref_native.blk_read(ours), ref_native._py_blk_read(ours)):
        assert got.dtype == arr.dtype and got.shape == arr.shape
        np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("level", [0, 1], ids=["v1", "v2"])
def test_py_reader_reads_native_blocks(tmp_path, level):
    arr = _block(np.float32, shape=(64, 3), seed=2)
    path = str(tmp_path / "b.blk")
    native.blk_write(path, arr, level=level)
    np.testing.assert_array_equal(native._py_blk_read(path), arr)


def _corrupt_cases(tmp_path):
    arr = _block(np.float32, shape=(64, 8), seed=3)
    path = str(tmp_path / "b.blk")
    native.blk_write(path, arr, level=1)
    raw = _read_bytes(path)
    yield "torn header", raw[:10]
    flipped = bytearray(raw)
    flipped[-5] ^= 0xFF                     # a payload byte: CRC mismatch
    yield "crc mismatch", bytes(flipped)
    head = 12 + 8 * 2 + 16                  # magic, dtype, ndim, shape, sizes
    yield "truncated v2 payload", raw[: head + (len(raw) - head) // 2]


@pytest.mark.parametrize("reader", ["native", "python"])
def test_corrupt_blocks_raise_block_corrupt_error(tmp_path, reader):
    read = native.blk_read if reader == "native" else native._py_blk_read
    for what, data in _corrupt_cases(tmp_path):
        path = str(tmp_path / f"{what.replace(' ', '_')}.blk")
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(native.BlockCorruptError):
            read(path)
        # the reference classifies the same bytes the same way
        with pytest.raises(ref_native.BlockCorruptError):
            ref_native.blk_read(path)


def test_crc32_matches_zlib_and_the_reference():
    import zlib

    data = os.urandom(4097)
    assert native.crc32(data) == ref_native.crc32(data) == zlib.crc32(data) & 0xFFFFFFFF


def test_bfloat16_blocks_are_refused_as_the_reference_refuses_them(tmp_path):
    bf = np.ones((4, 2), ml_dtypes.bfloat16)
    with pytest.raises(TypeError):
        ref_native.blk_write(str(tmp_path / "r.blk"), bf)
    with pytest.raises(TypeError):
        native.blk_write(str(tmp_path / "p.blk"), bf)
    table = DenseTable(TableSpec(TableConfig(table_id="bf", capacity=8, value_shape=(2,),
                                             num_blocks=2, dtype="bfloat16")), "cpu")
    with pytest.raises(TypeError, match="bfloat16"):
        table.snapshot_blocks().to_host()
    assert table.array.dtype == torch.bfloat16
