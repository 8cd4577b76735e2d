"""ctypes bindings for the native runtime pieces in ``harmony_native.cc``.

Counterpart of ``harmony_tpu/native/__init__.py``, with its own copy of the
C++ source beside this file. Lazy build at first use (``g++ -O3 -shared
-fPIC``) into ``harmony_tpu_torch/_build/``, named by a digest of the source
and flags so an edited source rebuilds, written under a temporary name and
renamed into place so processes building at once never load a half-written
library. Graceful degradation: every caller checks :func:`available` and
falls back to its pure-Python path, and ``HARMONY_TPU_NO_NATIVE=1`` disables
the native layer outright (for debugging or g++-less environments).

Surface (see harmony_native.cc for semantics):
  * crc32(bytes) -> int
  * parse_libsvm(text, num_features, base) -> (x [N,F] f32, y [N] f32)
  * blk_write(path, array) / blk_read(path) — CRC-checked block files for
    the checkpoint path (corrupt blocks raise BlockCorruptError on read); the
    same bytes as the reference's, for the same dtype codes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "harmony_native.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "_build")
_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

# numpy dtype <-> blk dtype codes: the reference's stable on-disk values
# (extend, never renumber). bfloat16 has no code: a bf16 block is refused.
_DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.uint8): 4,
    np.dtype(np.bool_): 5,
    np.dtype(np.float16): 6,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


class BlockCorruptError(IOError):
    """A block file failed its CRC32 check (torn write / bit rot)."""


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libharmony_native-{h.hexdigest()[:12]}.so")


def _build(lib: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *_FLAGS, "-o", tmp, _SRC, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("HARMONY_TPU_NO_NATIVE") == "1":
            return None
        if not os.path.exists(_SRC):
            return None
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.ht_crc32.restype = ctypes.c_uint32
        lib.ht_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.ht_parse_libsvm.restype = ctypes.c_int64
        lib.ht_parse_libsvm.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        lib.ht_blk_write.restype = ctypes.c_int32
        lib.ht_blk_write.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32, ctypes.c_int32,
        ]
        lib.ht_blk_write2.restype = ctypes.c_int32
        lib.ht_blk_write2.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.ht_blk_read.restype = ctypes.c_int64
        lib.ht_blk_read.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ht_prefetch_open.restype = ctypes.c_void_p
        lib.ht_prefetch_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.ht_prefetch_next.restype = ctypes.c_int64
        lib.ht_prefetch_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ]
        lib.ht_prefetch_buf_free.restype = None
        lib.ht_prefetch_buf_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.ht_prefetch_close.restype = None
        lib.ht_prefetch_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is (buildable and) loaded."""
    return _load() is not None


def crc32(data: bytes) -> int:
    lib = _load()
    if lib is None:
        import zlib

        return zlib.crc32(data) & 0xFFFFFFFF
    return int(lib.ht_crc32(data, len(data)))


def parse_libsvm(
    text: str | bytes, num_features: int, base: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Parse LibSVM records (newline-separated) into dense (x, y). Native
    only — callers must gate on :func:`available`."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    buf = text.encode() if isinstance(text, str) else bytes(text)
    # Upper bound on rows = number of newline-terminated segments.
    max_rows = buf.count(b"\n") + 1
    x = np.zeros((max_rows, num_features), np.float32)
    y = np.zeros((max_rows,), np.float32)
    n = lib.ht_parse_libsvm(
        buf, len(buf), num_features, base,
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_rows,
    )
    if n == -2:
        raise ValueError("malformed libsvm record (bad label or token)")
    if n < 0:
        raise ValueError("libsvm parse overflow (row bound miscounted)")
    return x[:n], y[:n]


def blk_write(path: str, arr: np.ndarray, level: int = 1) -> None:
    """Write an array as a CRC-checked block file.

    ``level``: zlib compression 1..9 for the v2 format (payload stored raw
    when incompressible); 0 writes the uncompressed v1 format. Compression
    exists for the durable-commit leg — a checkpoint block crosses the
    network twice in the two-stage protocol (temp -> object store)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    a = np.ascontiguousarray(arr)
    code = _DTYPE_CODES.get(a.dtype)
    if code is None:
        raise TypeError(f"unsupported block dtype {a.dtype}")
    shape = (ctypes.c_uint64 * max(a.ndim, 1))(*(a.shape or (0,)))
    if level > 0:
        rc = lib.ht_blk_write2(
            path.encode(), a.ctypes.data_as(ctypes.c_void_p), a.nbytes,
            shape, a.ndim, code, level,
        )
    else:
        rc = lib.ht_blk_write(
            path.encode(), a.ctypes.data_as(ctypes.c_void_p), a.nbytes,
            shape, a.ndim, code,
        )
    if rc != 0:
        raise IOError(f"blk_write({path}) failed: rc={rc}")


def _py_blk_read(path: str) -> np.ndarray:
    """Pure-Python .blk reader (v1 + compressed v2, zlib CRC) so
    checkpoints written with the native codec restore in g++-less
    environments."""
    import struct
    import zlib

    # torn/garbled container state raises BlockCorruptError (matching the
    # native reader's rc=-4 mapping) — corruption must never be
    # misclassified as transient IO, or the chain-fallback recovery path
    # retries it instead of quarantining
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12:
            raise BlockCorruptError(f"blk_read({path}): truncated header")
        magic, dtype_code, ndim = struct.unpack("<III", head)
        if magic not in (0x48544231, 0x48544232) or ndim > 8:
            raise BlockCorruptError(f"blk_read({path}): bad magic/ndim")
        shape_bytes = f.read(8 * ndim)
        if len(shape_bytes) < 8 * ndim:
            raise BlockCorruptError(f"blk_read({path}): truncated header")
        shape = struct.unpack(f"<{ndim}Q", shape_bytes) if ndim else ()
        raw_n = comp_n = None
        if magic == 0x48544232:
            sizes = f.read(16)
            if len(sizes) < 16:
                raise BlockCorruptError(
                    f"blk_read({path}): truncated header")
            raw_n, comp_n = struct.unpack("<QQ", sizes)
            # bound header-carried sizes before allocating from them (a
            # corrupt raw_n must not drive an unbounded decompress buffer)
            if comp_n > raw_n or (comp_n != raw_n
                                  and raw_n > comp_n * 1032 + 1024):
                raise BlockCorruptError(
                    f"blk_read({path}): implausible size header")
        rest = f.read()
    if len(rest) < 4:
        raise BlockCorruptError(f"blk_read({path}): truncated payload")
    payload, crc_stored = rest[:-4], struct.unpack("<I", rest[-4:])[0]
    if comp_n is not None and comp_n != raw_n:
        if len(payload) != comp_n:
            raise BlockCorruptError(f"blk_read({path}): truncated payload")
        try:
            payload = zlib.decompress(payload, bufsize=raw_n)
        except zlib.error as e:
            raise BlockCorruptError(f"corrupt block {path}: {e}") from None
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc_stored:
        raise BlockCorruptError(f"CRC mismatch reading {path}")
    if dtype_code not in _CODE_DTYPES:
        raise IOError(f"blk_read({path}): unknown dtype code {dtype_code}")
    return np.frombuffer(payload, dtype=_CODE_DTYPES[dtype_code]).reshape(shape).copy()


def blk_read(path: str) -> np.ndarray:
    """Read a block file, verifying its checksum. Works without the native
    library (pure-Python fallback) — .blk checkpoints are portable."""
    lib = _load()
    if lib is None:
        return _py_blk_read(path)
    shape = (ctypes.c_uint64 * 8)()
    ndim = ctypes.c_int32()
    dtype = ctypes.c_int32()
    nbytes = lib.ht_blk_read(path.encode(), None, 0, shape, ctypes.byref(ndim),
                             ctypes.byref(dtype))
    if nbytes == -4:  # bad magic / truncated header — a torn file
        raise BlockCorruptError(f"corrupt block {path} (torn header)")
    if nbytes < 0:
        raise IOError(f"blk_read({path}) metadata failed: rc={nbytes}")
    if dtype.value not in _CODE_DTYPES:
        raise IOError(f"blk_read({path}): unknown dtype code {dtype.value}")
    out = np.empty((nbytes,), np.uint8)
    rc = lib.ht_blk_read(
        path.encode(), out.ctypes.data_as(ctypes.c_void_p), nbytes,
        shape, ctypes.byref(ndim), ctypes.byref(dtype),
    )
    if rc in (-4, -6, -8):  # torn header / CRC mismatch / failed inflate
        raise BlockCorruptError(f"corrupt block {path} (rc={rc})")
    if rc < 0:
        raise IOError(f"blk_read({path}) failed: rc={rc}")
    shp = tuple(shape[i] for i in range(ndim.value))
    return out.view(_CODE_DTYPES[dtype.value]).reshape(shp)
