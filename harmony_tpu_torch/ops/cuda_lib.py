"""Build and load the port's hand-written CUDA kernels (``harmony_tpu_torch/csrc``).

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a shared
library of its own with a plain C interface, at first use, into
``harmony_tpu_torch/_build/``, and loads with ``ctypes``. A library's file name
carries a digest of its sources and flags, so an edited kernel rebuilds and a
stale one is never loaded. :func:`build` starts one ``nvcc`` per source, all at
once, and waits for them; nothing builds when this module is imported.

Every entry point takes device pointers, sizes and a ``cudaStream_t``, launches
on that stream without synchronising, and returns ``cudaGetLastError()`` as an
int; :func:`launch` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# entry point -> (source stem, argtypes). Pointers and the stream are c_void_p:
# left undeclared, ctypes would pass them as 32-bit ints and cut them.
SIGNATURES = {
    "harmony_gather_rows": ("gather_rows", [_P, _P, _P, _LL, _LL, _LL, _I, _P]),
    "harmony_segment_sum_rows": ("keyed_fold", [_P, _P, _P, _LL, _LL, _LL, _P]),
    "harmony_weighted_histogram": (
        "keyed_fold", [_P, _I, _P, _P, _LL, _LL, _LL, _P]),
    "harmony_flash_forward": (
        "flash_attention", [_P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _F, _I, _P]),
    "harmony_flash_backward_dkv": (
        "flash_attention", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _F, _I, _P]),
    "harmony_flash_backward_dq": (
        "flash_attention", [_P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _F, _I, _P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Stems of every kernel source."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(stem: str) -> Path:
    """Where ``csrc/<stem>.cu`` builds to, named by a digest of the source, the
    shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC_DIR / f"{stem}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:12]}.so"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA toolkit "
            "is installed")
    return found


def nvcc_command(stem: str, out: Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{stem}.cu")]


def build(stems: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every source (or ``stems``) whose library is missing, one ``nvcc``
    per source, all started together; raise with the compiler's output if one
    fails. Returns stem -> library path. The compiler's report (registers,
    shared memory, spills from ``-Xptxas -v``) is kept beside each library as
    ``.log``."""
    stems = list(stems) if stems is not None else sources()
    BUILD_DIR.mkdir(exist_ok=True)
    running = []
    try:
        for stem in stems:
            out = library_path(stem)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                nvcc_command(stem, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            running.append((stem, proc, tmp, out))
        failed = []
        for stem, proc, tmp, out in running:
            report, _ = proc.communicate()
            out.with_suffix(".log").write_text(report)
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {stem}.cu:\n{report}")
            else:
                os.replace(tmp, out)  # atomic: a reader never sees half a library
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, proc, tmp, _ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return {stem: library_path(stem) for stem in stems}


def build_reports() -> Dict[str, str]:
    """The compiler's report for each built source (empty before a build)."""
    out = {}
    for stem in sources():
        log = library_path(stem).with_suffix(".log")
        if log.exists():
            out[stem] = log.read_text()
    return out


def _library(stem: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            path = build([stem])[stem]
            lib = ctypes.CDLL(str(path))
            lib.harmony_cuda_error_string.argtypes = [_I]
            lib.harmony_cuda_error_string.restype = ctypes.c_char_p
            for name, (src, argtypes) in SIGNATURES.items():
                if src == stem:
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = _I
            _libs[stem] = lib
        return lib


def launch(name: str, *args) -> None:
    """Call entry point ``name`` (building its library on first use) and raise if
    it returns a CUDA error: a refused launch never runs, and a later
    synchronise would not report it."""
    lib = _library(SIGNATURES[name][0])
    err = getattr(lib, name)(*args)
    if err != 0:
        text = lib.harmony_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")
