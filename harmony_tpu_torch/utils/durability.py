"""Directory-entry durability for the control plane's rename and create
paths.

A copy of ``harmony_tpu/utils/durability.py`` (which imports no JAX; the
port keeps its own copy). ``fsync(file)`` makes the *bytes* durable; the
*name* (a freshly created file, or an ``os.replace`` landing) lives in the
parent directory and needs its own fsync, or a host crash can resurrect the
old view. The HA log's record stream survives this because the file is
created once and only ever appended; the lease file is *replaced* on every
write and needs the parent pinned.
"""
from __future__ import annotations

import os


def fsync_dir(path: str) -> bool:
    """fsync the directory ``path`` (or the parent directory of a file
    path). True when the sync happened; False on platforms or filesystems
    that refuse an O_RDONLY directory fd (the write paths treat that as
    best effort, never fatal)."""
    d = path if os.path.isdir(path) else (os.path.dirname(path) or ".")
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return False
    try:
        os.fsync(fd)
        return True
    except OSError:
        return False
    finally:
        os.close(fd)
