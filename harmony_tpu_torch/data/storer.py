"""DataStorer — write job results to durable storage.

Counterpart of ``harmony_tpu/data/storer.py``, copied.

Parity with the reference's datastorer (SURVEY.md §2.9: ``DataStorer`` SPI +
``HdfsDataStorer``, common/.../datastorer/, 195 LoC): trainers/apps persist
final models or outputs to a durable path at job end. The durable target
here is a posix directory (a GCS bucket mounts the same way on TPU VMs).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict

import numpy as np


class DataStorer:
    def store_array(self, rel_path: str, arr: np.ndarray) -> str:
        raise NotImplementedError

    def store_json(self, rel_path: str, obj: Dict[str, Any]) -> str:
        raise NotImplementedError

    def store_text(self, rel_path: str, text: str) -> str:
        raise NotImplementedError


class FileDataStorer(DataStorer):
    """Atomic writes into a root directory: temp file + rename, so readers
    (and a crash) never observe partial results — the posix analogue of the
    HDFS create-then-close visibility the reference relies on."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _target(self, rel_path: str) -> str:
        path = os.path.join(self.root, rel_path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return path

    def _atomic_write(self, rel_path: str, write_fn) -> str:
        path = self._target(rel_path)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                write_fn(f)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path

    def store_array(self, rel_path: str, arr: np.ndarray) -> str:
        return self._atomic_write(rel_path, lambda f: np.save(f, arr))

    def store_json(self, rel_path: str, obj: Dict[str, Any]) -> str:
        return self._atomic_write(rel_path, lambda f: f.write(json.dumps(obj, indent=2).encode()))

    def store_text(self, rel_path: str, text: str) -> str:
        return self._atomic_write(rel_path, lambda f: f.write(text.encode()))

    def load_array(self, rel_path: str) -> np.ndarray:
        return np.load(os.path.join(self.root, rel_path))
