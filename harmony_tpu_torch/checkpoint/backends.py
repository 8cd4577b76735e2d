"""Durable-commit backends for two-stage checkpointing.

Counterpart of ``harmony_tpu/checkpoint/backends.py``, the POSIX half copied:
the commit stage is an SPI (:class:`CommitBackend`) and
:class:`PosixCommitBackend` commits into a durable directory on a mounted
filesystem (local disk, NFS, a FUSE-mounted bucket) by an atomic same-FS
rename. A backend stores a staged checkpoint directory (block files and a
``manifest.json`` whose ``committed`` flag it sets) under the checkpoint id
and hands back a local directory on fetch.

The reference's Orbax/tensorstore backend (object-store URLs such as
``gs://``) is JAX-only and is not ported: asking for it, or giving a URL as
the commit root, raises ``NotImplementedError``.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional


def quarantine_dir(path: str) -> None:
    """Move a damaged checkpoint directory aside as ``<path>.quarantined``
    (out of every listing and scan, the evidence kept). Idempotent."""
    if not os.path.isdir(path):
        return
    q = path + ".quarantined"
    if os.path.isdir(q):
        shutil.rmtree(q, ignore_errors=True)  # a reused id's older one
    try:
        os.rename(path, q)
    except FileNotFoundError:
        pass  # quarantined by someone else first


class CommitBackend:
    """SPI: durable storage for committed checkpoints."""

    def exists(self, chkp_id: str) -> bool:
        raise NotImplementedError

    def commit(self, chkp_id: str, src_dir: str) -> None:
        """Persist ``src_dir`` (blocks + manifest.json) durably under
        ``chkp_id``, with the stored manifest's ``committed`` flag True.
        Must be atomic: a crash mid-commit must leave the id unresolvable,
        never resolvable-but-partial."""
        raise NotImplementedError

    def fetch(self, chkp_id: str) -> Optional[str]:
        """Local directory holding the committed checkpoint's files, or
        None if the id is not committed here."""
        raise NotImplementedError

    def fetch_manifest(self, chkp_id: str) -> Optional[str]:
        """The stored manifest.json text without materializing block data.
        Default falls back to a full fetch."""
        d = self.fetch(chkp_id)
        if d is None:
            return None
        with open(os.path.join(d, "manifest.json")) as f:
            return f.read()

    def delete(self, chkp_id: str) -> None:
        raise NotImplementedError

    def quarantine(self, chkp_id: str) -> None:
        """Remove a DAMAGED checkpoint from the restorable namespace; the
        default deletes it."""
        if self.exists(chkp_id):
            self.delete(chkp_id)

    def list_ids(self) -> List[str]:
        raise NotImplementedError


class PosixCommitBackend(CommitBackend):
    """Durable directory + atomic rename."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def exists(self, chkp_id: str) -> bool:
        return os.path.isdir(os.path.join(self.root, chkp_id))

    def commit(self, chkp_id: str, src_dir: str) -> None:
        # Crash-safe across filesystems: copy into a .staging dir INSIDE the
        # durable root, then rename into place (same-FS rename = atomic). A
        # crash mid-copy leaves only a .staging orphan.
        dst = os.path.join(self.root, chkp_id)
        staging = dst + ".staging"
        if os.path.isdir(staging):
            shutil.rmtree(staging)  # leftover from a crashed commit
        shutil.copytree(src_dir, staging)
        manifest = os.path.join(staging, "manifest.json")
        with open(manifest) as f:
            info = json.load(f)
        info["committed"] = True
        with open(manifest, "w") as f:
            json.dump(info, f, sort_keys=True)
        os.rename(staging, dst)

    def fetch(self, chkp_id: str) -> Optional[str]:
        d = os.path.join(self.root, chkp_id)
        return d if os.path.isdir(d) else None

    def delete(self, chkp_id: str) -> None:
        d = os.path.join(self.root, chkp_id)
        if os.path.isdir(d):
            shutil.rmtree(d)

    def quarantine(self, chkp_id: str) -> None:
        quarantine_dir(os.path.join(self.root, chkp_id))

    def list_ids(self) -> List[str]:
        return sorted(
            d for d in os.listdir(self.root)
            if not d.endswith(".staging") and not d.endswith(".writing")
            and not d.endswith(".quarantined")
            and os.path.isdir(os.path.join(self.root, d))
        )


def _is_url(path: str) -> bool:
    return "://" in path


def make_commit_backend(commit_root: str, backend=None) -> CommitBackend:
    """Resolve the commit stage: an explicit CommitBackend instance, or the
    name "posix" (or None) for a directory root. "orbax" and object-store URL
    roots are the reference's Orbax backend, which is not ported."""
    if isinstance(backend, CommitBackend):
        return backend
    if backend == "orbax" or (backend is None and _is_url(commit_root)):
        raise NotImplementedError(
            f"commit root {commit_root!r} needs the Orbax/tensorstore backend "
            "(object stores), which is JAX-only and not ported (ROADMAP A.7); "
            "give a directory on a mounted filesystem")
    if backend in (None, "posix"):
        return PosixCommitBackend(commit_root)
    raise ValueError(f"unknown commit backend {backend!r}")
