"""Two-stage block checkpoints of model tables (``manager.py``) and their
durable-commit backends (``backends.py``)."""
from harmony_tpu_torch.checkpoint.backends import (
    CommitBackend,
    PosixCommitBackend,
    make_commit_backend,
)
from harmony_tpu_torch.checkpoint.manager import (
    CheckpointCorruptError,
    CheckpointInfo,
    CheckpointManager,
    CheckpointStillWriting,
    PendingCheckpoint,
)

__all__ = [
    "CheckpointManager",
    "CheckpointCorruptError",
    "CheckpointInfo",
    "CheckpointStillWriting",
    "PendingCheckpoint",
    "CommitBackend",
    "PosixCommitBackend",
    "make_commit_backend",
]
