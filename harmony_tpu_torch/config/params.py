"""Config schemas: table / trainer parameters / job.

Counterpart of ``harmony_tpu/config/params.py``, copied for the fields this
port reads. Field names and defaults are the reference's, so a job described
for one package reads the same in the other.
"""
from __future__ import annotations

from dataclasses import field
from typing import Any, Dict, Optional, Tuple

from harmony_tpu_torch.config.base import ConfigBase, config

# Reference default: NumTotalBlocks def 1024.
DEFAULT_NUM_BLOCKS = 1024


@config
class TableConfig(ConfigBase):
    """Schema of one table. ``is_ordered`` selects range (True) vs hash (False)
    partitioning; ``update_fn`` names an entry of ``table.update``'s registry."""

    table_id: str
    capacity: int                      # number of addressable keys [0, capacity)
    value_shape: Tuple[int, ...] = ()  # per-key value shape; () = scalar
    dtype: str = "float32"
    num_blocks: int = DEFAULT_NUM_BLOCKS
    is_ordered: bool = True            # range partitioner; False = hash
    update_fn: str = "add"             # name in table.update registry

    def __post_init__(self) -> None:
        if self.capacity <= 0:
            raise ValueError("capacity must be positive")
        if self.num_blocks <= 0:
            raise ValueError("num_blocks must be positive")
        if self.num_blocks > self.capacity:
            # clamp HERE so the config is the single source of truth for the
            # block count
            object.__setattr__(self, "num_blocks", self.capacity)
        if isinstance(self.value_shape, list):
            object.__setattr__(self, "value_shape", tuple(self.value_shape))


@config
class TrainerParams(ConfigBase):
    """Dolphin hyper-parameter block: an epoch is split into exactly
    ``num_mini_batches`` batches; ``app_params`` are the trainer's constructor
    arguments. ``comm_probe_period`` is accepted with the reference's default,
    so a job described for the reference reads the same here; the comm probe
    that reads it is not ported yet."""

    num_epochs: int = 1
    num_mini_batches: int = 10
    app_params: Dict[str, Any] = field(default_factory=dict)
    comm_probe_period: int = 1


@config
class JobConfig(ConfigBase):
    """A job submission: the trainer by dotted path, its parameters, and
    ``user["data_fn"]`` / ``user["data_args"]`` naming the data generator."""

    job_id: str
    app_type: str                      # "dolphin"
    trainer: Optional[str] = None      # dotted path of a Trainer subclass
    params: TrainerParams = field(default_factory=TrainerParams)
    num_workers: int = 0               # 0 = one worker (this port runs one)
    user: Dict[str, Any] = field(default_factory=dict)
