"""Config schemas: table / trainer parameters / job.

Counterpart of ``harmony_tpu/config/params.py``, copied for the fields this
port reads. Field names and defaults are the reference's, so a job described
for one package reads the same in the other.
"""
from __future__ import annotations

import os
from dataclasses import field
from typing import Any, Dict, List, Optional, Tuple

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
    is_mutable: bool = True
    update_fn: str = "add"             # name in table.update registry
    # Sparse key domain: back the table with a capacity-bounded hash table
    # (table/hashtable.py::DeviceHashTable); getOrInit admits any key of
    # [MIN_KEY, MAX_KEY] and ``capacity`` bounds slots, not the key domain.
    sparse: bool = False
    # Bulk-load source (the reference's FilePath / BulkDataLoader binding).
    # Carried so that a checkpoint manifest holds the reference's keys;
    # ``TableHandle.load`` takes its paths and parser as arguments, as the
    # reference's does.
    input_path: Optional[str] = None
    parser: Optional[str] = None       # dotted path of a DataParser

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
class RetryPolicy(ConfigBase):
    """Bounded retry with exponential backoff and jitter for transient I/O
    faults (checkpoint block reads and writes; ``faults/retry.py``'s
    ``call_with_retry``): attempt, sleep ``base_delay_sec``, attempt, sleep
    ``base_delay_sec * multiplier``, ... capped at ``max_delay_sec``, at most
    ``max_attempts`` attempts, each sleep stretched by up to ``jitter`` of
    itself. Exhaustion raises ``RetryError``."""

    max_attempts: int = 4
    base_delay_sec: float = 0.05
    max_delay_sec: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay_sec < 0 or self.max_delay_sec < 0:
            raise ValueError("delays must be non-negative")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1 (backoff, not decay)")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError("jitter is a fraction in [0, 1]")

    _ENV_FIELDS = (
        ("max_attempts", "HARMONY_RETRY_MAX_ATTEMPTS", int),
        ("base_delay_sec", "HARMONY_RETRY_BASE_DELAY", float),
        ("max_delay_sec", "HARMONY_RETRY_MAX_DELAY", float),
        ("multiplier", "HARMONY_RETRY_MULTIPLIER", float),
        ("jitter", "HARMONY_RETRY_JITTER", float),
    )

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        """The defaults, overridden by the ``HARMONY_RETRY_*`` env vars."""
        kv = {}
        for field_name, var, cast in cls._ENV_FIELDS:
            raw = os.environ.get(var)
            if raw is not None:
                kv[field_name] = cast(raw)
        return cls(**kv)


@config
class TrainerParams(ConfigBase):
    """Dolphin hyper-parameter block: an epoch is split into exactly
    ``num_mini_batches`` batches; ``app_params`` are the trainer's constructor
    arguments. The step-mode and input fields select the worker's loop
    (``dolphin/worker.py``); the process-wide env knobs ``HARMONY_FUSED_STEP``
    (0/1), ``HARMONY_ASYNC_STEP`` (0/1) and ``HARMONY_STALENESS_BOUND`` (an
    int) override ``fused_step``, ``async_step`` and ``staleness_bound`` for
    every job, read where the worker is built."""

    num_epochs: int = 1
    num_mini_batches: int = 10
    clock_slack: int = 0              # SSP staleness bound; 0 = BSP
    # Checkpoint chain (dolphin/evaluator.py::ModelChkpManager): 0 = off; N =
    # snapshot the model table every N epochs from the chief's epoch hook.
    model_chkp_period: int = 0
    # Replay the chain through the trainer's evaluate at JobServer shutdown
    # (the deferred offline evaluation; server.eval_results holds it).
    offline_model_eval: bool = False
    # Comm/comp split probe period in epochs (WorkerTasklet._probe_comm): the
    # probe times the table's PULL alone and PULL+PUSH of a zero delta on a
    # copy of the table, at the first epoch and then every 8 x period epochs,
    # on the fused path. 0 turns it off.
    comm_probe_period: int = 1
    # The input pipeline (dolphin/prefetch.py): a producer thread assembles
    # the epoch's batches and stages their copies to the device (pinned
    # memory, a copy stream) ahead of the steps. Losses are bit-identical
    # either way for a fixed seed.
    input_prefetch: bool = True
    # True: each batch's PULL, COMP and PUSH are enqueued back to back with
    # no host sync, and a stable epoch runs from a device-resident stack in
    # windows of up to 8 epochs with one drain a window. False: the unfused
    # per-phase step, three phases with the model traffic round-tripping
    # through host memory and a sync at each boundary (bit-identical losses,
    # measured phase seconds).
    fused_step: bool = True
    # Bounded-staleness async step (dense pull_mode="all" tables): a comm
    # thread runs step k's PUSH and the next PULL while step k+1 computes on
    # the previous view; step k's compute waits until the view reflects at
    # least k - staleness_bound deltas. Bound 0 is bit-identical to the
    # unfused step.
    async_step: bool = False
    staleness_bound: int = 0
    app_params: Dict[str, Any] = field(default_factory=dict)


@config
class JobConfig(ConfigBase):
    """A job submission: the trainer by dotted path, its parameters, and
    ``user["data_fn"]`` / ``user["data_args"]`` naming the data generator.
    ``tables`` names a SHARED model table: the job reuses the table of that
    id if one exists (another job's, or one made by the caller) and the
    master frees it when its last holder drops it; with no ``tables`` the
    job's model table is private, under a job-namespaced id. ``optimizer``
    turns on the job's elasticity loop (the reference's per-job Optimizer
    binding): "homogeneous" | "heterogeneous" | "add_one_server" |
    "delete_one_server" | "empty" | a dotted path to an Optimizer class; None
    keeps the table where it was created."""

    job_id: str
    app_type: str                      # "dolphin" | "pregel"
    trainer: Optional[str] = None      # dotted path of a Trainer subclass
    optimizer: Optional[str] = None
    optimizer_period: float = 5.0      # seconds between optimization rounds
    tables: List[TableConfig] = field(default_factory=list)
    params: TrainerParams = field(default_factory=TrainerParams)
    num_workers: int = 0               # 0 = one worker per granted executor
    user: Dict[str, Any] = field(default_factory=dict)
