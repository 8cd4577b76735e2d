"""Job, trainer and table configuration."""
from harmony_tpu_torch.config.base import (
    ConfigBase,
    config,
    register_config,
    resolve_symbol,
    symbol_name,
)
from harmony_tpu_torch.config.params import (
    JobConfig,
    RetryPolicy,
    TableConfig,
    TrainerParams,
)

__all__ = [
    "ConfigBase",
    "config",
    "register_config",
    "resolve_symbol",
    "symbol_name",
    "JobConfig",
    "RetryPolicy",
    "TableConfig",
    "TrainerParams",
]
