"""harmony_tpu_torch.models — the neural model families.

Counterpart of ``harmony_tpu.models``: so far the decoder-only transformer LM on
one device, trained through the table trainer (:class:`PyTreeTrainer`).
"""
from harmony_tpu_torch.models.pytree_trainer import PyTreeTrainer
from harmony_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    TransformerTrainer,
    make_lm_data,
)

__all__ = [
    "PyTreeTrainer",
    "TransformerConfig",
    "TransformerLM",
    "TransformerTrainer",
    "make_lm_data",
]
