"""harmony_tpu_torch.models — the neural model families.

Counterpart of ``harmony_tpu.models``, on one device: the decoder-only
transformer LM (dense or with Switch-style MoE blocks), its KV-cache
generation, and the Vision Transformer, each trained through the table trainer
(:class:`PyTreeTrainer`).
"""
from harmony_tpu_torch.models.generate import make_generate_fn
from harmony_tpu_torch.models.moe import MoEConfig, init_moe_params, moe_ffn
from harmony_tpu_torch.models.pytree_trainer import PyTreeTrainer
from harmony_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    TransformerTrainer,
    make_lm_data,
)
from harmony_tpu_torch.models.vit import ViT, ViTConfig, ViTTrainer

__all__ = [
    "MoEConfig",
    "TransformerConfig",
    "TransformerLM",
    "TransformerTrainer",
    "PyTreeTrainer",
    "ViT",
    "ViTConfig",
    "ViTTrainer",
    "init_moe_params",
    "make_generate_fn",
    "make_lm_data",
    "moe_ffn",
]
