"""Decoder-only transformer LM, on one device.

Counterpart of ``harmony_tpu/models/transformer.py``'s single-device part:
parameters are a tree of f32 master tensors (dicts and lists), activations run
in ``config.dtype`` (bf16 on the card), attention is the flash kernels
(``ops/attention.py``, K4/K5a/K5b) or the plain blockwise route, and
:class:`TransformerTrainer` trains the LM through the table trainer
(``models/pytree_trainer.py``), so it runs through the same JobServer and
WorkerTasklet as every app.

``init`` is the reference's ``init_numpy``: the same numpy draws from the same
seed, byte for byte. The reference's ``init`` draws from ``jax.random``, which
cannot be reproduced here, so the two packages' ``cli run lm`` start from
different weights; to hold one against the other, carry the weights across
(``convert.py``). A config with ``moe_experts > 0`` swaps every
``moe_every``-th block's FFN for a Switch-style expert bank
(``models/moe.py``), whose load-balance loss joins the cross-entropy at
``moe_aux_weight``. Not ported yet: the sequence-, tensor-, expert- and
pipeline-parallel steps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from harmony_tpu_torch.models.common import (
    dense_init,
    resolve_attn,
    resolve_dtype,
    rms_norm,
    validate_attn,
)
from harmony_tpu_torch.models.moe import MoEConfig, init_moe_params, moe_ffn
from harmony_tpu_torch.models.pytree_trainer import PyTreeTrainer
from harmony_tpu_torch.ops.attention import blockwise_attention, flash_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 256
    dtype: Any = torch.float32      # activation dtype: a torch dtype, "float32" or "bfloat16"
    attn: str = "auto"              # "auto" | "flash" | "blockwise"
    remat: bool = False             # recompute each layer's activations in the backward
    # Mixture-of-Experts FFN (models/moe.py): 0 = dense. Every moe_every-th
    # block swaps its FFN for a top-1-routed expert bank; the Switch aux
    # load-balance loss joins the CE at moe_aux_weight.
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 1.5
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        object.__setattr__(self, "dtype", resolve_dtype(self.dtype))
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide by n_heads")
        if self.moe_experts and self.moe_every < 1:
            raise ValueError("moe_every must be >= 1")
        validate_attn(self.attn)

    def is_moe_layer(self, i: int) -> bool:
        """Block i carries the MoE FFN: the last of every ``moe_every`` group
        (Switch interleaves dense and expert blocks)."""
        return bool(self.moe_experts) and i % self.moe_every == self.moe_every - 1

    @property
    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(num_experts=self.moe_experts, d_model=self.d_model,
                         d_ff=self.d_ff, capacity_factor=self.moe_capacity_factor)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class TransformerLM:
    """Decoder-only LM over a parameter tree: ``init`` -> params, ``apply`` ->
    logits, ``loss`` -> mean next-token cross-entropy."""

    def __init__(self, config: TransformerConfig) -> None:
        self.config = config

    # -- params ----------------------------------------------------------

    def param_shapes(self) -> Dict[str, Any]:
        """The parameter tree with shape tuples for leaves."""
        cfg = self.config
        d, f, E = cfg.d_model, cfg.d_ff, cfg.moe_experts

        def layer(i):
            ffn = ({"moe": {"router": (d, E), "w1": (E, d, f), "w2": (E, f, d)}}
                   if cfg.is_moe_layer(i) else {"w1": (d, f), "w2": (f, d)})
            return {"ln1": (d,), "wqkv": (d, 3 * d), "wo": (d, d), "ln2": (d,), **ffn}

        return {"embed": (cfg.vocab_size, d), "pos": (cfg.max_seq, d), "ln_f": (d,),
                "layers": [layer(i) for i in range(cfg.n_layers)]}

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """numpy f32 parameters: the reference's ``init_numpy(seed)``, the same
        draws in the same order."""
        cfg = self.config
        rng = np.random.default_rng(seed)
        d, f = cfg.d_model, cfg.d_ff
        layers = []
        for i in range(cfg.n_layers):
            layer = {
                "ln1": np.ones((d,), np.float32),
                "wqkv": dense_init(rng, (d, 3 * d)),
                "wo": dense_init(rng, (d, d)),
                "ln2": np.ones((d,), np.float32),
            }
            if cfg.is_moe_layer(i):
                layer["moe"] = init_moe_params(rng, cfg.moe_cfg)
            else:
                layer["w1"] = dense_init(rng, (d, f))
                layer["w2"] = dense_init(rng, (f, d))
            layers.append(layer)
        return {
            "embed": (0.02 * rng.standard_normal((cfg.vocab_size, d))).astype(np.float32),
            "pos": (0.02 * rng.standard_normal((cfg.max_seq, d))).astype(np.float32),
            "ln_f": np.ones((d,), np.float32),
            "layers": layers,
        }

    # -- forward ---------------------------------------------------------

    def _attention(self, q, k, v):
        S = q.shape[2]
        attn = resolve_attn(self.config.attn, S, on_card=q.is_cuda, block=128)
        if attn == "flash":
            return flash_attention(q, k, v, causal=True,
                                   block_q=min(128, S), block_k=min(128, S))
        return blockwise_attention(q, k, v, causal=True)

    def _block(self, x, layer):
        """One pre-norm decoder block; returns ``(x, aux)``: the Switch
        load-balance loss of an MoE block, 0 for a dense one."""
        cfg = self.config
        B, S = x.shape[0], x.shape[1]
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        xn = rms_norm(x, layer["ln1"].to(cfg.dtype))
        qkv = xn @ layer["wqkv"].to(cfg.dtype)                  # [B, S, 3d]
        q, k, v = qkv.split(d, dim=-1)                         # contiguous thirds

        def to_heads(t):
            return t.reshape(B, S, h, hd).transpose(1, 2)

        o = self._attention(to_heads(q), to_heads(k), to_heads(v))
        o = o.transpose(1, 2).reshape(B, S, d)
        x = x + o @ layer["wo"].to(cfg.dtype)
        xn = rms_norm(x, layer["ln2"].to(cfg.dtype))
        out, aux = ffn_apply(cfg, layer, xn)
        return x + out, aux

    def apply(self, params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
        logits, _ = self._apply_with_aux(params, tokens)
        return logits

    def _apply_with_aux(self, params, tokens):
        """apply + the summed MoE aux loss (0 for dense configs)."""
        cfg = self.config
        x = _embed_in(cfg, params["embed"], params["pos"], tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in params["layers"]:
            if cfg.remat:
                # recompute the block in the backward instead of keeping its
                # activations: one block's activations live at a time
                x, a = checkpoint(self._block, x, layer, use_reentrant=False)
            else:
                x, a = self._block(x, layer)
            aux = aux + a
        x = rms_norm(x, params["ln_f"].to(cfg.dtype))
        # weight-tied readout, f32 logits for a stable softmax
        return x.float() @ params["embed"].T, aux

    def loss(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy over the batch, plus the weighted MoE
        load-balance loss for expert configs."""
        logits, aux = self._apply_with_aux(params, tokens[:, :-1])
        ce = _next_token_ce(logits, tokens[:, 1:])
        if self.config.moe_experts:
            return ce + self.config.moe_aux_weight * aux
        return ce


def _next_token_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy."""
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -ll.mean()


def ffn_apply(cfg: TransformerConfig, layer, xn, no_drop: bool = False):
    """The dense or MoE FFN on [..., d] activations, shared by the training
    blocks and the decode path; returns ``(out, aux)``. GELU is the tanh
    approximation, as ``jax.nn.gelu`` computes it by default. ``no_drop`` lifts
    the expert capacity to every token: decode routes a few rows a step, where
    the training capacity factor would drop a token whenever two rows share an
    expert and let one sequence change another's output."""
    if "moe" in layer:
        mcfg = cfg.moe_cfg
        if no_drop:
            mcfg = dataclasses.replace(mcfg, capacity_factor=float(mcfg.num_experts))
        out, aux = moe_ffn(layer["moe"], xn.reshape(-1, cfg.d_model), mcfg)
        return out.reshape(xn.shape), aux
    hidden = F.gelu(xn @ layer["w1"].to(cfg.dtype), approximate="tanh")
    return hidden @ layer["w2"].to(cfg.dtype), torch.zeros((), device=xn.device)


def _embed_in(cfg: TransformerConfig, embed, pos, tokens) -> torch.Tensor:
    """Token + position embedding, added in f32, then cast to the activation
    dtype."""
    idx = torch.arange(tokens.shape[1], device=tokens.device)
    return (embed[tokens.long()] + pos[idx]).to(cfg.dtype)


# ---------------------------------------------------------------------------
# Data (numpy, byte-identical to the reference's)
# ---------------------------------------------------------------------------

def load_text_tokens(
    path: str, seq_len: int, num_seqs: int = 0, vocab_size: int = 256
) -> np.ndarray:
    """Byte-level tokenization of a text file into a [num_seqs, seq_len] int32
    matrix. Bytes >= vocab_size fold modulo; ``num_seqs=0`` takes every whole
    window the file holds."""
    if vocab_size < 2:
        raise ValueError("vocab_size must be >= 2")
    if seq_len < 2:  # a next-token example needs at least 2 tokens
        raise ValueError(f"seq_len must be >= 2, got {seq_len}")
    if num_seqs < 0:
        raise ValueError(f"num_seqs must be >= 0, got {num_seqs}")
    raw = np.fromfile(path, np.uint8)
    total = raw.shape[0] // seq_len
    if total == 0:
        raise ValueError(
            f"{path}: {raw.shape[0]} bytes cannot fill one {seq_len}-token sequence")
    if num_seqs and total < num_seqs:
        raise ValueError(f"{path}: holds {total} windows of {seq_len}, wanted {num_seqs}")
    n = num_seqs or total
    toks = raw[: n * seq_len].reshape(n, seq_len).astype(np.int32)
    return toks % vocab_size


def make_lm_data(num_seqs: int, seq_len: int, vocab_size: int, seed: int = 0) -> np.ndarray:
    """Synthetic learnable corpus: orderly token walks with noise (the next
    token follows from the current one ~80% of the time)."""
    rng = np.random.default_rng(seed)
    step = rng.integers(1, 7, size=(num_seqs, 1))
    start = rng.integers(0, vocab_size, size=(num_seqs, 1))
    walk = (start + step * np.arange(seq_len)[None, :]) % vocab_size
    noise = rng.integers(0, vocab_size, size=walk.shape)
    take_noise = rng.random(walk.shape) < 0.2
    return np.where(take_noise, noise, walk).astype(np.int32)


# ---------------------------------------------------------------------------
# The LM in the table
# ---------------------------------------------------------------------------

class TransformerTrainer(PyTreeTrainer):
    """Train the LM through the table trainer (row layout and optimizer-state
    sections in PyTreeTrainer). Batch = [B, S] int32 token matrix."""

    default_table_id = "lm-model"
    config_cls = TransformerConfig

    def build_model(self, config: TransformerConfig) -> TransformerLM:
        return TransformerLM(config)

    def loss_on_batch(self, params, batch):
        tokens = batch[0] if isinstance(batch, (tuple, list)) else batch
        return self.model.loss(params, tokens)
