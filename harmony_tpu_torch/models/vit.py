"""Vision Transformer classifier, on one device.

Counterpart of ``harmony_tpu/models/vit.py``: images [B, H, W, C] ->
non-overlapping patches -> linear embed + learned positions + CLS token ->
pre-norm encoder blocks (non-causal attention) -> CLS readout head, f32
logits. Parameters are a tree of f32 master tensors, activations run in
``config.dtype`` (bf16 on the card), and :class:`ViTTrainer` trains the model
through the table trainer (``models/pytree_trainer.py``).

Attention resolves with the flash kernels' default block (256), as the
reference's does, not the LM's 128: at ViT-B/16's 197 tokens the block clamps
to 197, so flash runs (non-causal) where the LM's rule would pick blockwise.
bf16 at a key tile of 197 takes the kernels' ``simt`` route
(``ops/attention.py::flash_route``).

``init`` is numpy (the reference's draws from ``jax.random``, which is not
reproduced here): the same layout and scaling, drawn from
``np.random.default_rng(seed)``. So ``cli run vit`` starts from other weights
than the reference's; to hold one against the other, carry the weights across
(``convert.py``). ``make_train_step(model, mesh)`` is the data-parallel step:
the batch splits over the mesh's data axis, each slot runs its own replica,
and the replicas' gradients are added in slot order on the home slot (the
reference's ``shard_map`` inserts that all-reduce).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from harmony_tpu_torch.models.common import (
    dense_init,
    mesh_slot,
    replica,
    resolve_attn,
    resolve_dtype,
    rms_norm,
    sgd_update,
    validate_attn,
)
from harmony_tpu_torch.models.pytree_trainer import PyTreeTrainer, tree_leaves, tree_unflatten
from harmony_tpu_torch.ops.attention import blockwise_attention, flash_attention
from harmony_tpu_torch.parallel.collectives import psum
from harmony_tpu_torch.parallel.dispatch import dispatch_scope
from harmony_tpu_torch.parallel.mesh import DATA_AXIS
from harmony_tpu_torch.utils.platform import full_f32_matmuls


@dataclasses.dataclass
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    channels: int = 3
    num_classes: int = 10
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 512
    dtype: Any = torch.float32      # activation dtype: a torch dtype, "float32" or "bfloat16"
    attn: str = "auto"              # "auto" | "flash" | "blockwise"

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError("patch_size must divide image_size")
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide by n_heads")
        self.dtype = resolve_dtype(self.dtype)
        validate_attn(self.attn)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    @property
    def seq(self) -> int:
        return self.num_patches + 1  # + CLS


class ViT:
    def __init__(self, cfg: ViTConfig) -> None:
        self.cfg = cfg

    def param_shapes(self) -> Dict[str, Any]:
        """The parameter tree with shape tuples for leaves."""
        cfg = self.cfg
        d, f = cfg.d_model, cfg.d_ff
        layer = {"ln1": (d,), "wqkv": (d, 3 * d), "wo": (d, d), "ln2": (d,),
                 "w1": (d, f), "w2": (f, d)}
        return {"embed": (cfg.patch_dim, d), "pos": (cfg.seq, d), "cls": (d,),
                "ln_f": (d,), "head": (d, cfg.num_classes),
                "layers": [dict(layer) for _ in range(cfg.n_layers)]}

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """numpy f32 parameters in the reference's layout and scaling, drawn in
        its key order: embed, pos, head, then each layer's wqkv, wo, w1, w2."""
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        d, f = cfg.d_model, cfg.d_ff
        embed = dense_init(rng, (cfg.patch_dim, d))
        pos = (0.02 * rng.standard_normal((cfg.seq, d))).astype(np.float32)
        head = dense_init(rng, (d, cfg.num_classes))
        layers = []
        for _ in range(cfg.n_layers):
            layers.append({
                "ln1": np.ones((d,), np.float32),
                "wqkv": dense_init(rng, (d, 3 * d)),
                "wo": dense_init(rng, (d, d)),
                "ln2": np.ones((d,), np.float32),
                "w1": dense_init(rng, (d, f)),
                "w2": dense_init(rng, (f, d)),
            })
        return {"embed": embed, "pos": pos, "cls": np.zeros((d,), np.float32),
                "ln_f": np.ones((d,), np.float32), "head": head, "layers": layers}

    def _patchify(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B = images.shape[0]
        p, n = cfg.patch_size, cfg.image_size // cfg.patch_size
        x = images.reshape(B, n, p, n, p, cfg.channels)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(B, n * n, cfg.patch_dim)

    def _attend(self, q, k, v):
        # the default block (256), as the reference resolves it
        if resolve_attn(self.cfg.attn, self.cfg.seq, on_card=q.is_cuda) == "flash":
            return flash_attention(q, k, v, causal=False)
        return blockwise_attention(q, k, v, causal=False)

    def apply(self, params, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, C] -> logits [B, num_classes] f32."""
        cfg = self.cfg
        B = images.shape[0]
        x = self._patchify(images.to(cfg.dtype)) @ params["embed"].to(cfg.dtype)
        cls = params["cls"].to(cfg.dtype).expand(B, 1, cfg.d_model)
        x = torch.cat([cls, x], dim=1) + params["pos"].to(cfg.dtype)

        def to_heads(t):
            return t.reshape(B, cfg.seq, cfg.n_heads, -1).transpose(1, 2)

        for layer in params["layers"]:
            xn = rms_norm(x, layer["ln1"].to(cfg.dtype))
            q, k, v = (xn @ layer["wqkv"].to(cfg.dtype)).split(cfg.d_model, dim=-1)
            o = self._attend(to_heads(q), to_heads(k), to_heads(v))
            o = o.transpose(1, 2).reshape(B, cfg.seq, cfg.d_model)
            x = x + o @ layer["wo"].to(cfg.dtype)
            xn = rms_norm(x, layer["ln2"].to(cfg.dtype))
            x = x + F.gelu(xn @ layer["w1"].to(cfg.dtype), approximate="tanh") \
                @ layer["w2"].to(cfg.dtype)
        x = rms_norm(x[:, 0], params["ln_f"].to(cfg.dtype))  # the CLS token
        return x.float() @ params["head"]                     # f32 logits

    def loss(self, params, images, labels) -> torch.Tensor:
        return self._nll(params, images, labels).mean()

    def _nll(self, params, images, labels) -> torch.Tensor:
        """Each example's negative log-likelihood [B], f32."""
        logp = F.log_softmax(self.apply(params, images), dim=-1)
        return -torch.gather(logp, -1, labels.long()[:, None])[:, 0]

    def accuracy(self, params, images, labels) -> torch.Tensor:
        logits = self.apply(params, images)
        return (torch.argmax(logits, dim=-1) == labels.long()).float().mean()


def make_train_step(model: ViT, mesh=None, learning_rate: float = 0.1,
                    donate: bool = True):
    """The SGD step ``(params, images, labels) -> (params, loss)``. With
    ``mesh`` the batch splits over its data axis: each slot differentiates its
    own replica on its rows, the loss is the slots' sums of per-example losses
    added in slot order over B, and the gradients are added in slot order on
    the home slot (the mesh's first), where ``params`` lie; without it the
    step runs where ``params`` lie. ``donate`` (the
    default, as in the LM steps) updates ``params`` in place and returns them;
    pass False to keep the old tree (comparing trajectories from one tree)."""
    full_f32_matmuls()
    devices = None
    if mesh is not None:
        devices = [mesh_slot(mesh, {DATA_AXIS: d}).device
                   for d in range(mesh.shape.get(DATA_AXIS, 1))]

    def step(params, images, labels):
        images, labels = torch.as_tensor(images), torch.as_tensor(labels)
        flat = list(tree_leaves(params))
        slots = devices or [flat[0].device]
        D = len(slots)
        if images.shape[0] % D:
            raise ValueError(f"batch {images.shape[0]} does not split over {D} data slots")
        reps = [[replica(p, dev) for p in flat] for dev in slots]
        parts = [(x.to(dev, non_blocking=True), y.to(dev, non_blocking=True))
                 for x, y, dev in zip(images.chunk(D), labels.chunk(D), slots)]
        with dispatch_scope(mesh):
            with torch.enable_grad():
                sums = [model._nll(tree_unflatten(params, r), x, y).sum()
                        for r, (x, y) in zip(reps, parts)]
                loss = psum(sums, flat[0].device) / images.shape[0]
                grads = torch.autograd.grad(loss, [p for r in reps for p in r])
            n = len(flat)
            with torch.no_grad():
                new = [sgd_update(p, grads[j::n], learning_rate, donate)
                       for j, p in enumerate(flat)]
        return tree_unflatten(params, new), loss.detach()

    return step


class ViTTrainer(PyTreeTrainer):
    """ViT through the table trainer (row layout and optimizer-state sections
    in PyTreeTrainer). Batch = (images [B, H, W, C], labels [B])."""

    default_table_id = "vit-model"
    config_cls = ViTConfig

    def build_model(self, config: ViTConfig) -> ViT:
        return ViT(config)

    def loss_on_batch(self, params, batch):
        images, labels = batch
        return self.model.loss(params, images, labels)

    def eval_metrics(self, params, batch):
        images, labels = batch
        return {"loss": self.model.loss(params, images, labels),
                "accuracy": self.model.accuracy(params, images, labels)}


def make_synthetic(
    n: int, cfg: Optional[ViTConfig] = None, seed: int = 0, **cfg_kwargs
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-separable synthetic images, byte-identical to the reference's:
    each class gets a random template, samples are noisy copies. Takes flat
    config kwargs (image_size, ...) so that a job config can parameterize it;
    an unknown key, or kwargs beside an explicit cfg, raises."""
    if cfg is not None and cfg_kwargs:
        raise TypeError("pass either cfg= or flat config kwargs, not both")
    if cfg is None:
        unknown = set(cfg_kwargs) - set(ViTConfig.__dataclass_fields__)
        if unknown:
            raise TypeError(f"unknown make_synthetic kwargs {sorted(unknown)}")
        cfg = ViTConfig(**cfg_kwargs)
    rng = np.random.default_rng(seed)
    templates = rng.standard_normal(
        (cfg.num_classes, cfg.image_size, cfg.image_size, cfg.channels)
    ).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, n).astype(np.int32)
    x = templates[y] + 0.5 * rng.standard_normal(
        (n, cfg.image_size, cfg.image_size, cfg.channels)
    ).astype(np.float32)
    return x, y
