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
``moe_aux_weight``.

Over a mesh of slots (``parallel/mesh.py``), :func:`make_sp_train_step` splits
the batch over the data axis and the sequence over the seq axis, with ring
attention (``ops/ring.py``) or the all-to-all head scatter (``ops/ulysses.py``,
``sp_attn="a2a"``) across each ring; :func:`make_parallel_train_step` adds
Megatron tensor parallelism over the model axis. The reference runs these
steps per device inside ``shard_map``; the port is one process driving every
slot, so the layers run in lockstep across the slots: the pre-attention half
of a block on every slot, the attention across each ring, then the
post-attention half on every slot (``_qkv_heads``, ``_finish_block``, which
the one-device ``_block`` shares). Each slot differentiates its own replica of
the parameters, and the replicas' gradients are added in slot order where the
parameters live (shard_map's typed autodiff inserts that psum in the
reference). :func:`make_ep_train_step` splits the batch over the data axis and
the MoE blocks' experts with it: each MoE block runs in lockstep, the
attention half and the ``ln2`` norm on every slot, then the expert exchange
across the slots (``models/moe.py``), then the residual on every slot
(``_finish_attention``, which ``_finish_block`` shares).
:func:`make_pp_train_step` splits the blocks into pipeline stages, one slot
each (``parallel/pipeline.py``), with the embedding, positions and final norm
on the home slot outside the pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
from harmony_tpu_torch.models.moe import MoEConfig, init_moe_params, moe_ffn
from harmony_tpu_torch.models.pytree_trainer import (
    PyTreeTrainer,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from harmony_tpu_torch.ops.attention import blockwise_attention, flash_attention
from harmony_tpu_torch.ops.ring import ring_attention
from harmony_tpu_torch.ops.ulysses import a2a_attention
from harmony_tpu_torch.parallel.collectives import broadcast, psum
from harmony_tpu_torch.parallel.dispatch import dispatch_scope
from harmony_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh
from harmony_tpu_torch.parallel.pipeline import STAGE_AXIS, make_pipeline_fn


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
    sp_attn: str = "ring"           # sequence-parallel tier: "ring" | "a2a"
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
        if self.sp_attn not in ("ring", "a2a"):
            raise ValueError(f"unknown sp_attn {self.sp_attn!r}")
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
        """Causal attention over [B, H, S, D] heads on one device, or, given
        lists, over the local chunks of one ring of slots in sequence order
        (the sequence-parallel tier, ``sp_attn``)."""
        cfg = self.config
        if isinstance(q, list):
            sp = a2a_attention if cfg.sp_attn == "a2a" else ring_attention
            return sp(q, k, v, causal=True)
        S = q.shape[2]
        attn = resolve_attn(cfg.attn, S, on_card=q.is_cuda, block=128)
        if attn == "flash":
            return flash_attention(q, k, v, causal=True,
                                   block_q=min(128, S), block_k=min(128, S))
        return blockwise_attention(q, k, v, causal=True)

    def _qkv_heads(self, x, layer):
        """A block's pre-attention half: the normed input's q, k and v, each
        [B, H, S, hd]."""
        cfg = self.config
        xn = rms_norm(x, layer["ln1"].to(cfg.dtype))
        qkv = xn @ layer["wqkv"].to(cfg.dtype)                  # [B, S, 3d]
        return tuple(_to_heads(t, cfg.n_heads)                 # contiguous thirds
                     for t in qkv.split(cfg.d_model, dim=-1))

    def _finish_attention(self, x, o, layer):
        """The out-projection of the attention output o [B, H, S, hd] and its
        residual; returns ``(x, xn)``, xn the FFN's normed input."""
        cfg = self.config
        x = x + _from_heads(o) @ layer["wo"].to(cfg.dtype)
        return x, rms_norm(x, layer["ln2"].to(cfg.dtype))

    def _finish_block(self, x, o, layer):
        """A block's post-attention half, from the attention output o [B, H, S,
        hd]: the out-projection, the FFN and both residuals. Returns ``(x,
        aux)``: the Switch load-balance loss of an MoE block, 0 for a dense one."""
        x, xn = self._finish_attention(x, o, layer)
        out, aux = ffn_apply(self.config, layer, xn)
        return x + out, aux

    def _block(self, x, layer):
        """One pre-norm decoder block on one device; returns ``(x, aux)``."""
        return self._finish_block(x, self._attention(*self._qkv_heads(x, layer)), layer)

    def _blocks(self, xs, layers, rings=None, experts=False):
        """One block on every slot: ``xs[i]`` with ``layers[i]`` (slot i's
        replica). ``rings`` lists the slot indices of each sequence ring in
        sequence order; without it each slot runs alone. The layers run in
        lockstep: the pre-attention half on every slot, then the attention
        across each ring, then the post-attention half on every slot. With
        ``experts`` an MoE block's experts are split over the slots, and its
        FFN runs across them (``ffn_apply`` on the slots' lists)."""
        if experts and "moe" in layers[0]:
            o = [self._attention(*self._qkv_heads(x, layer)) for x, layer in zip(xs, layers)]
            xs, xns = zip(*[self._finish_attention(x, oi, layer)
                            for x, oi, layer in zip(xs, o, layers)])
            outs, aux = ffn_apply(self.config, list(layers), list(xns))
            return [x + out for x, out in zip(xs, outs)], aux
        if rings is None:
            out = [self._block(x, layer) for x, layer in zip(xs, layers)]
        else:
            heads = [self._qkv_heads(x, layer) for x, layer in zip(xs, layers)]
            o = [None] * len(xs)
            for ring in rings:
                q, k, v = ([heads[i][j] for i in ring] for j in range(3))
                for i, oi in zip(ring, self._attention(q, k, v)):
                    o[i] = oi
            out = [self._finish_block(x, oi, layer) for x, oi, layer in zip(xs, o, layers)]
        return [x for x, _ in out], [a for _, a in out]

    def apply(self, params: Dict[str, Any], tokens: torch.Tensor,
              pos_offset: int = 0) -> torch.Tensor:
        """Logits [B, S, vocab] f32; ``pos_offset`` is the global position of
        ``tokens[:, 0]``."""
        logits, _ = self._apply_with_aux(params, tokens, pos_offset)
        return logits

    def _apply_with_aux(self, params, tokens, pos_offset: int = 0):
        """apply + the summed MoE aux loss (0 for dense configs)."""
        (logits,), (aux,) = self._forward([params], [tokens], [pos_offset])
        return logits, aux

    def _forward(self, params: Sequence[Any], tokens: Sequence[torch.Tensor],
                 offsets: Sequence[int], rings=None, experts=False):
        """The forward on each slot: ``params[i]`` (slot i's replica) on
        ``tokens[i]`` from global position ``offsets[i]``, across the sequence
        ``rings`` or with the experts split over the slots (see ``_blocks``).
        Returns each slot's logits and summed aux."""
        cfg = self.config
        xs = [_embed_in(cfg, p["embed"], p["pos"], t, off)
              for p, t, off in zip(params, tokens, offsets)]
        aux = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
        for i in range(cfg.n_layers):
            layers = [p["layers"][i] for p in params]
            if cfg.remat:
                # recompute the block in the backward instead of keeping its
                # activations: one block's activations live at a time
                xs, a = checkpoint(self._blocks, xs, layers, rings, experts,
                                   use_reentrant=False)
            else:
                xs, a = self._blocks(xs, layers, rings, experts)
            aux = [s + t for s, t in zip(aux, a)]
        # weight-tied readout, f32 logits for a stable softmax
        return [rms_norm(x, p["ln_f"].to(cfg.dtype)).float() @ p["embed"].T
                for x, p in zip(xs, params)], aux

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
    expert and let one sequence change another's output. Given lists (each
    slot's replica of an MoE layer, holding its expert shard, and each slot's
    activations), the MoE FFN runs expert-parallel across the slots and
    returns each slot's output and aux."""
    if isinstance(xn, list):
        outs, aux = moe_ffn([lay["moe"] for lay in layer],
                            [x.reshape(-1, cfg.d_model) for x in xn], cfg.moe_cfg)
        return [out.reshape(x.shape) for out, x in zip(outs, xn)], aux
    if "moe" in layer:
        mcfg = cfg.moe_cfg
        if no_drop:
            mcfg = dataclasses.replace(mcfg, capacity_factor=float(mcfg.num_experts))
        out, aux = moe_ffn(layer["moe"], xn.reshape(-1, cfg.d_model), mcfg)
        return out.reshape(xn.shape), aux
    hidden = F.gelu(xn @ layer["w1"].to(cfg.dtype), approximate="tanh")
    return hidden @ layer["w2"].to(cfg.dtype), torch.zeros((), device=xn.device)


def _embed_in(cfg: TransformerConfig, embed, pos, tokens, pos_offset: int = 0) -> torch.Tensor:
    """Token + position embedding from global position ``pos_offset``, added in
    f32, then cast to the activation dtype."""
    idx = pos_offset + torch.arange(tokens.shape[1], device=tokens.device)
    return (embed[tokens.long()] + pos[idx]).to(cfg.dtype)


def _to_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, heads * hd] -> [B, heads, S, hd]."""
    B, S = t.shape[0], t.shape[1]
    return t.reshape(B, S, heads, -1).transpose(1, 2)


def _from_heads(o: torch.Tensor) -> torch.Tensor:
    """[B, heads, S, hd] -> [B, S, heads * hd]."""
    B, _, S, _ = o.shape
    return o.transpose(1, 2).reshape(B, S, -1)


# ---------------------------------------------------------------------------
# Sequence-parallel training step (the long-context path)
# ---------------------------------------------------------------------------

def _lm_targets_and_mask(tokens: torch.Tensor):
    """Global next-token targets and loss mask, built BEFORE sharding so a
    shard's last position targets the next shard's first token."""
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:], dtype=torch.float32),
                      torch.zeros_like(tokens[:, :1], dtype=torch.float32)], dim=1)
    return targets, mask


def _masked_ce(logits, targets, mask, device: torch.device) -> torch.Tensor:
    """Masked mean next-token cross-entropy over the slots' shards: the sum of
    their masked sums over the sum of their counts, each added in slot order on
    ``device`` (the reference's psum over the sharded axes)."""
    tot, cnt = [], []
    for lg, t, m in zip(logits, targets, mask):
        ll = torch.gather(F.log_softmax(lg, dim=-1), -1, t.long()[..., None])[..., 0]
        tot.append((-ll * m).sum())
        cnt.append(m.sum())
    return psum(tot, device) / psum(cnt, device)


def _split_tokens(t: torch.Tensor, rows: int, cols: int, devices) -> List[torch.Tensor]:
    """A [B, S] matrix cut into rows x cols blocks (row-major), each on its
    slot's device."""
    B, S = t.shape
    if B % rows or S % cols:
        raise ValueError(f"tokens {tuple(t.shape)} do not split over a {rows} x {cols} grid")
    blocks = [c for r in t.chunk(rows, dim=0) for c in r.chunk(cols, dim=1)]
    return [b.to(dev, non_blocking=True) for b, dev in zip(blocks, devices)]


def make_sp_train_step(
    model: TransformerLM,
    mesh: Mesh,
    learning_rate: float = 0.1,
    data_axis: str = DATA_AXIS,
    seq_axis: str = SEQ_AXIS,
    donate: bool = True,
):
    """A train step over ``mesh``: ``step(params, tokens) -> (new_params,
    loss)``, with the batch split over ``data_axis`` and the sequence over
    ``seq_axis`` (ring or a2a attention across each ring, ``sp_attn``).

    ``tokens`` is the GLOBAL [B, S] matrix; ``params`` a tree of tensors on the
    mesh's first slot (the home slot), replicated to every slot for the step.
    Each slot differentiates its own replica and the gradients are added in
    slot order on the home slot, so the parameters stay one tree. The loss,
    a device tensor on the home slot, is the masked mean next-token
    cross-entropy over the whole batch (plus ``moe_aux_weight`` times the mean
    of the slots' aux for MoE configs, whose experts run unsharded on each
    slot). ``donate=True`` updates ``params`` in place and returns them;
    ``donate=False`` leaves them untouched. Other mesh axes are not used: the
    step runs on their index 0."""
    cfg = model.config
    D, S = mesh.shape.get(data_axis, 1), mesh.shape.get(seq_axis, 1)
    slots = [mesh_slot(mesh, {data_axis: d, seq_axis: s}) for d in range(D) for s in range(S)]
    devices = [slot.device for slot in slots]
    rings = [[d * S + s for s in range(S)] for d in range(D)]

    def step(params, tokens):
        tokens = torch.as_tensor(tokens)
        with dispatch_scope(mesh):
            toks, tgts, masks = (_split_tokens(t, D, S, devices)
                                 for t in (tokens, *_lm_targets_and_mask(tokens)))
            offsets = [s * toks[0].shape[1] for _ in range(D) for s in range(S)]
            replicas = [tree_map(lambda p, dev=dev: replica(p, dev), params)
                        for dev in devices]
            leaves = [list(tree_leaves(r)) for r in replicas]
            with torch.enable_grad():
                logits, aux = model._forward(replicas, toks, offsets, rings)
                loss = _masked_ce(logits, tgts, masks, devices[0])
                if cfg.moe_experts:
                    # each slot routes its own tokens: the mean over slots keeps
                    # the weight comparable to the one-device objective
                    loss = loss + cfg.moe_aux_weight * (psum(aux, devices[0]) / len(slots))
                grads = torch.autograd.grad(loss, [g for slot in leaves for g in slot])
            n = len(leaves[0])
            with torch.no_grad():
                new = [sgd_update(p, grads[j::n], learning_rate, donate)
                       for j, p in enumerate(tree_leaves(params))]
        return tree_unflatten(params, new), loss.detach()

    return step


# ---------------------------------------------------------------------------
# Combined data x sequence x tensor parallel training step
# ---------------------------------------------------------------------------

def tp_param_specs(n_layers: int, model_axis: str) -> Dict[str, Any]:
    """The tensor-parallel parameter layout (wqkv split into wq/wk/wv), as the
    reference's PartitionSpecs: for each leaf a tuple naming the mesh axis each
    dimension is split over. Megatron-style column-parallel in-projections
    ``(None, model_axis)``, row-parallel out-projections ``(model_axis, None)``;
    ``()`` is replicated."""
    col, row = (None, model_axis), (model_axis, None)
    layer = {"ln1": (), "ln2": (), "wq": col, "wk": col, "wv": col, "wo": row,
             "w1": col, "w2": row}
    return {"embed": (), "pos": (), "ln_f": (),
            "layers": [dict(layer) for _ in range(n_layers)]}


def to_tp_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The LM's packed-wqkv parameter tree in the TP layout (wq/wk/wv apart, so
    each splits cleanly on its output dim)."""
    layers = []
    for layer in params["layers"]:
        d = layer["wqkv"].shape[-1] // 3
        w = layer["wqkv"]
        layers.append({"ln1": layer["ln1"], "ln2": layer["ln2"],
                       "wq": w[:, :d], "wk": w[:, d:2 * d], "wv": w[:, 2 * d:],
                       "wo": layer["wo"], "w1": layer["w1"], "w2": layer["w2"]})
    return {"embed": params["embed"], "pos": params["pos"],
            "ln_f": params["ln_f"], "layers": layers}


class ModelShards:
    """A parameter split over the model axis: ``shards[m]``, piece m along
    ``dim``, lies on the slot at model index m."""

    def __init__(self, shards: List[torch.Tensor], dim: int) -> None:
        self.shards = shards
        self.dim = dim

    def whole(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The shards joined, on ``device`` (shard 0's by default)."""
        dev = device or self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards], dim=self.dim)


def make_parallel_train_step(
    model: TransformerLM,
    mesh: Mesh,
    learning_rate: float = 0.1,
    data_axis: str = DATA_AXIS,
    seq_axis: str = SEQ_AXIS,
    model_axis: str = MODEL_AXIS,
    donate: bool = True,
):
    """The 3-axis train step: batch over ``data_axis``, sequence over
    ``seq_axis`` (ring or a2a attention, ``sp_attn``), and Megatron tensor
    parallelism over ``model_axis``: column-parallel wq/wk/wv and w1 with the
    heads split across the model shards, row-parallel wo and w2 whose partial
    products are added in model-index order.

    Returns ``(step, shard_params)``: ``shard_params(params)`` places a
    packed-wqkv tree in the TP layout (each split leaf a :class:`ModelShards`,
    shard m on the slot at (0, 0, m); the rest on the home slot (0, 0, 0));
    ``step(tp_params, tokens) -> (new_tp_params, loss)`` takes the GLOBAL
    token matrix. The replicated activations of a (data, seq) position are
    one tensor, on its model-index-0 slot: the loss is computed once for each
    position, and a replicated activation entering the model shards sends its
    gradients back summed in model-index order. ``donate`` as in
    :func:`make_sp_train_step`."""
    cfg = model.config
    if cfg.moe_experts:
        raise ValueError(
            "make_parallel_train_step is dense-only (its Megatron sharding "
            "splits w1/w2 over the model axis; MoE layers have no w1/w2) — "
            "train MoE configs with the single-device or sp steps, or run "
            "moe_ffn under expert parallelism directly")
    tp = mesh.shape.get(model_axis, 1)
    if cfg.n_heads % tp:
        raise ValueError(f"n_heads {cfg.n_heads} must divide by tensor "
                         f"parallelism {tp}")
    if cfg.d_ff % tp or cfg.d_model % tp:
        raise ValueError("d_model and d_ff must divide by tensor parallelism")
    h_loc = cfg.n_heads // tp
    D, S = mesh.shape.get(data_axis, 1), mesh.shape.get(seq_axis, 1)
    if cfg.sp_attn == "a2a" and h_loc % S:
        raise ValueError(
            f"sp_attn='a2a' needs per-TP-shard heads ({h_loc}) divisible by "
            f"the sequence axis ({S})")
    sp_attn_fn = a2a_attention if cfg.sp_attn == "a2a" else ring_attention
    specs = tp_param_specs(cfg.n_layers, model_axis)
    cells = [(d, s) for d in range(D) for s in range(S)]
    dev = {(d, s, m): mesh_slot(mesh, {data_axis: d, seq_axis: s, model_axis: m}).device
           for d, s in cells for m in range(tp)}
    home = dev[0, 0, 0]
    dtype = cfg.dtype

    def shard_params(params: Dict[str, Any]) -> Dict[str, Any]:
        tree = to_tp_params(params)
        if tree_map(lambda _: None, tree) != tree_map(lambda _: None, specs):
            raise ValueError("the parameter tree does not match tp_param_specs")
        out = []
        for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs)):
            t = torch.as_tensor(leaf)
            if model_axis in spec:
                dim = spec.index(model_axis)
                out.append(ModelShards(
                    [c.to(dev[0, 0, m], copy=True).contiguous()
                     for m, c in enumerate(t.chunk(tp, dim=dim))], dim))
            else:
                out.append(t.to(home, copy=True))
        return tree_unflatten(tree, out)

    def blocks(xs, layers):
        """One TP block on every (data, seq) position; ``layers[d, s, m]`` is
        the slot's replica of the layer (ln1/ln2 only at m = 0)."""
        q, k, v = {}, {}, {}
        for d, s in cells:
            xn = rms_norm(xs[d, s], layers[d, s, 0]["ln1"].to(dtype))
            for m, xm in enumerate(broadcast(xn, [dev[d, s, m] for m in range(tp)])):
                # one product for q, k and v: xm then has one gradient consumer
                # (three would add into it in the order their backward passes
                # finish, which the other slots of k's and v's rings decide)
                lay = layers[d, s, m]
                wqkv = torch.cat([lay["wq"], lay["wk"], lay["wv"]], dim=1).to(dtype)
                q[d, s, m], k[d, s, m], v[d, s, m] = (
                    _to_heads(t, h_loc) for t in (xm @ wqkv).chunk(3, dim=-1))
        o = {}
        for d in range(D):
            for m in range(tp):
                ring = [(d, s, m) for s in range(S)]
                o.update(zip(ring, sp_attn_fn([q[c] for c in ring], [k[c] for c in ring],
                                              [v[c] for c in ring], causal=True)))
        out = {}
        for d, s in cells:
            x = xs[d, s] + psum([_from_heads(o[d, s, m]) @ layers[d, s, m]["wo"].to(dtype)
                                 for m in range(tp)], dev[d, s, 0])
            xn = rms_norm(x, layers[d, s, 0]["ln2"].to(dtype))
            hidden = [F.gelu(xm @ layers[d, s, m]["w1"].to(dtype), approximate="tanh")
                      @ layers[d, s, m]["w2"].to(dtype)
                      for m, xm in enumerate(broadcast(xn, [dev[d, s, m] for m in range(tp)]))]
            out[d, s] = x + psum(hidden, dev[d, s, 0])
        return out

    def step(tp_params, tokens):
        tokens = torch.as_tensor(tokens)
        home_devs = [dev[d, s, 0] for d, s in cells]
        params = list(tree_leaves(tp_params))
        split = [model_axis in spec for spec in tree_leaves(specs)]
        with dispatch_scope(mesh):
            toks, tgts, masks = (_split_tokens(t, D, S, home_devs)
                                 for t in (tokens, *_lm_targets_and_mask(tokens)))
            S_loc = toks[0].shape[1]
            # each slot's replicas: the split leaves' shard m at (d, s, m), the
            # replicated leaves at (d, s, 0) only
            reps = {(d, s, m): [(replica(p.shards[m], dev[d, s, m]) if is_split
                                 else replica(p, dev[d, s, m]) if m == 0 else None)
                                for p, is_split in zip(params, split)]
                    for d, s in cells for m in range(tp)}
            trees = {c: tree_unflatten(tp_params, r) for c, r in reps.items()}
            with torch.enable_grad():
                xs = {(d, s): _embed_in(cfg, trees[d, s, 0]["embed"], trees[d, s, 0]["pos"],
                                        toks[i], s * S_loc)
                      for i, (d, s) in enumerate(cells)}
                for i in range(cfg.n_layers):
                    xs = blocks(xs, {c: t["layers"][i] for c, t in trees.items()})
                logits = [rms_norm(xs[c], trees[c + (0,)]["ln_f"].to(dtype)).float()
                          @ trees[c + (0,)]["embed"].T for c in cells]
                loss = _masked_ce(logits, tgts, masks, home)
                # each replica's gradient goes to (leaf, shard) in slot order
                wrt, where = [], []
                for c, r in reps.items():
                    for j, p in enumerate(r):
                        if p is not None:
                            wrt.append(p)
                            where.append((j, c[2] if split[j] else 0))
                grads = torch.autograd.grad(loss, wrt)
            by_leaf = {}
            for key, g in zip(where, grads):
                by_leaf.setdefault(key, []).append(g)
            with torch.no_grad():
                new = []
                for j, p in enumerate(params):
                    if split[j]:
                        shards = [sgd_update(w, by_leaf[j, m], learning_rate, donate)
                                  for m, w in enumerate(p.shards)]
                        new.append(p if donate else ModelShards(shards, p.dim))
                    else:
                        new.append(sgd_update(p, by_leaf[j, 0], learning_rate, donate))
        return tree_unflatten(tp_params, new), loss.detach()

    return step, shard_params


# ---------------------------------------------------------------------------
# Expert- and pipeline-parallel training steps
# ---------------------------------------------------------------------------

def make_ep_train_step(
    model: TransformerLM,
    mesh: Mesh,
    learning_rate: float = 0.1,
    data_axis: str = DATA_AXIS,
    donate: bool = True,
):
    """The expert- and data-parallel step for MoE configs: the batch splits
    over ``data_axis`` and each MoE block's experts split over the same slots,
    ``moe_experts / D`` a slot; the token buckets go to their experts' slot and
    back (``models/moe.py``). Attention and the dense blocks run on each slot
    alone.

    Returns ``(step, shard_params)``: ``shard_params(params)`` places each MoE
    layer's ``w1``/``w2`` as a :class:`ModelShards` over the data slots (shard
    d on the slot at data index d, split on the expert dimension) and every
    other leaf on the home slot; ``step(ep_params, tokens) -> (new_ep_params,
    loss)`` takes the GLOBAL token matrix. The loss, a device tensor on the
    home slot, is the masked mean next-token cross-entropy over the batch plus
    ``moe_aux_weight`` times the mean of the slots' aux (added in slot order).
    A replicated leaf's gradients are added in slot order on the home slot; an
    expert shard takes its own slot's. ``donate`` as in
    :func:`make_sp_train_step`."""
    cfg = model.config
    ep = mesh.shape[data_axis]
    if not cfg.moe_experts:
        raise ValueError("make_ep_train_step needs an MoE config "
                         "(moe_experts > 0); use the dp/sp steps for dense")
    if cfg.moe_experts % ep:
        raise ValueError(f"moe_experts {cfg.moe_experts} must divide by the "
                         f"{data_axis} axis size {ep}")
    devices = [mesh_slot(mesh, {data_axis: d}).device for d in range(ep)]
    home = devices[0]

    def shard_params(params: Dict[str, Any]) -> Dict[str, Any]:
        tree = tree_map(torch.as_tensor, params)
        for layer in tree["layers"]:
            if "moe" in layer:
                for key in ("w1", "w2"):
                    layer["moe"][key] = ModelShards(
                        [c.to(dev, copy=True).contiguous()
                         for c, dev in zip(layer["moe"][key].chunk(ep, dim=0), devices)], 0)
        return tree_map(lambda t: t if isinstance(t, ModelShards) else t.to(home, copy=True),
                        tree)

    def step(ep_params, tokens):
        tokens = torch.as_tensor(tokens)
        params = list(tree_leaves(ep_params))
        with dispatch_scope(mesh):
            toks, tgts, masks = (_split_tokens(t, ep, 1, devices)
                                 for t in (tokens, *_lm_targets_and_mask(tokens)))
            reps = [[replica(p.shards[d] if isinstance(p, ModelShards) else p, dev)
                     for p in params] for d, dev in enumerate(devices)]
            with torch.enable_grad():
                logits, aux = model._forward([tree_unflatten(ep_params, r) for r in reps],
                                             toks, [0] * ep, experts=True)
                loss = _masked_ce(logits, tgts, masks, home)
                loss = loss + cfg.moe_aux_weight * (psum(aux, home) / ep)
                grads = torch.autograd.grad(loss, [p for r in reps for p in r])
            n = len(params)
            with torch.no_grad():
                new = []
                for j, p in enumerate(params):
                    if isinstance(p, ModelShards):
                        shards = [sgd_update(w, [grads[d * n + j]], learning_rate, donate)
                                  for d, w in enumerate(p.shards)]
                        new.append(p if donate else ModelShards(shards, p.dim))
                    else:
                        new.append(sgd_update(p, grads[j::n], learning_rate, donate))
        return tree_unflatten(ep_params, new), loss.detach()

    return step, shard_params


def make_pp_train_step(
    model: TransformerLM,
    mesh: Mesh,
    learning_rate: float = 0.1,
    num_microbatches: Optional[int] = None,
    stage_axis: str = STAGE_AXIS,
    donate: bool = True,
):
    """The pipeline-parallel step: the LM's blocks split into S contiguous
    stages over ``stage_axis`` (GPipe microbatching, ``parallel/pipeline.py``;
    ``num_microbatches`` defaults to S); the embedding, positions and final
    norm stay on the home slot (stage 0's) and run outside the pipeline.

    Returns ``(step, shard_params)``: ``shard_params(params)`` places stage
    s's ``n_layers / S`` layers (``pp["stages"][s]``, a list of layer trees)
    on stage s's slot and ``embed``, ``pos`` and ``ln_f`` on the home slot;
    ``step(pp_params, tokens) -> (new_pp_params, loss)`` is one SGD step on
    ``model.loss``'s objective, the mean next-token cross-entropy of
    ``tokens[:, :-1]`` against ``tokens[:, 1:]``, a device tensor on the home
    slot. ``donate`` as in :func:`make_sp_train_step`."""
    cfg = model.config
    if cfg.moe_experts:
        raise ValueError(
            "make_pp_train_step needs homogeneous layers to stage-stack; "
            "MoE configs interleave two layer structures — use the sp/dp "
            "steps (or set moe_experts=0)"
        )
    S = mesh.shape[stage_axis]
    if cfg.n_layers % S:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible into "
                         f"{S} pipeline stages")
    lps = cfg.n_layers // S
    devices = [mesh_slot(mesh, {stage_axis: s}).device for s in range(S)]
    home = devices[0]

    def stage_fn(layers, x):
        for layer in layers:
            x, _ = model._block(x, layer)
        return x

    pipe = make_pipeline_fn(stage_fn, mesh, axis_name=stage_axis,
                            num_microbatches=num_microbatches)

    def shard_params(params: Dict[str, Any]) -> Dict[str, Any]:
        layers = [tree_map(lambda a, dev=devices[i // lps]: torch.as_tensor(a).to(dev, copy=True),
                           layer) for i, layer in enumerate(params["layers"])]
        return {**{k: torch.as_tensor(params[k]).to(home, copy=True)
                   for k in ("embed", "pos", "ln_f")},
                "stages": [layers[s * lps:(s + 1) * lps] for s in range(S)]}

    def step(pp_params, tokens):
        tokens = torch.as_tensor(tokens)
        params = list(tree_leaves(pp_params))
        with dispatch_scope(mesh):
            tokens = tokens.to(home, non_blocking=True)
            reps = [replica(p, p.device) for p in params]
            pp = tree_unflatten(pp_params, reps)
            with torch.enable_grad():
                x = _embed_in(cfg, pp["embed"], pp["pos"], tokens[:, :-1])
                h = rms_norm(pipe(pp["stages"], x), pp["ln_f"].to(cfg.dtype))
                # weight-tied readout, f32 logits
                loss = _next_token_ce(h.float() @ pp["embed"].T, tokens[:, 1:])
                grads = torch.autograd.grad(loss, reps)
            with torch.no_grad():
                new = [sgd_update(p, [g], learning_rate, donate) for p, g in zip(params, grads)]
        return tree_unflatten(pp_params, new), loss.detach()

    return step, shard_params


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
