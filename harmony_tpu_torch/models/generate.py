"""Incremental decoding for the transformer LM: KV-cache generation.

Counterpart of ``harmony_tpu/models/generate.py``. The cache is one
preallocated ``[L, B, H, max_seq, head_dim]`` pair of tensors in the config's
dtype, written in place one position a step (never rebuilt: restacking the
layers would copy the whole cache every token). Prefill fills it from the
whole prompt in one batched causal forward; each decode step attends over the
whole cache under a position mask. Both attend with a plain masked softmax in
f32, as the reference does outside any Pallas kernel: the query is one row, so
the flash kernels' tiling buys nothing.

The reference's ``lax.scan`` over the new tokens becomes a host loop that
enqueues each step without waiting for the card: the position is a slice of a
device tensor made once, and the sampled token stays on the device
(``torch.tensor(v, device=...)`` would wait for the card every step). Greedy
decoding is an argmax; at a temperature above 0 each step draws
``categorical(step_key, logits / T)`` with the step keys of
``jax.random.split(key, num_new)``, jax's threefry bits (``utils/prng.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from harmony_tpu_torch.models.common import rms_norm
from harmony_tpu_torch.models.transformer import TransformerLM, ffn_apply
from harmony_tpu_torch.utils import prng
from harmony_tpu_torch.utils.platform import DeviceLike, full_f32_matmuls, resolve_device

_NEG_INF = -1e30
Cache = Dict[str, torch.Tensor]


def init_kv_cache(cfg, batch: int, device: DeviceLike = None) -> Cache:
    """Per-layer K/V buffers, stacked over layers: [L, B, H, max_seq, hd], on
    ``device`` (the card unless asked otherwise)."""
    shape = (cfg.n_layers, batch, cfg.n_heads, cfg.max_seq, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _attend(q, k, v, masked, hd):
    """Softmax attention in f32 with the ``masked`` scores at -1e30, cast back
    to q's dtype."""
    s = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
    return (torch.softmax(s.masked_fill(masked, _NEG_INF), dim=-1) @ v.float()).to(q.dtype)


def cast_params(cfg, params):
    """``params`` with each block's dense weights and norms, and ``ln_f``, in
    the activation dtype: the casts every step would repeat give the same
    values once (the expert weights, the embeddings and the positions stay
    f32, as the steps read them)."""
    def cast(layer):
        return {k: v if k == "moe" else v.to(cfg.dtype) for k, v in layer.items()}

    return {**params, "ln_f": params["ln_f"].to(cfg.dtype),
            "layers": [cast(layer) for layer in params["layers"]]}


def decode_step(model: TransformerLM, params, cache: Cache, token: torch.Tensor,
                pos: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One token for the whole batch: ``token`` [B] at position ``pos`` (a
    one-element int64 tensor on the cache's device). Writes this position's
    keys and values into ``cache`` in place; returns (logits [B, vocab] f32,
    cache)."""
    cfg = model.config
    B = token.shape[0]
    h, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    x = (params["embed"][token.long()] + params["pos"].index_select(0, pos)).to(cfg.dtype)
    later = torch.arange(cfg.max_seq, device=pos.device) > pos    # [S]: attend to <= pos
    for i, layer in enumerate(params["layers"]):
        xn = rms_norm(x, layer["ln1"].to(cfg.dtype))
        q, k, v = (xn @ layer["wqkv"].to(cfg.dtype)).split(d, dim=-1)
        cache["k"][i].index_copy_(2, pos, k.reshape(B, h, 1, hd))
        cache["v"][i].index_copy_(2, pos, v.reshape(B, h, 1, hd))
        o = _attend(q.reshape(B, h, 1, hd), cache["k"][i], cache["v"][i], later, hd)
        x = x + o.reshape(B, d) @ layer["wo"].to(cfg.dtype)
        xn = rms_norm(x, layer["ln2"].to(cfg.dtype))
        x = x + ffn_apply(cfg, layer, xn, no_drop=True)[0]
    xf = rms_norm(x, params["ln_f"].to(cfg.dtype))
    return xf.float() @ params["embed"].T, cache


def prefill(model: TransformerLM, params, cache: Cache,
            prompt: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """Fill the cache from the whole prompt [B, P] in one batched causal
    forward (the LM's block math, attention as a masked softmax); returns the
    last position's logits [B, vocab] f32 and the cache."""
    cfg = model.config
    B, P = prompt.shape
    h, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    idx = torch.arange(P, device=prompt.device)
    x = (params["embed"][prompt.long()] + params["pos"][idx]).to(cfg.dtype)   # [B, P, d]
    above = idx[:, None] < idx[None, :]            # [P, P]: the keys after each query
    for i, layer in enumerate(params["layers"]):
        xn = rms_norm(x, layer["ln1"].to(cfg.dtype))
        qh, kh, vh = (t.reshape(B, P, h, hd).transpose(1, 2)
                      for t in (xn @ layer["wqkv"].to(cfg.dtype)).split(d, dim=-1))
        cache["k"][i, :, :, :P] = kh
        cache["v"][i, :, :, :P] = vh
        o = _attend(qh, kh, vh, above, hd)
        x = x + o.transpose(1, 2).reshape(B, P, d) @ layer["wo"].to(cfg.dtype)
        xn = rms_norm(x, layer["ln2"].to(cfg.dtype))
        x = x + ffn_apply(cfg, layer, xn, no_drop=True)[0]
    xf = rms_norm(x[:, -1], params["ln_f"].to(cfg.dtype))
    return xf.float() @ params["embed"].T, cache


def make_generate_fn(model: TransformerLM, prompt_len: int, num_new: int,
                     temperature: float = 0.0):
    """``generate(params, prompt [B, prompt_len], key=None) -> tokens [B,
    prompt_len + num_new]`` int32 on the params' device: one prefill, then
    ``num_new`` decode steps, greedy at temperature 0. ``key`` is a jax-style
    key ``[2]`` (``prng.PRNGKey``); None means ``PRNGKey(0)``.
    ``prompt_len + num_new`` must fit ``config.max_seq``."""
    cfg = model.config
    total = prompt_len + num_new
    if total > cfg.max_seq:
        raise ValueError(f"prompt_len + num_new = {total} exceeds max_seq {cfg.max_seq}")
    full_f32_matmuls()

    def pick(logits, key):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        return prng.categorical(key, logits / temperature)

    def generate(params, prompt, key: Optional[torch.Tensor] = None) -> torch.Tensor:
        dev = params["embed"].device
        prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
        if prompt.shape[1] != prompt_len:
            raise ValueError(f"prompt of {prompt.shape[1]} tokens, expected {prompt_len}")
        if key is None:
            key = prng.PRNGKey(torch.zeros((), dtype=torch.int64, device=dev))
        keys = prng.split(key.to(dev), num_new)
        positions = torch.arange(prompt_len, total, device=dev)
        out = torch.empty((prompt.shape[0], num_new), dtype=torch.int32, device=dev)
        with torch.no_grad():
            params = cast_params(cfg, params)
            cache = init_kv_cache(cfg, prompt.shape[0], dev)
            logits, cache = prefill(model, params, cache, prompt)
            for j in range(num_new):
                tok = pick(logits, keys[j])
                out[:, j] = tok
                logits, cache = decode_step(model, params, cache, tok, positions[j:j + 1])
        return torch.cat([prompt, out], dim=1)

    return generate
