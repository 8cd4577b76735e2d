"""Factorization Machine + Wide&Deep — sparse-embedding recommenders.

Counterpart of ``harmony_tpu/apps/widedeep.py`` (BASELINE config 5), dense
mode: one hash-partitioned table of width ``1 + k`` holds every parameter,
``pull_mode = "keys"``, so each step's PULL is a keyed gather (K1) and its PUSH
a keyed additive push whose duplicate keys fold on the device (K3, or K2 under
the sparse route). Model layout:

  key 0..vocab-1   : [w_i, v_i[0..k-1]]   per-feature wide weight + embedding
  key vocab        : [w0, 0...]           global bias
  key vocab+1...   : raveled MLP params   (WideDeepTrainer only), in rows of
                     the same width so deep weights ride the same keyed path.

FM score:  w0 + Σ_s w[id_s] + ½ Σ_f [(Σ_s v[id_s])² − Σ_s v[id_s]²]
Wide&Deep: wide term + MLP(concat of the S slot embeddings).
Data: (ids [B, S] int32 slot-feature ids, y [B] 0/1 labels).

Not ported yet: sparse mode (``sparse=True``, a DeviceHashTable over the whole
int32 key domain).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.dolphin.trainer import Trainer


def _logistic_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean of ``max(x, 0) − x·y + log1p(exp(−|x|))``, the reference's form."""
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits)) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


class FMTrainer(Trainer):
    pull_mode = "keys"

    init_scale: float = 0.05
    seed: int = 0

    def __init__(
        self,
        vocab_size: int,
        num_slots: int,
        emb_dim: int = 8,
        step_size: float = 0.1,
        l2: float = 1e-4,
        sparse: bool = False,
        slot_budget: int = 0,
    ) -> None:
        if sparse:
            raise NotImplementedError(
                "sparse mode (a hash-backed table over the int32 key domain) "
                "is not ported yet; use sparse=False")
        self.vocab_size = vocab_size
        self.num_slots = num_slots
        self.k = emb_dim
        self.step_size = step_size
        self.l2 = l2

    # -- table schema ----------------------------------------------------

    @property
    def width(self) -> int:
        return 1 + self.k

    @property
    def num_extra_rows(self) -> int:
        return 1  # the bias row

    @property
    def extra_base(self) -> int:
        """First reserved (non-embedding) key: right after the vocabulary."""
        return self.vocab_size

    def model_table_config(self, table_id: str = "fm-model",
                           num_blocks: int = 0) -> TableConfig:
        cap = self.vocab_size + self.num_extra_rows
        return TableConfig(
            table_id=table_id,
            capacity=cap,
            value_shape=(self.width,),
            num_blocks=num_blocks or min(cap, 256),
            is_ordered=False,          # hash-partitioned: the sparse case
            update_fn="add",
        )

    def hyperparams(self) -> Dict[str, float]:
        return {"lr": self.step_size}

    # -- lifecycle -------------------------------------------------------

    def init_global_settings(self, ctx) -> None:
        """Seed embedding vectors with small noise (zero embeddings make the FM
        interaction term identically zero); wide weights and bias start at 0.
        The same numpy draws as the reference, so both packages start from
        the same bytes."""
        if self.init_scale <= 0:
            return
        rng = np.random.default_rng(self.seed)
        rows = np.zeros((self.vocab_size, self.width), np.float32)
        rows[:, 1:] = rng.normal(scale=self.init_scale,
                                 size=(self.vocab_size, self.k))
        ctx.model_table.multi_put(np.arange(self.vocab_size), rows)
        extra = self._init_extra_rows(rng)
        if extra is not None:
            ctx.model_table.multi_put(
                np.arange(self.extra_base, self.extra_base + len(extra)), extra)

    def _init_extra_rows(self, rng) -> "np.ndarray | None":
        return None  # FM: bias row stays zero

    # -- compute ---------------------------------------------------------

    def pull_keys(self, batch) -> torch.Tensor:
        """The batch's embedding rows + the tail rows (bias / MLP), as one
        keyed pull."""
        ids = batch[0]
        extra = self.extra_base + torch.arange(
            self.num_extra_rows, dtype=torch.int32, device=ids.device)
        return torch.cat([ids.reshape(-1), extra])

    def _split(self, rows: torch.Tensor, B: int):
        """rows [B*S + extra, width] -> (w [B,S], v [B,S,k], tail rows)."""
        n = B * self.num_slots
        emb = rows[:n].reshape(B, self.num_slots, self.width)
        return emb[..., 0], emb[..., 1:], rows[n:]

    def _scores(self, w, v, tail):
        lin = w.sum(dim=1) + tail[0, 0]                      # [B]
        sv = v.sum(dim=1)                                    # [B, k]
        inter = 0.5 * (sv * sv - (v * v).sum(dim=1)).sum(dim=-1)
        return lin + inter

    def compute(self, model, batch, hyper):
        """Loss on the pulled rows and its gradient with respect to those rows
        (``torch.autograd.grad`` where the reference takes
        ``jax.value_and_grad``); the delta is ``-lr * grad``. A duplicated id
        gets one gradient row per occurrence; the push folds them."""
        ids, y = batch
        B = ids.shape[0]
        with torch.enable_grad():
            rows = model.detach().requires_grad_(True)
            w, v, tail = self._split(rows, B)
            ce = _logistic_loss(self._scores(w, v, tail), y)
            loss = ce + self.l2 * (rows * rows).mean()
            (grads,) = torch.autograd.grad(loss, rows)
        return -hyper["lr"] * grads, {"loss": ce.detach()}

    def _gather_rows(self, model: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The fused step's pulled-row layout, from the full [capacity, width]
        table (evaluation path)."""
        tail = model[self.vocab_size:self.vocab_size + self.num_extra_rows]
        return torch.cat([model[ids.reshape(-1).long()], tail])

    def evaluate(self, model, batch) -> Dict[str, torch.Tensor]:
        ids, y = batch
        B = ids.shape[0]
        logits = self._scores(*self._split(self._gather_rows(model, ids), B))
        acc = torch.mean((((logits > 0).float()) == y).float())
        return {"loss": _logistic_loss(logits, y), "accuracy": acc}


class WideDeepTrainer(FMTrainer):
    """FM wide term + a one-hidden-layer MLP over the concatenated slot
    embeddings (the deep tower), deep weights stored as extra table rows."""

    def __init__(
        self,
        vocab_size: int,
        num_slots: int,
        emb_dim: int = 8,
        hidden: int = 32,
        step_size: float = 0.1,
        l2: float = 1e-4,
        sparse: bool = False,
        slot_budget: int = 0,
    ) -> None:
        super().__init__(vocab_size, num_slots, emb_dim, step_size, l2,
                         sparse=sparse, slot_budget=slot_budget)
        self.hidden = hidden
        d_in = num_slots * emb_dim
        # raveled [W1 (d_in x h), b1 (h), W2 (h), b2 (1)]
        self._n_mlp = d_in * hidden + hidden + hidden + 1

    @property
    def num_extra_rows(self) -> int:
        return 1 + -(-self._n_mlp // self.width)  # bias row + MLP rows

    def _init_extra_rows(self, rng) -> np.ndarray:
        """Bias row (zeros) + He-init W1 / small W2, raveled into rows."""
        d_in, h = self.num_slots * self.k, self.hidden
        flat = np.zeros((self._n_mlp,), np.float32)
        flat[: d_in * h] = rng.normal(scale=(2.0 / d_in) ** 0.5, size=d_in * h)
        o = d_in * h + h
        flat[o:o + h] = rng.normal(scale=h ** -0.5, size=h)
        n_rows = self.num_extra_rows - 1
        padded = np.zeros((n_rows * self.width,), np.float32)
        padded[: self._n_mlp] = flat
        return np.concatenate(
            [np.zeros((1, self.width), np.float32),      # bias row
             padded.reshape(n_rows, self.width)]
        )

    def _mlp(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        d_in, h = self.num_slots * self.k, self.hidden
        o = 0
        W1 = flat[o:o + d_in * h].reshape(d_in, h); o += d_in * h
        b1 = flat[o:o + h]; o += h
        W2 = flat[o:o + h]; o += h
        b2 = flat[o]
        z = torch.relu(x @ W1 + b1)  # f32 product: TF32 is off (worker.run)
        return z @ W2 + b2

    def _scores(self, w, v, tail):
        B = w.shape[0]
        wide = w.sum(dim=1) + tail[0, 0]
        flat = tail[1:].reshape(-1)[: self._n_mlp]
        return wide + self._mlp(flat, v.reshape(B, -1))


def make_synthetic(
    n: int, vocab_size: int, num_slots: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic CTR data (the reference's generator, the same numpy draws):
    each slot draws a feature id from its own range; the label depends on a
    hidden per-feature affinity plus a pairwise interaction."""
    rng = np.random.default_rng(seed)
    per = vocab_size // num_slots
    ids = np.stack(
        [s * per + rng.integers(0, per, size=n) for s in range(num_slots)], axis=1
    ).astype(np.int32)
    affinity = rng.normal(scale=1.0, size=vocab_size)
    hidden = rng.normal(scale=0.7, size=(vocab_size, 4))
    lin = affinity[ids].sum(axis=1)
    sv = hidden[ids].sum(axis=1)
    inter = 0.5 * ((sv * sv).sum(-1) - (hidden[ids] ** 2).sum(axis=(1, 2)))
    logits = 0.8 * lin + 0.3 * inter - np.median(0.8 * lin + 0.3 * inter)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return ids, y
