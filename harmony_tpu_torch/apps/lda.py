"""LDA topic modelling — collapsed Gibbs sampling with per-batch stale counts.

Counterpart of ``harmony_tpu/apps/lda.py``, dense mode. The model table holds
the topic-word counts (key = word, value = [K] counts) and, at key V, the
topic summary n_k; the worker-local table holds each document's current topic
per token (int32, -1 = unset). A step holds the counts fixed for the whole
mini-batch and samples every token's new topic at once from

    p(z = k)  ∝  (n_dk + alpha) (n_kw + beta) / (n_k + V beta)

(the token's own count excluded), then pushes the count deltas (new minus
old assignments) as one dense add. The draws are ``jax.random``'s, bit for
bit (:mod:`harmony_tpu_torch.utils.prng`): each document's key is
``fold_in(PRNGKey(seed), epoch)`` and its topics ``categorical`` over the
logits, so on the same logits the port draws what the reference draws. The
count delta is an ``index_add_`` of integer-valued f32, exact in any order
below 2**24.

Data: (doc_idx [B], tokens [B, L] word ids with -1 padding, seeds [B]).

Not ported yet: sparse mode (``sparse=True``, topic-word counts in a
DeviceHashTable over the int32 key domain; ROADMAP A.4).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.dolphin.trainer import Trainer, TrainerContext
from harmony_tpu_torch.utils import prng

# The reference's sparse mode reserves the top of the hash table's key domain
# (harmony_tpu/table/hashtable.py MAX_KEY) for the summary row and a pad sink.
MAX_KEY = 2**31 - 3
LDA_SUMMARY_KEY = MAX_KEY
LDA_PAD_KEY = MAX_KEY - 1
LDA_MAX_WORD_KEY = MAX_KEY - 2


def _one_hot(z: torch.Tensor, k: int, keep: torch.Tensor) -> torch.Tensor:
    """f32 one-hot of ``z`` over ``k`` topics, zero where ``keep`` is False."""
    hot = torch.nn.functional.one_hot(torch.where(keep, z, 0).long(), k).float()
    return hot * keep[..., None].float()


class LDATrainer(Trainer):
    pull_mode = "all"
    uses_local_table = True
    objective_metric = "log_likelihood"
    # the PRNG epoch fold depends only on epoch_idx
    epoch_hook_windowable = True

    def __init__(
        self,
        vocab_size: int,
        num_topics: int,
        num_docs: int,
        max_doc_len: int,
        alpha: float = 0.1,
        beta: float = 0.01,
        sparse: bool = False,
        slot_budget: int = 0,
    ) -> None:
        if sparse:
            raise NotImplementedError(
                "sparse LDA (topic-word counts in a DeviceHashTable) is not ported "
                "yet (ROADMAP A.4); use sparse=False")
        self.vocab_size = vocab_size
        self.num_topics = num_topics
        self.num_docs = num_docs
        self.max_doc_len = max_doc_len
        self.alpha = alpha
        self.beta = beta
        self._epoch = 0

    def hyperparams(self) -> Dict[str, float]:
        # the epoch is folded into every document's key, so each sweep draws
        # fresh randomness
        return {"epoch": float(self._epoch)}

    def on_training_start(self, ctx: TrainerContext, starting_epoch: int) -> None:
        self._epoch = starting_epoch

    def on_epoch_finished(self, ctx: TrainerContext, epoch_idx: int) -> None:
        self._epoch = epoch_idx + 1

    def model_table_config(self, table_id: str = "lda-model") -> TableConfig:
        """word -> [K] topic counts; the summary row n_k at key vocab_size."""
        return TableConfig(
            table_id=table_id,
            capacity=self.vocab_size + 1,
            value_shape=(self.num_topics,),
            num_blocks=min(self.vocab_size + 1, 64),
            update_fn="add",
        )

    def local_table_config(self, table_id: str = "lda-local") -> TableConfig:
        """doc -> [max_len] current topic of each token (-1 = unset)."""
        return TableConfig(
            table_id=table_id,
            capacity=self.num_docs,
            value_shape=(self.max_doc_len,),
            num_blocks=min(self.num_docs, 64),
            update_fn="assign",
            dtype="int32",
        )

    def init_global_settings(self, ctx: TrainerContext) -> None:
        if ctx.local_table is not None:
            ctx.local_table.write_all(
                np.full((self.num_docs, self.max_doc_len), -1, np.int32))

    def compute_with_local(self, model, local, batch, hyper):
        """``model`` is the full [V+1, K] count table (row V = summary),
        ``local`` the [num_docs, L] assignments."""
        doc_idx, tokens, seeds = batch       # [B], [B, L], [B]
        K, V = self.num_topics, self.vocab_size
        docs = doc_idx.long()
        valid = tokens >= 0
        word = torch.where(valid, tokens, 0).long()
        old_z = local[docs]                  # [B, L]
        old_onehot = _one_hot(old_z, K, (old_z >= 0) & valid)   # [B, L, K]
        n_kw = model[word]                   # [B, L, K]
        n_k = model[V]                       # [K]
        n_dk = old_onehot.sum(dim=1, keepdim=True)              # [B, 1, K]

        # the token's own assignment excluded (collapsed semantics)
        logits = (
            torch.log(torch.clamp_min(n_dk - old_onehot + self.alpha, 1e-10))
            + torch.log(torch.clamp_min(n_kw - old_onehot + self.beta, 1e-10))
            - torch.log(torch.clamp_min(n_k[None, None, :] - old_onehot
                                        + V * self.beta, 1e-10))
        )                                    # [B, L, K]
        epoch = hyper["epoch"].to(torch.int64)          # the reference's uint32 cast
        keys = prng.fold_in(prng.PRNGKey(seeds.to(torch.int64) & prng.MASK), epoch)
        z_new = prng.categorical(keys, logits).to(torch.int32)
        z_new = torch.where(valid, z_new, -1)           # [B, L]

        flat_delta = (_one_hot(z_new, K, z_new >= 0) - old_onehot).reshape(-1, K)
        delta = torch.zeros_like(model)
        delta.index_add_(0, word.reshape(-1), flat_delta)
        delta[V] += flat_delta.sum(dim=0)

        new_local = local.index_put((docs,), z_new)
        # progress: mean log-weight of the sampled topics (stale counts)
        chosen = torch.gather(logits, -1, z_new.clamp_min(0).long()[..., None])[..., 0]
        ll = torch.sum(chosen * valid) / torch.clamp_min(valid.sum(), 1)
        return delta, new_local, {"log_likelihood": ll}

    def evaluate(self, model, batch) -> Dict[str, torch.Tensor]:
        raise NotImplementedError("LDA progress is tracked via log_likelihood")


def make_synthetic(num_docs: int, vocab_size: int, num_topics: int, doc_len: int,
                   seed: int = 0):
    """Documents from a true topic model, the reference's numpy draws: each
    document takes 90% of its words from its own topic's slice of the
    vocabulary and 10% uniformly."""
    rng = np.random.default_rng(seed)
    words_per_topic = vocab_size // num_topics
    doc_idx = np.arange(num_docs, dtype=np.int32)
    lo = ((doc_idx % num_topics) * words_per_topic).astype(np.int64)[:, None]
    own = rng.integers(lo, lo + words_per_topic, (num_docs, doc_len))
    noise = rng.integers(0, vocab_size, (num_docs, doc_len))
    pick = rng.random((num_docs, doc_len)) < 0.9
    tokens = np.where(pick, own, noise).astype(np.int32)
    seeds = rng.integers(0, 2**31 - 1, num_docs).astype(np.int32)
    return doc_idx, tokens, seeds
