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

``sparse=True`` holds the topic-word counts in a ``DeviceHashTable``: word ids
come from the whole int32 domain [1, LDA_MAX_WORD_KEY], the step pulls one
row per token position (padding goes to a pad row whose delta is zero) plus
the summary row at LDA_SUMMARY_KEY, and the hash push folds duplicate words.
:meth:`LDATrainer.mask_delta` keeps the summary row equal to the sum of the
word rows the table admitted.

On a data axis > 1 the step splits (``row_part``, ``row_finish``). A
document's draws depend only on its own seed, the epoch, its own assignments
and the batch's stale counts, never on the row that holds it, so each row
samples its own documents; the count deltas are integer-valued f32 and add up
exactly (dense: the rows' whole-table deltas summed; sparse: each row's keyed
delta pushed beside the others'), and the finish takes the log-likelihood's
sum and count over the rows.

Data: (doc_idx [B], tokens [B, L] word ids with -1 padding, seeds [B]).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.dolphin.trainer import RowResult, Trainer, TrainerContext
from harmony_tpu_torch.table.hashtable import MAX_KEY
from harmony_tpu_torch.utils import prng

# Sparse mode reserves the top of the hash table's valid key space: the topic
# summary row and a pad sink for masked token positions (deltas there are
# always zero). Derived from MAX_KEY, as in the reference.
LDA_SUMMARY_KEY = MAX_KEY
LDA_PAD_KEY = MAX_KEY - 1
LDA_MAX_WORD_KEY = MAX_KEY - 2


def _one_hot(z: torch.Tensor, k: int, keep: torch.Tensor) -> torch.Tensor:
    """f32 one-hot of ``z`` over ``k`` topics, zero where ``keep`` is False."""
    hot = torch.nn.functional.one_hot(torch.where(keep, z, 0).long(), k).float()
    return hot * keep[..., None].float()


class LDATrainer(Trainer):
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
        """``sparse=True`` holds the topic-word counts in a DeviceHashTable:
        word ids come from [1, LDA_MAX_WORD_KEY] and ``slot_budget`` bounds
        admitted words (default 4 x vocab_size); ``vocab_size`` still enters
        the sampler's V*beta term as the notional vocabulary size."""
        self.sparse = sparse
        self.slot_budget = slot_budget or 4 * vocab_size
        self.vocab_size = vocab_size
        self.num_topics = num_topics
        self.num_docs = num_docs
        self.max_doc_len = max_doc_len
        self.alpha = alpha
        self.beta = beta
        self._epoch = 0

    @property
    def pull_mode(self) -> str:
        return "keys" if self.sparse else "all"

    def hyperparams(self) -> Dict[str, float]:
        # the epoch is folded into every document's key, so each sweep draws
        # fresh randomness
        return {"epoch": float(self._epoch)}

    def on_training_start(self, ctx: TrainerContext, starting_epoch: int) -> None:
        self._epoch = starting_epoch

    def on_epoch_finished(self, ctx: TrainerContext, epoch_idx: int) -> None:
        self._epoch = epoch_idx + 1

    def model_table_config(self, table_id: str = "lda-model") -> TableConfig:
        """word -> [K] topic counts; the summary row n_k at key vocab_size
        (dense) or LDA_SUMMARY_KEY (sparse). Counts start at zero, so the hash
        table's add init needs no init fn of its own."""
        if self.sparse:
            cap = self.slot_budget + 2  # + the summary and pad rows
            return TableConfig(
                table_id=table_id,
                capacity=cap,
                value_shape=(self.num_topics,),
                num_blocks=min(cap, 64),
                is_ordered=False,
                update_fn="add",
                sparse=True,
            )
        return TableConfig(
            table_id=table_id,
            capacity=self.vocab_size + 1,
            value_shape=(self.num_topics,),
            num_blocks=min(self.vocab_size + 1, 64),
            update_fn="add",
        )

    def _sparse_valid(self, tokens: torch.Tensor) -> torch.Tensor:
        """The sparse word domain [1, LDA_MAX_WORD_KEY]: id 0 (the table's
        reserved key) and ids that would alias the pad or summary rows are
        padding, left out of sampling."""
        return (tokens >= 1) & (tokens <= LDA_MAX_WORD_KEY)

    def pull_keys(self, batch) -> torch.Tensor:
        """Sparse pull: one key per token position (padding and out-of-domain
        ids go to the pad row, whose delta is zero), then the summary row."""
        tokens = batch[1]
        word = torch.where(self._sparse_valid(tokens), tokens, LDA_PAD_KEY)
        summary = torch.full((1,), LDA_SUMMARY_KEY, dtype=torch.int32,
                             device=tokens.device)
        return torch.cat([word.reshape(-1).to(torch.int32), summary])

    def mask_delta(self, delta: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
        """A word row the table refused must not count in n_k either, or the
        sampler's denominator drifts from the sum of the word counts: the
        summary row becomes the sum of the admitted word rows."""
        if not self.sparse:
            return delta
        word_rows = delta[:-1] * ok[:-1, None].to(delta.dtype)
        return torch.cat([word_rows, word_rows.sum(dim=0, keepdim=True)])

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
        """Dense mode: ``model`` is the full [V+1, K] count table (row V =
        summary). Sparse mode: ``model`` is the keyed pull, [B*L + 1, K] rows
        in ``pull_keys`` order, and the delta has the same layout (the hash
        push folds duplicate words). ``local`` is the [num_docs, L]
        assignments."""
        docs, z_new, delta, chosen, valid = self._sample(model, local, batch, hyper)
        new_local = local.index_put((docs,), z_new)
        # progress: mean log-weight of the sampled topics (stale counts)
        ll = torch.sum(chosen * valid) / torch.clamp_min(valid.sum(), 1)
        return delta, new_local, {"log_likelihood": ll}

    def local_keys(self, batch):
        return batch[0]

    def row_part(self, model, batch, hyper, local=None):
        docs, z_new, delta, chosen, valid = self._sample(model, local, batch, hyper)
        stats = {"ll": torch.sum(chosen * valid), "valid": valid.sum()}
        if not self.sparse:
            stats["delta"] = delta   # the whole table's: the rows' add up
        yield stats
        return RowResult(delta=delta if self.sparse else None,
                         local_keys=batch[0], local_rows=z_new)

    def row_finish(self, model, hyper, n, local=None):
        stats = yield
        ll = stats["ll"] / torch.clamp_min(stats["valid"], 1)
        return (None if self.sparse else stats["delta"]), {"log_likelihood": ll}

    def _sample(self, model, local, batch, hyper):
        """One sweep over the batch's tokens: (documents, new assignments,
        count delta, the sampled topics' log-weights, the valid mask)."""
        doc_idx, tokens, seeds = batch       # [B], [B, L], [B]
        K, V = self.num_topics, self.vocab_size
        B, L = tokens.shape
        docs = doc_idx.long()
        valid = self._sparse_valid(tokens) if self.sparse else tokens >= 0
        word = torch.where(valid, tokens, 0).long()
        old_z = local[docs]                  # [B, L]
        old_onehot = _one_hot(old_z, K, (old_z >= 0) & valid)   # [B, L, K]
        if self.sparse:
            n_kw = model[: B * L].reshape(B, L, K)   # a row per token position
            n_k = model[B * L]                       # the summary row
        else:
            n_kw = model[word]               # [B, L, K]
            n_k = model[V]                   # [K]
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
        if self.sparse:
            delta = torch.cat([flat_delta, flat_delta.sum(dim=0, keepdim=True)])
        else:
            delta = torch.zeros_like(model)
            delta.index_add_(0, word.reshape(-1), flat_delta)
            delta[V] += flat_delta.sum(dim=0)

        chosen = torch.gather(logits, -1, z_new.clamp_min(0).long()[..., None])[..., 0]
        return docs, z_new, delta, chosen, valid

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


def make_synthetic_sparse(num_docs: int, vocab_size: int, num_topics: int, doc_len: int,
                          seed: int = 0):
    """The same topic model with word ids spread over [1, LDA_MAX_WORD_KEY],
    the corpus only a hash-backed topic-word table holds; the spread is
    per-id deterministic, so the topic structure stays."""
    doc_idx, tokens, seeds = make_synthetic(num_docs, vocab_size, num_topics, doc_len, seed)
    spread = (
        (tokens.astype(np.int64) * 2654435761 + 777) % (LDA_MAX_WORD_KEY - 1)
    ).astype(np.int32) + 1
    return doc_idx, spread, seeds
