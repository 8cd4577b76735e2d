"""Gradient-boosted trees: XGBoost's ``hist`` method, level-wise.

Counterpart of ``harmony_tpu/apps/gbt.py`` (the reference's GBT app). One
boosting round per mini-batch: the gradient and hessian of the loss at the
margins of all stored trees, then a tree grown level by level on
quantile-binned features, each level's split found from per-(node, feature,
bin) sums of gradient, hessian and count, and the finished tree written to
the model table at key = round as one fixed-width row (feature, threshold and
leaf flag per node, then the leaf values with the shrinkage applied). The
worker-local table carries the round counter. Multiclass grows one tree with
K outputs and shared structure, as the reference does.

Where the reference scatters, the port folds, on the card through the
hand-written kernels and never through ``index_add_`` (whose float atomics
add in an order that changes from run to run):

  * ``hist_mode="matmul"``: ONE ``weighted_histogram`` (K3) a level over the
    rows ``[g | h | live]`` (width 2K+1), as ``gbt.py:201-208``; the node
    totals (``Gn``, ``Hn``, ``Cn``) ride the same call as ids past the
    histogram's rows.
  * ``hist_mode="scatter"``: the reference's three scatter-adds folded into
    ONE ``segment_sum_rows`` (K2) a level over the same rows of width 2K+1:
    each column adds the same terms in the same order either way.
  * ``hist_mode="auto"``: ``"matmul"`` on a CUDA tensor, ``"scatter"`` on the
    CPU (``utils/platform.py::use_kernel``), resolved per call.

Both folds add each row's contributions in index order from 0.0 on either
device; ids of settled examples are negative and add nothing. The prefix
sums over bins are f32 and sequential on both devices (:func:`_cumsum_bins`),
so the card grows the CPU's trees bit for bit.

``predict_margins`` traverses every stored tree at once (``[R, E]`` positions,
``max_depth + 1`` gather steps) and sums the trees in round order, the
reference's ``((0 + t0) + t1) + ...``; rows not yet boosted are all zeros,
have no leaf and predict exactly 0.

On a data axis > 1 the round splits (``row_part``, ``row_finish``): each
row folds its own examples' histogram of a level on its slot, the finish adds
the rows' histograms in row order and searches the splits once, and each row
routes its own examples by them; the finish writes the tree and advances the
round counter once.

Losses: "squared" (regression), "logistic" (binary), "softmax" (multiclass,
K = num_outputs).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.dolphin.trainer import RowResult, Trainer
from harmony_tpu_torch.ops.histogram import weighted_histogram
from harmony_tpu_torch.ops.sparse import segment_sum_rows
from harmony_tpu_torch.utils.platform import use_kernel


def _cumsum_bins(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along dim 2 of ``x`` [n, F, bins, C], each a
    sequential f32 sum from the first bin: the order of the reference's
    cumsum on the CPU (XLA's window sum). PyTorch's CUDA scan along a
    dimension that is not the innermost walks it in order in f32; its CPU
    cumsum adds in double, so the CPU adds bin by bin instead."""
    if use_kernel(x):
        return torch.cumsum(x, dim=2)
    out = torch.empty_like(x)
    acc = x[:, :, 0]
    out[:, :, 0] = acc
    for b in range(1, x.shape[2]):
        acc = acc + x[:, :, b]
        out[:, :, b] = acc
    return out


class GBTTrainer(Trainer):
    pull_mode = "all"
    uses_local_table = True

    def __init__(
        self,
        num_features: int,
        num_examples: int,
        num_rounds: int,
        loss: str = "squared",
        num_outputs: int = 1,
        num_bins: int = 16,
        max_depth: int = 3,
        lam: float = 1.0,
        gamma: float = 0.0,
        step_size: float = 0.3,
        leaf_min_size: int = 1,
        hist_mode: str = "auto",
    ) -> None:
        if loss not in ("squared", "logistic", "softmax"):
            raise ValueError(f"unknown loss {loss!r}")
        if loss == "softmax" and num_outputs < 2:
            raise ValueError("softmax loss needs num_outputs >= 2")
        if loss in ("squared", "logistic") and num_outputs != 1:
            raise ValueError(f"{loss} loss is single-output")
        if hist_mode not in ("auto", "scatter", "matmul"):
            raise ValueError(f"unknown hist_mode {hist_mode!r}")
        self.num_features = num_features
        self.num_examples = num_examples
        self.num_rounds = num_rounds
        self.loss = loss
        self.k = num_outputs
        self.num_bins = num_bins
        self.max_depth = max_depth
        self.lam = lam
        self.gamma = gamma
        self.step_size = step_size
        self.leaf_min_size = leaf_min_size
        self.hist_mode = hist_mode
        # full binary tree, levels 0..max_depth
        self.num_nodes = 2 ** (max_depth + 1) - 1

    def resolved_hist_mode(self, t: torch.Tensor) -> str:
        """``hist_mode`` with "auto" resolved by ``t``'s device."""
        if self.hist_mode != "auto":
            return self.hist_mode
        return "matmul" if use_kernel(t) else "scatter"

    # -- table schemas ---------------------------------------------------

    @property
    def tree_vec_len(self) -> int:
        # per node: feature id, threshold bin, is_leaf flag, K leaf values
        return self.num_nodes * (3 + self.k)

    def model_table_config(self, table_id: str = "gbt-model", num_blocks: int = 0) -> TableConfig:
        """key = boosting round, value = flattened tree."""
        return TableConfig(
            table_id=table_id,
            capacity=self.num_rounds,
            value_shape=(self.tree_vec_len,),
            num_blocks=num_blocks or min(self.num_rounds, 64),
            is_ordered=True,
            update_fn="add",
        )

    def local_table_config(self, table_id: str = "gbt-state") -> TableConfig:
        """Single-row worker state: the boosting-round counter."""
        return TableConfig(
            table_id=table_id,
            capacity=1,
            value_shape=(1,),
            num_blocks=1,
            is_ordered=True,
            update_fn="assign",
        )

    def hyperparams(self) -> Dict[str, float]:
        return {"step": self.step_size}

    # -- loss ------------------------------------------------------------

    def _grad_hess(self, m: torch.Tensor, y: torch.Tensor, reduce=torch.mean):
        """Per-example gradient/hessian of the loss at margins m [B, K], and
        the loss (the batch's mean; ``reduce=torch.sum``: its sum)."""
        if self.loss == "squared":
            g = m - y[:, None]
            h = torch.ones_like(m)
            loss = 0.5 * reduce((m[:, 0] - y) ** 2)
        elif self.loss == "logistic":
            p = torch.sigmoid(m[:, 0])
            g = (p - y)[:, None]
            h = (p * (1.0 - p))[:, None]
            loss = -reduce(y * F.logsigmoid(m[:, 0]) + (1 - y) * F.logsigmoid(-m[:, 0]))
        else:  # softmax
            p = torch.softmax(m, dim=-1)
            onehot = F.one_hot(y.long(), self.k).to(m.dtype)
            g = p - onehot
            h = p * (1.0 - p)
            loss = -reduce(torch.sum(onehot * torch.log_softmax(m, -1), dim=-1))
        return g, h, loss

    # -- tree growing ------------------------------------------------------

    def _fold(self, mode: str, ids: torch.Tensor, stats: torch.Tensor,
              num_rows: int) -> torch.Tensor:
        """``[num_rows, 2K+1]`` sums of ``stats`` rows by ``ids`` (negative ids
        add nothing): one K3 call, or one K2 call."""
        if mode == "matmul":
            return weighted_histogram(ids, stats, num_rows)
        return segment_sum_rows(stats, ids, num_rows)

    def _grow_tree(self, bins: torch.Tensor, g: torch.Tensor, h: torch.Tensor):
        """Level-wise histogram tree build.

        bins [E, F] int32, g/h [E, K] float32 ->
        (feat [N], thr [N], is_leaf [N], leaf_val [N, K], pred [E, K])."""
        E = bins.shape[0]
        tree = self._empty_tree(bins.device)
        pos = torch.zeros((E,), dtype=torch.int32, device=bins.device)  # node id in the full tree
        settled = torch.zeros((E,), dtype=torch.bool, device=bins.device)
        pred = torch.zeros((E, self.k), dtype=torch.float32, device=bins.device)
        mode = self.resolved_hist_mode(bins)
        for d in range(self.max_depth + 1):
            hist = self._level_hist(mode, bins, g, h, pos, settled, d)
            split = self._level_split(hist, d, bins.shape[1], tree)
            pos, settled, pred = self._route(bins, pos, settled, pred, d, *split)
        return (*tree, pred)

    def _empty_tree(self, dev):
        N = self.num_nodes
        return (torch.zeros((N,), dtype=torch.int32, device=dev),
                torch.zeros((N,), dtype=torch.int32, device=dev),
                torch.zeros((N,), dtype=torch.bool, device=dev),
                torch.zeros((N, self.k), dtype=torch.float32, device=dev))

    def _level_hist(self, mode, bins, g, h, pos, settled, d) -> torch.Tensor:
        """Level ``d``'s per-(node, feature, bin) sums of [g | h | live] and,
        past them, the node totals: one fold (K3 or K2)."""
        E, Fn = bins.shape
        K, Bn = self.k, self.num_bins
        level_start, n_level = 2 ** d - 1, 2 ** d
        node = pos - level_start            # [E]; negative for settled examples
        live = (~settled).to(torch.float32)[:, None]
        stats = torch.cat([g * live, h * live, live], dim=1)   # [E, 2K+1]
        nb = n_level * Fn * Bn if d < self.max_depth else 0
        # node totals: ids past the histogram's rows, in the same fold
        tot_ids = torch.where(node >= 0, node + nb, -1)
        if not nb:
            return self._fold(mode, tot_ids, stats, n_level)
        f_idx = torch.arange(Fn, dtype=torch.int32, device=bins.device)[None, :]
        flat = ((node[:, None] * Fn + f_idx) * Bn + bins).reshape(-1)
        reps = stats[:, None, :].expand(E, Fn, 2 * K + 1).reshape(-1, 2 * K + 1)
        return self._fold(mode, torch.cat([flat, tot_ids]), torch.cat([reps, stats]),
                          nb + n_level)

    def _level_split(self, hist: torch.Tensor, d: int, Fn: int, tree):
        """Level ``d``'s splits from its histogram, written into ``tree``:
        (best feature, best bin, leaf flags, leaf values) of its nodes."""
        K, Bn, lam = self.k, self.num_bins, self.lam
        dev = hist.device
        level_start, n_level = 2 ** d - 1, 2 ** d
        grow = d < self.max_depth
        nb = n_level * Fn * Bn if grow else 0
        tot = hist[nb:]
        Gn, Hn, Cn = tot[:, :K], tot[:, K:2 * K], tot[:, 2 * K]
        w = -Gn / (Hn + lam)                                    # [n_level, K]

        if grow:
            cum = _cumsum_bins(hist[:nb].reshape(n_level, Fn, Bn, 2 * K + 1))
            GL, HL, CL = cum[..., :K], cum[..., K:2 * K], cum[..., 2 * K]
            G, H, C = Gn[:, None, None, :], Hn[:, None, None, :], Cn[:, None, None]

            def score(gg, hh):
                return gg * gg / (hh + lam)

            terms = score(GL, HL) + score(G - GL, H - HL) - score(G, H)
            total = terms[..., 0]
            for k in range(1, K):   # f32, in class order
                total = total + terms[..., k]
            gain = 0.5 * total - self.gamma                     # [n_level, F, Bn]
            bin_idx = torch.arange(Bn, device=dev)[None, None, :]
            valid = ((CL >= self.leaf_min_size)
                     & ((C - CL) >= self.leaf_min_size)
                     & (bin_idx < Bn - 1))
            gain = torch.where(valid, gain, -torch.inf)
            flat_gain = gain.reshape(n_level, Fn * Bn)
            best = torch.argmax(flat_gain, dim=1)               # the first maximum
            best_gain = flat_gain.gather(1, best[:, None])[:, 0]
            best_f = torch.div(best, Bn, rounding_mode="floor").to(torch.int32)
            best_b = (best % Bn).to(torch.int32)
            leaf_here = ~(best_gain > 0.0)                      # NaN-safe: leaf
        else:
            best_f = torch.zeros((n_level,), dtype=torch.int32, device=dev)
            best_b = torch.zeros((n_level,), dtype=torch.int32, device=dev)
            leaf_here = torch.ones((n_level,), dtype=torch.bool, device=dev)

        feat, thr, is_leaf, leaf_val = tree
        seg = slice(level_start, level_start + n_level)
        feat[seg] = best_f
        thr[seg] = best_b
        is_leaf[seg] = leaf_here
        leaf_val[seg] = w
        return best_f, best_b, leaf_here, w

    def _route(self, bins, pos, settled, pred, d, best_f, best_b, leaf_here, w):
        """Settle the examples that land on a leaf of level ``d``; descend
        the rest."""
        node = pos - (2 ** d - 1)
        at = node.clamp_min(0).long()       # settled examples are masked below
        at_leaf = leaf_here[at] & ~settled
        pred = torch.where(at_leaf[:, None], w[at], pred)
        settled = settled | at_leaf
        go_right = bins.gather(1, best_f[at][:, None].long())[:, 0] > best_b[at]
        pos = torch.where(settled, pos, 2 * pos + 1 + go_right.to(torch.int32))
        return pos, settled, pred

    def _encode_tree(self, feat, thr, is_leaf, leaf_val) -> torch.Tensor:
        return torch.cat([feat.to(torch.float32), thr.to(torch.float32),
                          is_leaf.to(torch.float32), leaf_val.reshape(-1)])

    def _decode_tree(self, vec: torch.Tensor):
        """Tree rows ``[..., tree_vec_len]`` -> feat, thr [..., N] int32,
        is_leaf [..., N] bool, leaf_val [..., N, K]."""
        N = self.num_nodes
        feat = vec[..., :N].to(torch.int32)
        thr = vec[..., N:2 * N].to(torch.int32)
        is_leaf = vec[..., 2 * N:3 * N] > 0.5
        leaf_val = vec[..., 3 * N:].reshape(*vec.shape[:-1], N, self.k)
        return feat, thr, is_leaf, leaf_val

    def _traverse(self, trees: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
        """Predict every tree of ``trees`` [R, L] (or one tree [L]) for all
        examples: [R, E, K] (or [E, K]). All-zero rows (rounds not yet
        boosted) have no leaf markers and predict exactly 0."""
        if trees.ndim == 1:
            return self._traverse(trees[None], bins)[0]
        feat, thr, is_leaf, leaf_val = self._decode_tree(trees)
        R = trees.shape[0]
        E, Fn = bins.shape
        K = self.k
        dev = bins.device
        pos = torch.zeros((R, E), dtype=torch.int64, device=dev)
        done = torch.zeros((R, E), dtype=torch.bool, device=dev)
        val = torch.zeros((R, E, K), dtype=torch.float32, device=dev)
        flat_bins = bins.reshape(-1)
        row_base = torch.arange(E, device=dev) * Fn
        for _ in range(self.max_depth + 1):
            at_leaf = is_leaf.gather(1, pos) & ~done
            here = leaf_val.gather(1, pos[..., None].expand(R, E, K))
            val = torch.where(at_leaf[..., None], here, val)
            done = done | at_leaf
            go_right = flat_bins[row_base + feat.gather(1, pos)] > thr.gather(1, pos)
            pos = torch.where(done, pos, 2 * pos + 1 + go_right.long())
        return val

    def predict_margins(self, model: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
        """Ensemble prediction [E, K]: the stored trees traversed together and
        summed in round order (shrinkage is baked into the leaf values)."""
        per_tree = self._traverse(model, bins)
        margins = torch.zeros((bins.shape[0], self.k), dtype=torch.float32,
                              device=bins.device)
        for r in range(per_tree.shape[0]):
            margins = margins + per_tree[r]
        return margins

    # -- Trainer SPI ------------------------------------------------------

    def compute_with_local(self, model, local, batch, hyper):
        bins, y = batch[0].to(torch.int32), batch[1]
        rnd = local[0, 0].to(torch.int32)                    # round counter
        m = self.predict_margins(model, bins)                # PULL: all trees
        g, h, loss = self._grad_hess(m, y)
        feat, thr, is_leaf, leaf_val, _ = self._grow_tree(bins, g, h)
        delta = self._tree_delta(model, rnd, hyper, feat, thr, is_leaf, leaf_val)
        new_local = local.clone()
        new_local[0, 0] += 1.0
        return delta, new_local, {"loss": loss, "round": rnd.to(torch.float32)}

    def _tree_delta(self, model, rnd, hyper, feat, thr, is_leaf, leaf_val):
        """The finished tree as a delta of the model table at row ``rnd``."""
        step = hyper["step"].to(torch.float32)
        # Rounds past num_rounds write NOTHING: the table's update fn is "add",
        # so re-targeting an existing row would sum two encodings elementwise.
        in_budget = (rnd < self.num_rounds).to(torch.float32)
        tree_vec = self._encode_tree(feat, thr, is_leaf, step * leaf_val) * in_budget
        row = rnd.clamp(max=self.num_rounds - 1).reshape(1).long()
        # index_copy_ with a device index: no host read of the counter
        return torch.zeros_like(model).index_copy_(0, row, tree_vec[None])

    def row_part(self, model, batch, hyper, local=None):
        """Each level: the row's histogram (one K3 or K2 call on its slot);
        then its own examples routed by the finish's splits."""
        bins, y = batch[0].to(torch.int32), batch[1]
        g, h, loss = self._grad_hess(self.predict_margins(model, bins), y, torch.sum)
        E, dev = bins.shape[0], bins.device
        pos = torch.zeros((E,), dtype=torch.int32, device=dev)
        settled = torch.zeros((E,), dtype=torch.bool, device=dev)
        pred = torch.zeros((E, self.k), dtype=torch.float32, device=dev)
        mode = self.resolved_hist_mode(bins)
        stats = {"loss": loss}
        for d in range(self.max_depth + 1):
            stats["hist"] = self._level_hist(mode, bins, g, h, pos, settled, d)
            split = yield stats
            if split is None:   # the last level: the tree is done
                break
            pos, settled, pred = self._route(bins, pos, settled, pred, d, split["f"],
                                             split["b"], split["leaf"], split["w"])
            stats = {}
        return RowResult()

    def row_finish(self, model, hyper, n, local=None):
        """The splits, once a level, from the rows' histograms added in row
        order; the tree, and the round counter advanced once."""
        tree = self._empty_tree(model.device)
        stats = yield
        loss = stats["loss"] / n
        for d in range(self.max_depth + 1):
            f, b, leaf, w = self._level_split(stats["hist"], d, self.num_features, tree)
            if d < self.max_depth:
                stats = yield {"f": f, "b": b, "leaf": leaf, "w": w}
        rnd = local[0, 0].to(torch.int32)
        delta = self._tree_delta(model, rnd, hyper, *tree)
        return (delta, {"loss": loss, "round": rnd.to(torch.float32)},
                (torch.zeros(1, dtype=torch.int32, device=model.device), local[:1] + 1.0))

    def evaluate(self, model, batch) -> Dict[str, torch.Tensor]:
        bins, y = batch[0].to(torch.int32), batch[1]
        m = self.predict_margins(model, bins)
        if self.loss == "squared":
            return {"loss": 0.5 * torch.mean((m[:, 0] - y) ** 2),
                    "rmse": torch.sqrt(torch.mean((m[:, 0] - y) ** 2))}
        if self.loss == "logistic":
            p = torch.sigmoid(m[:, 0])
            acc = torch.mean(((p > 0.5) == (y > 0.5)).to(torch.float32))
            loss = -torch.mean(y * F.logsigmoid(m[:, 0]) + (1 - y) * F.logsigmoid(-m[:, 0]))
            return {"loss": loss, "accuracy": acc}
        onehot = F.one_hot(y.long(), self.k).to(m.dtype)
        return {
            "loss": -torch.mean(torch.sum(onehot * torch.log_softmax(m, -1), dim=-1)),
            "accuracy": torch.mean((torch.argmax(m, -1) == y).to(torch.float32)),
        }


# -- host-side preprocessing (numpy; the reference's, byte for byte) ----------


def bin_features(
    x: np.ndarray, num_bins: int, categorical: np.ndarray | None = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Quantile-bin continuous features into [0, num_bins) (categorical
    features are identity-binned, clipped to the bin range). Returns (bins
    int32 [N, F], edges [F, num_bins-1])."""
    n, f = x.shape
    edges = np.zeros((f, num_bins - 1), np.float32)
    bins = np.zeros((n, f), np.int32)
    cat = np.zeros(f, bool) if categorical is None else np.asarray(categorical, bool)
    qs = np.linspace(0, 100, num_bins + 1)[1:-1]
    for j in range(f):
        if cat[j]:
            bins[:, j] = np.clip(x[:, j].astype(np.int64), 0, num_bins - 1)
            edges[j] = np.arange(1, num_bins, dtype=np.float32)
        else:
            e = np.percentile(x[:, j], qs).astype(np.float32)
            edges[j] = e
            bins[:, j] = np.searchsorted(e, x[:, j], side="right")
    return bins, edges


def apply_bins(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Bin new data with training-time edges (held-out evaluation)."""
    n, f = x.shape
    bins = np.zeros((n, f), np.int32)
    for j in range(f):
        bins[:, j] = np.searchsorted(edges[j], x[:, j], side="right")
    return bins


def make_synthetic(
    n: int, num_features: int, seed: int = 0, task: str = "regression", num_classes: int = 2
) -> Tuple[np.ndarray, np.ndarray]:
    """Nonlinear synthetic data (tree-learnable: axis-aligned interactions)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, num_features)).astype(np.float32)
    raw = (
        2.0 * (x[:, 0] > 0.3)
        + 1.5 * (x[:, 1] < -0.2) * (x[:, 0] > -1.0)
        - 1.0 * (x[:, 2] > 0.0)
        + 0.1 * rng.normal(size=n)
    )
    if task == "regression":
        return x, raw.astype(np.float32)
    if task == "binary":
        return x, (raw > raw.mean()).astype(np.float32)
    q = np.quantile(raw, np.linspace(0, 1, num_classes + 1)[1:-1])
    return x, np.digitize(raw, q).astype(np.int32)


def make_binned_synthetic(
    n: int,
    num_features: int,
    num_bins: int = 16,
    seed: int = 0,
    task: str = "regression",
    num_classes: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic data already binned: the (bins, y) pair the trainer takes
    (``bin_features`` of ``make_synthetic``; the edges are dropped)."""
    x, y = make_synthetic(n, num_features, seed=seed, task=task,
                          num_classes=num_classes)
    bins, _ = bin_features(x, num_bins)
    return bins, y
