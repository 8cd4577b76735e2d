"""Generic table trainer for models whose parameters are a tree of tensors.

Counterpart of ``harmony_tpu/models/pytree_trainer.py``. The parameters (nested
dicts and lists of tensors) flatten into one f32 vector that lives in a
range-partitioned DenseTable as rows of ``row_width``; ``pull_mode="all"``
pulls the whole table each batch (a view of its storage), and the push folds
the update back with one dense add. Stateful optimizers keep their state in
further row sections of the same table: ``[params | m | v | counter row]``.

The flat order is ``jax.flatten_util.ravel_pytree``'s: dict keys in sorted
order, list items in order, each leaf in C order. So a table row means the
same parameters in both packages.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.dolphin import optim
from harmony_tpu_torch.dolphin.trainer import Trainer, TrainerContext


def tree_leaves(tree: Any) -> Iterator[Any]:
    """Leaves of a tree of dicts and lists in ravel_pytree's order (a tuple is a
    leaf: the shape trees have shape tuples for leaves)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key])
    elif isinstance(tree, list):
        for item in tree:
            yield from tree_leaves(item)
    else:
        yield tree


def tree_unflatten(tree: Any, leaves) -> Any:
    """A tree shaped like ``tree`` whose leaves are ``leaves`` taken in
    :func:`tree_leaves`' order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {key: build(t[key]) for key in sorted(t)}
        if isinstance(t, list):
            return [build(item) for item in t]
        return next(it)

    return build(tree)


def tree_map(fn, tree: Any) -> Any:
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, item) for item in tree]
    return fn(tree)


def ravel_numpy(tree: Any) -> np.ndarray:
    """The flat f32 vector of a tree of numpy arrays."""
    return np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in tree_leaves(tree)])


def unravel(flat: torch.Tensor, shapes: Any) -> Any:
    """A tree shaped like ``shapes`` (leaves are shape tuples) whose leaves are
    views of consecutive stretches of ``flat``, in ravel_pytree's order."""
    offset = 0

    def take(shape):
        nonlocal offset
        n = int(np.prod(shape, dtype=np.int64))
        leaf = flat[offset:offset + n].view(shape)
        offset += n
        return leaf

    def build(tree):
        if isinstance(tree, dict):  # sorted, so the views follow the flat order
            return {key: build(tree[key]) for key in sorted(tree)}
        if isinstance(tree, list):
            return [build(item) for item in tree]
        return take(tree)

    out = build(shapes)
    if offset != flat.shape[0]:
        raise ValueError(f"flat vector of {flat.shape[0]} values for {offset} parameters")
    return out


class PyTreeTrainer(Trainer):
    pull_mode = "all"
    # the reference runs such a job on a Dolphin data axis > 1 through its
    # worker's GSPMD step; the port's data-parallel forms are the models' own
    # mesh steps (make_train_step(model, mesh) and its siblings)
    data_axis_note = (" (a PyTreeTrainer on a Dolphin data axis is ROADMAP A.12; "
                      "the models' mesh steps take a data axis)")

    #: default table id; subclasses override
    default_table_id = "model"
    #: model config dataclass; subclasses set it and implement build_model
    config_cls: Any = None

    def build_model(self, config: Any) -> Any:
        raise NotImplementedError

    def __init__(
        self,
        config: Any = None,
        row_width: int = 1024,
        step_size: float = 0.1,
        seed: int = 0,
        optimizer: str = "sgd",
        **config_kwargs,
    ) -> None:
        if config is None:
            config = self.config_cls(**config_kwargs)
        elif config_kwargs:
            raise TypeError("pass either config= or flat config kwargs, not both")
        self.config = config
        self.model = self.build_model(config)
        self.row_width = row_width
        self.step_size = step_size
        self.seed = seed
        self.optimizer = optimizer
        self.num_state_slots = optim.num_slots(optimizer)  # validates the name
        self._shapes = self.model.param_shapes()
        self.num_params = int(sum(np.prod(s, dtype=np.int64)
                                  for s in tree_leaves(self._shapes)))
        self.num_rows = -(-self.num_params // row_width)

    # -- model binding (subclass hooks) -----------------------------------

    def loss_on_batch(self, params, batch) -> torch.Tensor:
        """Scalar loss for one batch; subclasses bind the model's batch
        signature here."""
        raise NotImplementedError

    def eval_metrics(self, params, batch) -> Dict[str, torch.Tensor]:
        return {"loss": self.loss_on_batch(params, batch)}

    # -- table schema -----------------------------------------------------

    @property
    def capacity(self) -> int:
        # param rows + one section per state slot + the step-counter row
        extra = 1 if self.num_state_slots else 0
        return self.num_rows * (1 + self.num_state_slots) + extra

    def model_table_config(self, table_id: str = "", num_blocks: int = 0) -> TableConfig:
        return TableConfig(
            table_id=table_id or self.default_table_id,
            capacity=self.capacity,
            value_shape=(self.row_width,),
            num_blocks=num_blocks or max(self.capacity // 8, 1),
            is_ordered=True,
            update_fn="add",
        )

    # -- lifecycle --------------------------------------------------------

    def init_global_settings(self, ctx: TrainerContext) -> None:
        """Write the initial parameters into the param rows; the m/v sections
        and the counter row start (and stay, until the first push) at the
        table's init value 0."""
        flat = torch.from_numpy(ravel_numpy(self.model.init(self.seed)))
        ctx.model_table.multi_put(np.arange(self.num_rows), self.rows_from_flat(flat))

    # -- pure parts -------------------------------------------------------

    def rows_from_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """A flat [num_params] vector as [num_rows, row_width] rows, zero-padded."""
        pad = self.num_rows * self.row_width - self.num_params
        return torch.cat([flat, flat.new_zeros((pad,))]).reshape(self.num_rows, self.row_width)

    def _section(self, model: torch.Tensor, i: int) -> torch.Tensor:
        """Flat [num_params] view of row section i (0=params, 1=m, 2=v)."""
        rows = model[i * self.num_rows:(i + 1) * self.num_rows]
        return rows.reshape(-1)[: self.num_params]

    def hyperparams(self) -> Dict[str, float]:
        return {"lr": self.step_size}

    def compute(self, model, batch, hyper):
        """Loss and gradient of the params section, the optimizer update, and
        the delta ``new - old`` of every section. Each parameter is its own
        autograd leaf, a detached view of the pulled rows, and the gradients
        are concatenated once in the flat order (a gradient taken through
        slices of one flat leaf would add a zero-filled copy of the whole
        vector per parameter). ``model`` is a view of the table's storage:
        everything here reads it before the worker's push writes it, in
        stream order."""
        pflat = self._section(model, 0)
        with torch.enable_grad():
            params = tree_map(lambda t: t.detach().requires_grad_(True),
                              unravel(pflat, self._shapes))
            loss = self.loss_on_batch(params, batch)
            grads = torch.autograd.grad(loss, list(tree_leaves(params)))
        gflat = torch.cat([g.reshape(-1) for g in grads])
        slots = self.num_state_slots
        m = self._section(model, 1) if slots >= 1 else torch.zeros_like(pflat)
        v = self._section(model, 2) if slots >= 2 else torch.zeros_like(pflat)
        t = model[-1, 0] + 1.0 if slots else torch.ones((), device=model.device)
        new_p, new_m, new_v = optim.apply(self.optimizer, pflat, gflat, m, v, t, hyper)
        sections: List[torch.Tensor] = [self.rows_from_flat(new_p - pflat)]
        if slots >= 1:
            sections.append(self.rows_from_flat(new_m - m))
        if slots >= 2:
            sections.append(self.rows_from_flat(new_v - v))
        if slots:
            counter = model.new_zeros((1, self.row_width))
            counter[0, 0] = 1.0
            sections.append(counter)
        return torch.cat(sections), {"loss": loss.detach()}

    def evaluate(self, model, batch) -> Dict[str, torch.Tensor]:
        return self.eval_metrics(unravel(self._section(model, 0), self._shapes), batch)
