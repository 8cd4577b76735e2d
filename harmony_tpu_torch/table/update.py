"""Server-side update semantics: how a table initialises keys and folds pushes.

Counterpart of ``harmony_tpu/table/update.py``. An update function is

  * ``init(keys) -> values``   — values for never-written keys, batched over a
    key tensor (the reference vmaps a per-key ``init``; here the batch
    dimension is written out), broadcast by the table to the value shape;
  * ``scatter_mode``           — how a batched push folds on the device;
  * ``post``                   — optional transform of touched entries after
    the fold (e.g. the non-negativity clamp);
  * ``apply(old, delta)``      — one host-side update of a value (the
    model cache of ``dolphin/accessor.py`` applies its own pushes with it).

Durable ``"pkg.mod:factory?k=v"`` names resolve through :func:`get_update_fn`,
gated to this package's modules (a persisted name is code-bearing input).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class UpdateFunction:
    name: str
    init: Callable[[torch.Tensor], torch.Tensor]          # keys [n] -> values [n, ...]
    # "add" | "min" | "max" | "set" (duplicate order unspecified for "set")
    scatter_mode: str = "add"
    post: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    apply: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.add


_REGISTRY: Dict[str, UpdateFunction] = {}

# Factory resolution is gated to this package so a persisted name from an
# untrusted source cannot import and run arbitrary modules.
_FACTORY_PREFIX = "harmony_tpu_torch."


def register_update_fn(fn: UpdateFunction) -> UpdateFunction:
    _REGISTRY[fn.name] = fn
    return fn


def get_update_fn(name: str) -> UpdateFunction:
    """Resolve a registered update fn by name, or a durable factory reference
    ``"pkg.mod:factory?arg=1&scale=0.05"`` (the factory is imported and called
    with the parsed int/float/str kwargs; the result is cached under the full
    name)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        pass
    if ":" in name:
        from harmony_tpu_torch.config.base import resolve_symbol

        path, _, query = name.partition("?")
        module = path.partition(":")[0]
        if not module.startswith(_FACTORY_PREFIX):
            raise PermissionError(
                f"update-fn factory module {module!r} is outside "
                f"{_FACTORY_PREFIX}*; register_update_fn() it instead"
            )
        kwargs = {}
        for pair in query.split("&") if query else []:
            k, _, v = pair.partition("=")
            try:
                kwargs[k] = int(v)
            except ValueError:
                try:
                    kwargs[k] = float(v)
                except ValueError:
                    kwargs[k] = v
        fn = resolve_symbol(path)(**kwargs)
        if not isinstance(fn, UpdateFunction):
            raise TypeError(
                f"update-fn factory {path!r} returned {type(fn).__name__}, "
                "expected UpdateFunction"
            )
        fn = dataclasses.replace(fn, name=name)
        _REGISTRY[name] = fn
        return fn
    raise KeyError(
        f"unknown update fn {name!r}; registered: {sorted(_REGISTRY)}"
    ) from None


def _fill(value: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda keys: torch.full(keys.shape, value, dtype=torch.float32,
                                   device=keys.device)


# push = accumulate deltas (every Dolphin app's gradient push)
register_update_fn(UpdateFunction(name="add", init=_fill(0.0)))

# additive push with a non-negativity clamp AFTER the fold, so concurrent
# deltas that each keep a value non-negative cannot sum below zero
register_update_fn(UpdateFunction(
    name="add_nonneg", init=_fill(0.0), post=lambda v: torch.clamp_min(v, 0.0),
    apply=lambda old, d: torch.clamp_min(old + d, 0.0)))

# overwrite semantics (put-like update)
register_update_fn(UpdateFunction(name="assign", init=_fill(0.0), scatter_mode="set",
                                  apply=lambda old, d: d))

# min/max folds (graph apps, e.g. shortest-path relaxations)
register_update_fn(UpdateFunction(
    name="min", init=_fill(float("inf")), scatter_mode="min", apply=torch.minimum))
register_update_fn(UpdateFunction(
    name="max", init=_fill(float("-inf")), scatter_mode="max", apply=torch.maximum))
