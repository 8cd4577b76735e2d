"""Typed configuration: dataclass configs and dotted-path symbol references.

Counterpart of ``harmony_tpu/config/base.py``, copied for what this port reads:
the ``@config`` dataclass decorator, copy-with-changes, and the
``pkg.mod:Qual.name`` references through which a job names its trainer,
data generator and update-fn factories.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Type, TypeVar

T = TypeVar("T")


def config(cls: Type[T]) -> Type[T]:
    """Decorator: make ``cls`` a dataclass config."""
    return dataclasses.dataclass(cls)


def resolve_symbol(path: str) -> Any:
    """Import ``"pkg.mod:Qual.name"`` and return the named object."""
    module, _, qual = path.partition(":")
    obj: Any = importlib.import_module(module)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


class ConfigBase:
    """Mixin giving dataclass configs copy-with-changes."""

    def replace(self: T, **changes: Any) -> T:
        return dataclasses.replace(self, **changes)  # type: ignore[type-var]
