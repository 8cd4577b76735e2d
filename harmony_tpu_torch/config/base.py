"""Typed, serializable configuration: dataclass configs, a class registry and
dotted-path symbol references.

Counterpart of ``harmony_tpu/config/base.py``, copied: the ``@config``
dataclass decorator registers each config class under its class name, so
polymorphic nested configs round-trip through JSON with a ``_type``
discriminator (a user dict that carries ``_type`` itself travels escaped as
``__raw_dict__``), and ``pkg.mod:Qual.name`` references name a job's trainer,
data generator and update-fn factories. A checkpoint manifest embeds its
table's ``TableConfig.to_dict()``; the two packages write the same keys, so
either reads the other's.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from typing import Any, Dict, Type, TypeVar

_REGISTRY: Dict[str, type] = {}

T = TypeVar("T")


def register_config(cls: Type[T]) -> Type[T]:
    """Register a dataclass config type under its class name."""
    _REGISTRY[cls.__name__] = cls
    return cls


def config(cls: Type[T]) -> Type[T]:
    """Decorator: make ``cls`` a dataclass config and register it."""
    return register_config(dataclasses.dataclass(cls))


def symbol_name(obj: Any) -> str:
    """Dotted import path of a module-level callable or class."""
    module = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", None)
    if not module or not qualname or "<locals>" in qualname:
        raise ValueError(f"not an importable module-level symbol: {obj!r}")
    return f"{module}:{qualname}"


def resolve_symbol(path: str) -> Any:
    """Import ``"pkg.mod:Qual.name"`` and return the named object."""
    module, _, qual = path.partition(":")
    obj: Any = importlib.import_module(module)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _encode(value: Any) -> Any:
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        d = {"_type": type(value).__name__}
        for f in dataclasses.fields(value):
            d[f.name] = _encode(getattr(value, f.name))
        return d
    if isinstance(value, dict):
        enc = {k: _encode(v) for k, v in value.items()}
        if "_type" in value:
            # a user dict carrying the discriminator must not pass for (or
            # hijack) a registered config type
            return {"_type": "__raw_dict__", "value": enc}
        return enc
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    return value


def _decode(value: Any) -> Any:
    if isinstance(value, dict):
        if "_type" in value:
            if value["_type"] == "__raw_dict__":
                return {k: _decode(v) for k, v in value["value"].items()}
            cls = _REGISTRY.get(value["_type"])
            if cls is None:
                raise KeyError(f"unregistered config type {value['_type']!r}")
            kwargs = {k: _decode(v) for k, v in value.items() if k != "_type"}
            return cls(**kwargs)
        return {k: _decode(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_decode(v) for v in value]
    return value


class ConfigBase:
    """Mixin giving dataclass configs JSON round-trip and copy-with-changes."""

    def to_dict(self) -> Dict[str, Any]:
        return _encode(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> Any:
        return _decode(d)

    @staticmethod
    def from_json(s: str) -> Any:
        return _decode(json.loads(s))

    def replace(self: T, **changes: Any) -> T:
        return dataclasses.replace(self, **changes)  # type: ignore[type-var]
