"""DataParser SPI + built-in text formats.

Counterpart of ``harmony_tpu/data/parsers.py``, copied; ``LibSvmParser``
runs over the port's copy of the native codec (``native.parse_libsvm``).

Parity with the reference's per-app parsers (SURVEY.md §2.1 BulkDataLoader +
DataParser; each mlapp ships an ``<App>ETDataParser``): a parser turns a
split's raw records into typed arrays ready for table/bulk insertion.

Built-ins cover the reference's app data shapes:
  * ``LibSvmParser``   — "label idx:val idx:val …" (MLR/Lasso/GBT-style
    labeled sparse rows -> dense features + label);
  * ``CsvParser``      — plain numeric rows;
  * ``KeyValueVectorParser`` — "key v0 v1 v2 …" rows (NMF-style keyed rows).

Parsers are registered by name so a serialized TableConfig can carry
``parser="libsvm"`` across process boundaries (the Tang-binding analogue).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Type

import numpy as np


class DataParser:
    """SPI: records -> arrays (ref: evaluator/api/DataParser)."""

    def parse(self, records: Sequence[str]):
        raise NotImplementedError


_REGISTRY: Dict[str, Type[DataParser]] = {}


def register_parser(name: str):
    def deco(cls: Type[DataParser]):
        _REGISTRY[name] = cls
        return cls

    return deco


def get_parser(name: str, **kwargs) -> DataParser:
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown parser {name!r}; registered: {sorted(_REGISTRY)}") from None
    return cls(**kwargs)


@register_parser("libsvm")
class LibSvmParser(DataParser):
    """label idx:value ... -> (x [N, num_features] float32, y [N] float32).

    Indices are ``base``-based (libsvm files are traditionally 1-based)."""

    def __init__(self, num_features: int, base: int = 1) -> None:
        self.num_features = num_features
        self.base = base

    def parse(self, records: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        from harmony_tpu_torch import native

        if native.available() and records:
            # C++ hot loop (native/harmony_native.cc: ht_parse_libsvm).
            x, y = native.parse_libsvm(
                "\n".join(records) + "\n", self.num_features, self.base
            )
            if x.shape[0] == len(records):
                return x, y
            # Row-count drift (e.g. records containing embedded newlines):
            # fall through to the reference Python path.
        n = len(records)
        x = np.zeros((n, self.num_features), np.float32)
        y = np.zeros((n,), np.float32)
        for i, rec in enumerate(records):
            parts = rec.split()
            y[i] = float(parts[0])
            for tok in parts[1:]:
                idx, val = tok.split(":")
                j = int(idx) - self.base
                if 0 <= j < self.num_features:
                    x[i, j] = float(val)
        return x, y


@register_parser("csv")
class CsvParser(DataParser):
    """Numeric CSV rows -> one float32 matrix (label column optional)."""

    def __init__(self, delimiter: str = ",", label_col: int | None = None) -> None:
        self.delimiter = delimiter
        self.label_col = label_col

    def parse(self, records: Sequence[str]):
        rows = [
            [float(v) for v in rec.split(self.delimiter)] for rec in records
        ]
        mat = np.asarray(rows, np.float32) if rows else np.zeros((0, 0), np.float32)
        if self.label_col is None:
            return mat
        y = mat[:, self.label_col]
        x = np.delete(mat, self.label_col, axis=1)
        return x, y


@register_parser("keyvec")
class KeyValueVectorParser(DataParser):
    """"key v0 v1 ..." rows -> (keys [N] int32, values [N, D] float32)
    (ref: NMF-style keyed row input; keys feed ExistKeyBulkDataLoader
    semantics — the key comes from the data, not a generator)."""

    def parse(self, records: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        keys: List[int] = []
        vals: List[List[float]] = []
        for rec in records:
            parts = rec.split()
            keys.append(int(parts[0]))
            vals.append([float(v) for v in parts[1:]])
        return (
            np.asarray(keys, np.int32),
            np.asarray(vals, np.float32) if vals else np.zeros((0, 0), np.float32),
        )
