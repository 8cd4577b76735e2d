"""Input data: the process-level data caches, the staging ring, and the
bulk loader's splits, parsers and storer.

Counterpart of ``harmony_tpu/data/__init__.py``; :func:`load_dataset` is the
reference's worker-side input path.
"""
from harmony_tpu_torch.data.parsers import (
    CsvParser,
    DataParser,
    KeyValueVectorParser,
    LibSvmParser,
    get_parser,
    register_parser,
)
from harmony_tpu_torch.data.splits import SplitInfo, compute_splits, fetch_split
from harmony_tpu_torch.data.storer import DataStorer, FileDataStorer


def load_dataset(paths, parser, num_splits: int = 1):
    """Fetch and parse every split of ``paths`` and concatenate them into the
    arrays a ``TrainingDataProvider`` consumes (the reference's input-table
    bulk load collapsed to host arrays)."""
    import numpy as np

    parts = []
    for split in compute_splits(list(paths), num_splits):
        records = fetch_split(split)
        if records:
            parts.append(parser.parse(records))
    if not parts:
        raise ValueError(f"no records in {paths}")
    first = parts[0]
    if isinstance(first, tuple):
        return tuple(np.concatenate([p[i] for p in parts]) for i in range(len(first)))
    return np.concatenate(parts)


__all__ = [
    "SplitInfo",
    "compute_splits",
    "fetch_split",
    "DataParser",
    "CsvParser",
    "LibSvmParser",
    "KeyValueVectorParser",
    "get_parser",
    "register_parser",
    "DataStorer",
    "FileDataStorer",
    "load_dataset",
]
