"""File splits — exactly-N split computation decoupled from loading.

Counterpart of ``harmony_tpu/data/splits.py``, copied.

Parity with the reference's dataloader (SURVEY.md §2.9): HDFS split
computation is done ONCE on the master (`HdfsSplitManager`), serialized as
`HdfsSplitInfo`, and each executor fetches only its splits
(`HdfsSplitFetcher.fetchData`, common/.../dataloader/HdfsSplitFetcher.java:
31-45). `ExactNumSplitFileInputFormat` (332 LoC) forces EXACTLY N splits so
the number of partitions matches the number of workers regardless of file
block layout.

Rebuilt for posix/GCS-style storage: the file set is treated as one virtual
byte concatenation carved into exactly N contiguous ranges; a range maps to
one or more per-file pieces (so N < number-of-files still covers every file
— a split simply spans files). Text-record alignment follows the Hadoop
LineRecordReader contract per piece: a reader at in-file offset>0 drops
through the first newline (reading from offset-1, so a boundary exactly at a
record start drops nothing) and reads past its end to finish its last
record. Records never span files, so every record lands in exactly one
split.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from harmony_tpu_torch.config.base import ConfigBase, config


@config
class SplitInfo(ConfigBase):
    """One split: a list of ``(path, offset, length)`` pieces (serializable —
    the master computes, executor fetches; ref: HdfsSplitInfoSerializer)."""

    pieces: List[Tuple[str, int, int]]
    split_idx: int = 0
    num_splits: int = 1


def compute_splits(paths: Sequence[str], num_splits: int) -> List[SplitInfo]:
    """Exactly ``num_splits`` splits over the concatenation of ``paths``
    (ref: ExactNumSplitFileInputFormat semantics). Every byte of every file
    is covered exactly once; zero-length splits appear when there are more
    splits than bytes (fetch returns empty, matching the reference's
    tolerance of empty partitions)."""
    import os

    if num_splits <= 0:
        raise ValueError("num_splits must be positive")
    sizes = [(p, os.path.getsize(p)) for p in paths]
    total = sum(s for _, s in sizes)
    base, extra = divmod(total, num_splits)
    # Virtual-range boundaries: first `extra` splits get base+1 bytes.
    splits: List[SplitInfo] = []
    file_idx, file_off = 0, 0
    for i in range(num_splits):
        want = base + (1 if i < extra else 0)
        pieces: List[Tuple[str, int, int]] = []
        while want > 0:
            path, size = sizes[file_idx]
            take = min(want, size - file_off)
            if take > 0:
                pieces.append((path, file_off, take))
                file_off += take
                want -= take
            if file_off >= size:
                file_idx += 1
                file_off = 0
                if file_idx >= len(sizes):
                    break
        splits.append(SplitInfo(pieces=pieces, split_idx=i, num_splits=num_splits))
    return splits


def _fetch_range(path: str, offset: int, length: int) -> List[str]:
    """Complete text records of one in-file byte range (LineRecordReader
    alignment: drop-through-first-newline from offset-1, read past end to
    finish the last record)."""
    if length <= 0:
        return []
    with open(path, "rb") as f:
        if offset > 0:
            f.seek(offset - 1)
            chunk = f.read(length + 1)
            nl = chunk.find(b"\n")
            if nl < 0:
                return []  # entire range is mid-record: owned by predecessor
            chunk = chunk[nl + 1 :]
            if not chunk:
                # No record STARTS inside this range (records belong to the
                # split containing their first byte) — nothing to read.
                return []
        else:
            chunk = f.read(length)
        # Finish our last record by reading past the range end.
        if not chunk.endswith(b"\n"):
            while True:
                b = f.read(4096)
                if not b:
                    break
                nl = b.find(b"\n")
                if nl >= 0:
                    chunk += b[: nl + 1]
                    break
                chunk += b
    return [ln for ln in chunk.decode("utf-8").split("\n") if ln.strip()]


def fetch_split(split: SplitInfo) -> List[str]:
    """Read one split's complete text records (ref: HdfsSplitFetcher.fetchData
    returning the split's raw records for the DataParser)."""
    out: List[str] = []
    for path, offset, length in split.pieces:
        out.extend(_fetch_range(path, int(offset), int(length)))
    return out
