"""Process-level caches of materialized input data.

Counterpart of ``harmony_tpu/data/devcache.py``. Input data is not a table
(it feeds the steps directly), so the reference's same-id input-table reuse
becomes two caches keyed by the DATA SOURCE identity (generator dotted path +
args):

  * a host-array cache (:data:`host_data`, the job entity's ``_make_data``),
    so resubmitting a job does not regenerate its dataset, and every job with
    the same source sees the same dataset by definition;
  * a byte-bounded device cache of per-batch and stacked device tensors (this
    module's functions), so the host-to-device transfer happens once.

Cached device tensors are read-only by contract: a step reads its batch and
never writes it, so a cached tensor is never invalidated by a step.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable, Optional, Tuple


def _leaf_bytes(a: Any) -> int:
    if hasattr(a, "element_size"):     # a torch.Tensor
        return int(a.numel() * a.element_size())
    return int(getattr(a, "nbytes", 0))


class ByteLRU:
    """Thread-safe LRU bounded by the total byte size of its values."""

    def __init__(self, max_bytes: int) -> None:
        self._lock = threading.Lock()
        self._cache: "OrderedDict[Hashable, Tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _nbytes(value: Any) -> int:
        leaves = value if isinstance(value, (tuple, list)) else (value,)
        return sum(_leaf_bytes(a) for a in leaves)

    def get(self, key: Optional[Hashable]):
        if key is None:
            return None
        with self._lock:
            hit = self._cache.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._cache.move_to_end(key)
            self.hits += 1
            return hit[0]

    def contains(self, key: Optional[Hashable]) -> bool:
        """Presence probe that moves neither the LRU order nor the hit/miss
        counters: a planning query ("can this epoch bypass host work?") is not
        cache traffic."""
        if key is None:
            return False
        with self._lock:
            return key in self._cache

    def put(self, key: Optional[Hashable], value: Any) -> None:
        if key is None:
            return
        nb = self._nbytes(value)
        if nb > self.max_bytes:
            return  # larger than the whole budget: never cacheable
        with self._lock:
            old = self._cache.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._cache[key] = (value, nb)
            self._bytes += nb
            while self._bytes > self.max_bytes and self._cache:
                _, (_, evicted) = self._cache.popitem(last=False)
                self._bytes -= evicted

    def drop(self, predicate) -> int:
        """Remove every entry whose key matches; returns the count."""
        with self._lock:
            stale = [k for k in self._cache if predicate(k)]
            for k in stale:
                _, nb = self._cache.pop(k)
                self._bytes -= nb
            return len(stale)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "bytes": self._bytes, "entries": len(self._cache)}

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self._bytes = 0
            self.hits = self.misses = 0


# Device-resident batches, bounded well below the card's memory.
_device = ByteLRU(2 << 30)
# Host arrays (the entity's dataset cache): host memory is cheaper.
host_data = ByteLRU(4 << 30)


def get(key: Optional[Hashable]):
    return _device.get(key)


def contains(key: Optional[Hashable]) -> bool:
    return _device.contains(key)


def put(key: Optional[Hashable], value: Any) -> None:
    _device.put(key, value)


def stats() -> dict:
    return _device.stats()


def clear() -> None:
    _device.clear()
