"""Authoritative block -> executor ownership map.

A copy of ``harmony_tpu/table/ownership.py`` (which imports no JAX; the port
keeps its own copy and imports nothing of the JAX package): the driver-side
``BlockManager`` with the reference's even round-robin initial partitioning
(driver/impl/BlockManager.java:30-40), its listeners standing in for the
SubscriptionManager's broadcast, and the shrink-plan helpers over a
checkpointed ownership vector.

As in the reference, the map is LOGICAL ownership: it is what the checkpoint
manifest's ownership vector records, and what the optimizer loop reads and
moves (``runtime/master.py::TableHandle.move_blocks``, ``rebalance``). The
physical layout of a table over several executors is the contiguous block
split of ``table/table.py::block_sharding`` over the mesh of the OWNING
executors, rebuilt by a live reshard whenever that set changes.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Sequence

OwnershipListener = Callable[[str, List[int]], None]  # (table_id, block_to_executor)


class BlockManager:
    """Per-table block ownership with even initial partitioning."""

    def __init__(self, table_id: str, num_blocks: int, executors: Sequence[str]) -> None:
        if not executors:
            raise ValueError("need at least one executor")
        self.table_id = table_id
        self.num_blocks = num_blocks
        self._lock = threading.RLock()
        self._executors: List[str] = list(executors)
        # Even round-robin partitioning over associated executors
        # (ref: BlockManager even initial partitioning).
        self._owner: List[int] = [b % len(executors) for b in range(num_blocks)]
        self._listeners: List[OwnershipListener] = []

    # -- queries ---------------------------------------------------------

    @property
    def executors(self) -> List[str]:
        with self._lock:
            return list(self._executors)

    def owner_of(self, block_id: int) -> str:
        with self._lock:
            return self._executors[self._owner[block_id]]

    def blocks_of(self, executor: str) -> List[int]:
        with self._lock:
            idx = self._executors.index(executor)
            return [b for b, o in enumerate(self._owner) if o == idx]

    def block_counts(self) -> Dict[str, int]:
        with self._lock:
            counts = {e: 0 for e in self._executors}
            for o in self._owner:
                counts[self._executors[o]] += 1
            return counts

    def ownership_vector(self) -> List[int]:
        with self._lock:
            return list(self._owner)

    # -- mutation --------------------------------------------------------

    def subscribe(self, listener: OwnershipListener) -> None:
        """Register an ownership-update listener (ref: SubscriptionManager)."""
        with self._lock:
            self._listeners.append(listener)

    def unsubscribe(self, listener: OwnershipListener) -> None:
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    def _notify_locked(self) -> None:
        """Fire listeners with a consistent snapshot. Must be called with the
        lock held so concurrent mutators can't interleave stale snapshots out
        of order (listeners may re-enter the manager: RLock)."""
        snapshot = list(self._owner)
        for l in list(self._listeners):
            l(self.table_id, snapshot)

    def associate(self, executor: str) -> None:
        """Add an executor as a potential owner (no blocks moved yet)."""
        with self._lock:
            if executor in self._executors:
                raise ValueError(f"{executor} already associated")
            self._executors.append(executor)

    def unassociate(self, executor: str) -> None:
        """Remove an executor; it must no longer own blocks."""
        with self._lock:
            idx = self._executors.index(executor)
            if any(o == idx for o in self._owner):
                raise ValueError(f"{executor} still owns blocks")
            self._executors.pop(idx)
            self._owner = [o - 1 if o > idx else o for o in self._owner]
            self._notify_locked()

    def move(self, src: str, dst: str, num_blocks: int) -> List[int]:
        """Reassign ``num_blocks`` blocks src -> dst; returns moved block ids
        (ref: AllocatedTable.moveBlocks -> MigrationManager)."""
        with self._lock:
            si = self._executors.index(src)
            di = self._executors.index(dst)
            owned = [b for b, o in enumerate(self._owner) if o == si]
            if len(owned) < num_blocks:
                raise ValueError(
                    f"{src} owns only {len(owned)} blocks, asked to move {num_blocks}"
                )
            moved = owned[:num_blocks]
            for b in moved:
                self._owner[b] = di
            self._notify_locked()
        return moved

    def rebalance(self, executors: Sequence[str]) -> None:
        """Repartition all blocks evenly over ``executors`` (used when the
        executor set changes wholesale, e.g. mesh grow/shrink)."""
        if not executors:
            raise ValueError("need at least one executor")
        with self._lock:
            self._executors = list(executors)
            self._owner = [b % len(executors) for b in range(self.num_blocks)]
            self._notify_locked()


# -- shrink-plan helpers (elastic recovery) -------------------------------
#
# Pure functions over a CHECKPOINTED ownership vector (the manifest's
# block->executor-index map): when a follower is lost, the elastic
# recovery path needs to know (a) which blocks died with it — the set
# the partial restore must read back from the durable checkpoint — and
# (b) which survivor absorbs each of them in the rebuilt layout, for the
# recovery event log. Deterministic on every process by construction
# (both inputs are global metadata), like blockmove.plan_moves.


def lost_blocks(ownership: Sequence[int], executors: Sequence[str],
                lost_executors: Sequence[str]) -> List[int]:
    """Blocks owned by ``lost_executors`` in a checkpointed ownership
    vector — the O(lost) set a shrink recovery restores from durable
    storage (everything else lives on in survivors' recovery caches)."""
    gone = {executors.index(e) for e in lost_executors if e in executors}
    return [b for b, o in enumerate(ownership) if o in gone]


def shrink_plan(
    ownership: Sequence[int],
    executors: Sequence[str],
    lost_executors: Sequence[str],
    survivors: Sequence[str],
) -> Dict[str, object]:
    """The shrink remap summary: lost blocks round-robined over
    ``survivors`` (each survivor's absorbed share differs by at most one
    block — the dead follower's batch/storage share spreads evenly).
    Returns ``{"lost": [...], "absorbed": {survivor: [...]}}``; the
    physical layout the restored table actually uses is the even mesh
    partition over survivors, so this plan is the ACCOUNTING view the
    recovery event log and tests assert against."""
    if not survivors:
        raise ValueError("shrink plan needs at least one survivor")
    lost = lost_blocks(ownership, executors, lost_executors)
    absorbed: Dict[str, List[int]] = {s: [] for s in survivors}
    order = list(survivors)
    for i, b in enumerate(lost):
        absorbed[order[i % len(order)]].append(b)
    return {"lost": lost, "absorbed": absorbed}
