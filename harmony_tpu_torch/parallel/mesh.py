"""The device pool that executors lease their devices from.

Counterpart of ``harmony_tpu/parallel/mesh.py``'s ``DevicePool``, over
``torch.device``s: the JobServer's resource layer (the reference's
ResourcePool). A job or executor leases ``n`` devices exclusively, or all of
them shared (the share-all scheduler's multi-tenant overlap); the pool tracks
which leases overlap. The default pool is every visible card; with none it
raises, and a CPU pool must be asked for (``DevicePool([torch.device("cpu")])``).
Meshes over several cards are not ported yet (ROADMAP A.9).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import torch

from harmony_tpu_torch.utils.platform import DeviceLike, resolve_device


class DevicePool:
    """Thread-safe pool of devices carved into per-job (or per-executor) leases."""

    def __init__(self, devices: Optional[Sequence[DeviceLike]] = None) -> None:
        if devices is None:
            resolve_device(None)   # raises when there is no card
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self._devices: List[torch.device] = [resolve_device(d) for d in devices]
        if not self._devices or len(set(self._devices)) != len(self._devices):
            raise ValueError(f"a device pool needs distinct devices, got {self._devices}")
        self._lock = threading.Lock()
        self._leases: Dict[str, List[torch.device]] = {}
        self._exclusive: Dict[str, bool] = {}

    @property
    def devices(self) -> List[torch.device]:
        return list(self._devices)

    def __len__(self) -> int:
        return len(self._devices)

    def lease_all(self, job_id: str) -> List[torch.device]:
        """Grant every device, shared (may overlap other leases)."""
        with self._lock:
            devs = list(self._devices)
            self._leases[job_id] = devs
            self._exclusive[job_id] = False
            return devs

    def lease(self, job_id: str, n: int) -> List[torch.device]:
        """Grant ``n`` devices that no other exclusive lease holds (shared
        leases coexist with anything); all or nothing."""
        with self._lock:
            taken = {d for j, ds in self._leases.items() if self._exclusive[j] for d in ds}
            free = [d for d in self._devices if d not in taken]
            if len(free) < n:
                raise RuntimeError(f"need {n} devices, only {len(free)} free")
            devs = free[:n]
            self._leases[job_id] = devs
            self._exclusive[job_id] = True
            return devs

    def release(self, job_id: str) -> None:
        with self._lock:
            self._leases.pop(job_id, None)
            self._exclusive.pop(job_id, None)

    def lease_of(self, job_id: str) -> List[torch.device]:
        with self._lock:
            return list(self._leases.get(job_id, []))

    def overlapping_jobs(self, job_id: str) -> List[str]:
        """Leases that share at least one device with ``job_id``'s."""
        with self._lock:
            mine = set(self._leases.get(job_id, []))
            return [j for j, ds in self._leases.items()
                    if j != job_id and mine.intersection(ds)]
