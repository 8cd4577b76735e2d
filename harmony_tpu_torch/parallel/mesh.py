"""Slots, meshes over them, and the pool that executors lease slots from.

Counterpart of ``harmony_tpu/parallel/mesh.py``. The reference is a single
controller: one process holds every executor, each owning one ``jax.Device``,
and a table over several executors is one block-major array sharded over a
``jax.sharding.Mesh`` of their devices. The port keeps that shape in one
process over torch devices:

  * a :class:`Slot` is a numbered place on one ``torch.device``; it plays the
    role of a ``jax.Device``. A table keeps one shard tensor for each slot of
    its mesh, and each slot receives its own kernel launches;
  * a :class:`Mesh` is an array of slots with named axes (``DATA_AXIS``,
    ``MODEL_AXIS``, ``SEQ_AXIS``, the reference's names), built by
    :func:`build_mesh` with the reference's axis rule and errors;
  * the :class:`DevicePool` leases slots to executors, exclusively or all of
    them shared (the share-all scheduler's multi-tenant overlap), and tracks
    which leases overlap.

``DevicePool()`` is one slot per visible card (it raises with none);
``DevicePool(["cpu"])`` one CPU slot. ``DevicePool.virtual(device, n)`` puts
``n`` slots on ONE device: the counterpart of XLA's
``--xla_force_host_platform_device_count``, with which the reference's tests
simulate a mesh, for tests and ``chip_smoke.py`` only. Several processes (the
reference's multi-host pod, ``torch.distributed`` in the port) are not ported
yet: :func:`mesh_spans_processes` is always False here.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from harmony_tpu_torch.utils.platform import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


class Slot:
    """A numbered place on one device (the port's ``jax.Device``). Two slots
    of one pool never share an index; two slots may share a device."""

    __slots__ = ("index", "device")

    def __init__(self, index: int, device: torch.device) -> None:
        self.index = int(index)
        self.device = device

    def _key(self) -> Tuple[int, str]:
        return self.index, str(self.device)

    def __eq__(self, other) -> bool:
        return isinstance(other, Slot) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Slot({self.index}, {self.device})"


SlotLike = Union[Slot, DeviceLike]


def as_slots(items: Sequence[SlotLike]) -> List[Slot]:
    """Slots as they are; a device becomes the slot numbered by its position."""
    return [s if isinstance(s, Slot) else Slot(i, resolve_device(s))
            for i, s in enumerate(items)]


class Mesh:
    """Slots arranged on named axes (the reference's ``jax.sharding.Mesh``):
    ``devices`` is the object array of slots, ``shape`` maps each axis name to
    its size in axis order."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]) -> None:
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d slot array for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def slots(self) -> List[Slot]:
        """Every slot, in the array's (row-major) order."""
        return list(self.devices.flat)

    def slot_at(self, coords: Dict[str, int]) -> Slot:
        """The slot at the given index of each named axis (index 0 on an axis
        not named)."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no mesh axes {sorted(unknown)} in {self.axis_names}")
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat, other.devices.flat)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.slots})"


def build_mesh(
    slots: Sequence[SlotLike],
    data: Optional[int] = None,
    model: Optional[int] = None,
    seq: Optional[int] = None,
) -> Mesh:
    """A (data, model) mesh, or (data, seq, model) when ``seq`` is given,
    over ``slots`` (torch devices are taken as one slot each).

    The reference's rule: all slots on the data axis by default (other axes
    size 1); any axis size may be given and one missing axis is derived; the
    model axis is the last, so a model shard's neighbours are adjacent
    slots."""
    slots = as_slots(slots)
    n = len(slots)
    if seq is None:
        sizes = {"data": data, "model": model}
        names = (DATA_AXIS, MODEL_AXIS)
    else:
        sizes = {"data": data, "seq": seq, "model": model}
        names = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)
    unknown = [k for k, v in sizes.items() if v is None]
    known = int(np.prod([v for v in sizes.values() if v is not None])) or 1
    if len(unknown) > 1:
        if set(unknown) == {"data", "model"} and n % known == 0:
            sizes["data"], sizes["model"] = n // known, 1
        else:
            raise ValueError(f"underdetermined mesh axes {unknown}")
    elif len(unknown) == 1:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {sizes}")
        sizes[unknown[0]] = n // known
    total = int(np.prod(list(sizes.values())))
    if total != n:
        raise ValueError(f"mesh {sizes} != num devices {n}")
    order = ("data", "seq", "model") if seq is not None else ("data", "model")
    arr = np.empty(n, dtype=object)
    arr[:] = slots
    return Mesh(arr.reshape(*[sizes[k] for k in order]), names)


def mesh_spans_processes(mesh: Mesh) -> bool:
    """Whether the mesh's slots live in more than one process: never, in the
    port's single controller (kept for the branches that read it)."""
    return False


class DevicePool:
    """Thread-safe pool of slots carved into per-job (or per-executor) leases."""

    def __init__(self, devices: Optional[Sequence[SlotLike]] = None) -> None:
        if devices is None:
            resolve_device(None)   # raises when there is no card
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        slots = as_slots(devices)
        if not slots or len(set(slots)) != len(slots):
            raise ValueError(f"a device pool needs distinct slots, got {slots}")
        if not all(isinstance(d, Slot) for d in devices):
            devs = [s.device for s in slots]
            if len(set(devs)) != len(devs):
                raise ValueError(
                    f"a device pool needs distinct devices, got {devs} "
                    "(DevicePool.virtual puts several slots on one device)")
        self._slots: List[Slot] = slots
        self._lock = threading.Lock()
        self._leases: Dict[str, List[Slot]] = {}
        self._exclusive: Dict[str, bool] = {}

    @classmethod
    def virtual(cls, device: DeviceLike, n: int) -> "DevicePool":
        """``n`` slots on one device: a simulated mesh, as the reference's
        tests make one with XLA's virtual CPU devices. For tests and
        ``chip_smoke.py``; no entry point builds one."""
        dev = resolve_device(device)
        if n < 1:
            raise ValueError(f"a virtual pool needs at least one slot, got {n}")
        return cls([Slot(i, dev) for i in range(n)])

    @property
    def slots(self) -> List[Slot]:
        return list(self._slots)

    @property
    def devices(self) -> List[torch.device]:
        """The device of each slot, in slot order (repeated for virtual slots)."""
        return [s.device for s in self._slots]

    def __len__(self) -> int:
        return len(self._slots)

    def lease_all(self, job_id: str) -> List[Slot]:
        """Grant every slot, shared (may overlap other leases)."""
        with self._lock:
            slots = list(self._slots)
            self._leases[job_id] = slots
            self._exclusive[job_id] = False
            return slots

    def lease(self, job_id: str, n: int) -> List[Slot]:
        """Grant ``n`` slots that no other exclusive lease holds (shared
        leases coexist with anything); all or nothing."""
        with self._lock:
            taken = {s for j, ss in self._leases.items() if self._exclusive[j] for s in ss}
            free = [s for s in self._slots if s not in taken]
            if len(free) < n:
                raise RuntimeError(f"need {n} devices, only {len(free)} free")
            slots = free[:n]
            self._leases[job_id] = slots
            self._exclusive[job_id] = True
            return slots

    def release(self, job_id: str) -> None:
        with self._lock:
            self._leases.pop(job_id, None)
            self._exclusive.pop(job_id, None)

    def lease_of(self, job_id: str) -> List[Slot]:
        with self._lock:
            return list(self._leases.get(job_id, []))

    def overlapping_jobs(self, job_id: str) -> List[str]:
        """Leases that share at least one slot with ``job_id``'s."""
        with self._lock:
            mine = set(self._leases.get(job_id, []))
            return [j for j, ss in self._leases.items()
                    if j != job_id and mine.intersection(ss)]
