"""The pod's runtime: processes joined over ``torch.distributed``.

Counterpart of ``harmony_tpu/parallel/multihost.py``. The reference joins
every host process to ``jax.distributed``, after which ``jax.devices()`` is
the global device list. Here each process drives the slots of its own cards
(``parallel/mesh.py``), and :func:`initialize_distributed` joins the
processes into one ``torch.distributed`` world:

  * a store at the coordinator (a TCP store at ``host:port``, or a file
    store at ``file:///path``, which the tests use) through which every
    process publishes the devices it drives; :func:`global_slots` is then
    the same list in every process, process by process;
  * the backend, chosen once from that topology and printed: NCCL when
    every process drives cards of its own, gloo when two processes share a
    card (NCCL refuses two ranks on one device) or run on the CPU. It is
    never chosen by catching an error;
  * a process group for every set of two or more processes, made in one
    fixed order by every process while the pod starts (:func:`group_of`): a
    group made later, by a job's thread, could deadlock the pod;
  * the groups' timeout, ``HARMONY_POD_UNIT_TIMEOUT`` seconds (600 by
    default, the unit protocol's), so a wedged collective raises.

The arguments default from the environment ``torchrun`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), and a half-configured launch fails
with the reference's errors. Outside a pod every function is its
single-process form.
"""
from __future__ import annotations

import datetime
import itertools
import json
import os
import socket
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from harmony_tpu_torch.parallel import mesh as _mesh
from harmony_tpu_torch.parallel.mesh import Mesh, Slot, build_mesh


class _Pod:
    """What this process knows of its pod once it has joined."""

    def __init__(self, rank: int, world: int, backend: str, reason: str,
                 devices: List[List[str]], local: List[torch.device]) -> None:
        self.rank = rank
        self.world = world
        self.backend = backend
        self.reason = reason
        self.devices = devices          # process -> its devices, by name
        self.local = local              # this process's devices
        self.groups: Dict[Tuple[int, ...], object] = {}


_POD: Optional[_Pod] = None


def unit_timeout() -> float:
    """Seconds a collective may wait for its peers (the unit protocol's
    ``HARMONY_POD_UNIT_TIMEOUT``)."""
    return float(os.environ.get("HARMONY_POD_UNIT_TIMEOUT", "600"))


def _device_identity(dev: torch.device) -> str:
    """Which physical device ``dev`` is, comparable across processes: a
    card's UUID (the host and the card's index where torch has no UUID),
    "cpu" for the CPU."""
    if dev.type != "cuda":
        return "cpu"
    props = torch.cuda.get_device_properties(dev)
    uuid = getattr(props, "uuid", None)
    if uuid is not None:
        return f"cuda-{uuid}"
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    ids = [v for v in visible.split(",") if v] or None
    idx = dev.index or 0
    return f"cuda-{socket.gethostname()}-{ids[idx] if ids else idx}"


def choose_backend(identities: Sequence[Sequence[str]]) -> Tuple[str, str]:
    """(backend, reason) from every process's device identities: NCCL when
    every process drives cards and no card is driven by two processes, else
    gloo."""
    flat = [i for ids in identities for i in ids]
    if not flat or any(not i.startswith("cuda-") for i in flat):
        return "gloo", "a process runs on the CPU"
    if len(set(flat)) != len(flat):
        return "gloo", "processes share a card"
    return "nccl", "each process drives cards of its own"


def _open_store(coordinator: str, world: int, rank: int, timeout: datetime.timedelta):
    if coordinator.startswith("file://"):
        return dist.FileStore(coordinator[len("file://"):], world)
    addr = coordinator[len("tcp://"):] if coordinator.startswith("tcp://") else coordinator
    host, _, port = addr.rpartition(":")
    # under torchrun its agent already serves the store at MASTER_PORT
    serve = rank == 0 and os.environ.get("TORCHELASTIC_USE_AGENT_STORE") != "True"
    return dist.TCPStore(host or "127.0.0.1", int(port), world, serve, timeout=timeout)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> bool:
    """Join the pod (the reference's ``initialize_distributed``).

    ``devices`` are the devices this process drives (default: every visible
    card). The arguments default from ``MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``. Returns True once a multi-process world is
    up, False for the single-process form (no coordinator, one process)."""
    global _POD
    if _POD is not None:
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", 0))
    if not coordinator_address and num_processes <= 1:
        return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    # a half-configured launch fails loudly: going on alone while the peers
    # wait at the coordinator is a silent hang and a wrong topology
    if not coordinator_address or num_processes <= 1:
        raise ValueError(
            "incomplete multi-host config: need BOTH a coordinator address "
            f"and num_processes > 1 (got coordinator={coordinator_address!r}, "
            f"num_processes={num_processes})")
    rank_env = os.environ.get("RANK")
    if process_id is None and rank_env is None:
        raise ValueError(
            "incomplete multi-host config: RANK (or process_id=) is required "
            "when a coordinator is configured")
    rank = process_id if process_id is not None else int(rank_env)
    from harmony_tpu_torch.utils.platform import resolve_device

    if devices is None:
        resolve_device(None)  # raises without a card
        local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        local = [resolve_device(d) for d in devices]
    local = [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda"
             and d.index is None else d for d in local]
    timeout = datetime.timedelta(seconds=unit_timeout())
    store = _open_store(coordinator_address, num_processes, rank, timeout)
    store.set(f"harmony/devices/{rank}", json.dumps(
        {"names": [str(d) for d in local], "ids": [_device_identity(d) for d in local]}))
    table = [json.loads(store.get(f"harmony/devices/{p}").decode())
             for p in range(num_processes)]
    backend, reason = choose_backend([t["ids"] for t in table])
    if backend == "nccl":
        torch.cuda.set_device(local[0])
    dist.init_process_group(backend, store=dist.PrefixStore("harmony/pg", store),
                            rank=rank, world_size=num_processes, timeout=timeout)
    pod = _Pod(rank, num_processes, backend, reason, [t["names"] for t in table], local)
    everyone = tuple(range(num_processes))
    pod.groups[everyone] = dist.group.WORLD
    # every set of two or more processes, in one fixed order in every process
    for size in range(2, num_processes):
        for ranks in itertools.combinations(everyone, size):
            pod.groups[ranks] = dist.new_group(list(ranks), timeout=timeout,
                                               backend=backend)
    _POD = pod
    _mesh._THIS_PROCESS[0] = rank
    print(f"pod process {rank} of {num_processes}: torch.distributed backend "
          f"{backend} ({reason}); devices {[str(d) for d in local]}", flush=True)
    return True


def shutdown_distributed() -> None:
    """Leave the pod: destroy the process groups (a no-op outside one)."""
    global _POD
    if _POD is None:
        return
    _POD = None
    _mesh._THIS_PROCESS[0] = 0
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return _POD.rank if _POD is not None else 0


def process_count() -> int:
    return _POD.world if _POD is not None else 1


def is_multihost() -> bool:
    return process_count() > 1


def backend() -> Optional[str]:
    """The pod's backend ("nccl" or "gloo"), None outside a pod."""
    return _POD.backend if _POD is not None else None


def local_devices() -> List[torch.device]:
    return list(_POD.local) if _POD is not None else []


def global_slots() -> List[Slot]:
    """Every slot of the pod, process by process, each process's devices in
    its own order: the same list in every process (a slot of this process
    carries its torch device)."""
    if _POD is None:
        raise RuntimeError("not in a pod: initialize_distributed first")
    out: List[Slot] = []
    for p, names in enumerate(_POD.devices):
        for j, name in enumerate(names):
            dev = _POD.local[j] if p == _POD.rank else torch.device(name)
            out.append(Slot(len(out), dev, p))
    return out


def global_mesh(data=None, model=None, seq=None) -> Mesh:
    """A mesh over the pod's global slots."""
    return build_mesh(global_slots(), data=data, model=model, seq=seq)


def group_of(processes: Sequence[int]):
    """The process group of ``processes`` (two or more), made when the pod
    started."""
    key = tuple(sorted(set(int(p) for p in processes)))
    if _POD is None:
        raise RuntimeError(f"processes {key}: not in a pod")
    try:
        return _POD.groups[key]
    except KeyError:
        raise ValueError(f"no process group for {key} in a pod of {_POD.world}") from None


def mesh_sum(mesh: Mesh, value: float, tag: str = "") -> float:
    """A per-process scalar summed over ONLY the processes holding slots of
    ``mesh``, in process order (each contributes ``value`` once). Doubles as
    the mesh's barrier: it returns once every such process has called it.
    ``tag`` documents the call; collectives match by their order. A mesh of
    one process returns ``value``."""
    from harmony_tpu_torch.parallel.collectives import process_all_gather

    if not _mesh.mesh_spans_processes(mesh):
        return value
    parts = process_all_gather(torch.tensor([float(value)], dtype=torch.float64),
                               mesh.processes)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return float(total[0])


def mesh_barrier(mesh: Mesh, tag: str = "barrier") -> None:
    """The mesh's barrier (see :func:`mesh_sum`)."""
    mesh_sum(mesh, 0.0, tag)


def sync_global_devices(tag: str = "barrier") -> None:
    """Wait for this process's devices, then (in a pod) for every process."""
    for d in local_devices():
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    if is_multihost():
        mesh_sum(global_mesh(), 0.0, tag)
