"""PregelMaster — the BSP superstep loop over device-resident tables.

Counterpart of ``harmony_tpu/pregel/master.py``: a vertex table and TWO
message tables (with their has-message flags) swapped every superstep, as the
reference's MessageManager swaps currentTable and nextTable; the loop ends
when every vertex has voted to halt and no message is in flight.

The tables live on the job's mesh (the reference's ``build_mesh(devices,
data=1)``: every slot on the model axis), block-sharded as PR 14's dense
tables are: shard ``k`` holds the contiguous vertex range of its blocks. A
device is taken as the one-slot mesh. One superstep (:meth:`_superstep`, one
:meth:`DenseTable.apply_step_multi` over the five tables) runs on each
shard's slot:

  * the vertex compute on the shard's own vertices
    (``Computation.compute_range``);
  * the all-gather: the shards' new states and halt votes joined in vertex
    order, once for each device the shards lie on (one card's virtual slots
    share one copy);
  * the gather of each edge's source state, ``new_state[src]``, through
    ``gather_rows`` (K1) on the edge's destination shard: a byte copy, so
    exact;
  * the edge messages, and their fold into the destination shard's range of
    the NEXT message table: ``"add"`` through ``segment_sum_rows`` (K2), with
    ids rebased to the shard, which adds each destination's messages in edge
    order from 0.0 with no float atomics; ``"min"``/``"max"`` and the
    has-message fold through ``scatter_reduce_`` (``amin``/``amax``, the
    table's identity included), exact in any order;
  * the CURRENT message tables reset to the identity once they have been
    read (the reference's donated swap).

The edges are partitioned by destination shard once, at set-up, with a stable
partition: each shard's fold sees its destinations' messages in the original
edge order, so a run on any number of shards gives the one-slot run's bits.
The superstep's two scalars (all halted, messages sent) combine over the
shards on the first slot and come back in one device-to-host copy. Under a
JobServer each superstep's launches run in a COMP TaskUnit (``taskunit``), so
a graph job interleaves with its co-tenants superstep by superstep.

On a mesh over the processes of a pod each process computes the shards it
holds, and the all-gather crosses processes: the new states and halt votes
of a process's shards, packed as one ``[rows, state_dim + 1]`` f32 tensor a
shard, go to every other process in one all-gather, and the flags of every
shard in a second, combined in shard order as above. The supersteps and the
final read of the vertex values run inside ``dispatch_turn`` (the job's pod
unit), where no co-tenant's collective can interleave.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows
from harmony_tpu_torch.parallel.mesh import Mesh
from harmony_tpu_torch.pregel.computation import Computation
from harmony_tpu_torch.pregel.graph import Graph
from harmony_tpu_torch.table.table import (
    DenseTable,
    ShardedArray,
    TableSpec,
    gather_shards,
    mesh_of,
    on_device,
)
from harmony_tpu_torch.utils.platform import DeviceLike

_REDUCE = {"min": "amin", "max": "amax"}


class _Shard:
    """One vertex range of the tables and the edges whose destination lies in
    it, on the slot that computes it: vertices ``lo .. lo + n - 1``; ``src``
    (global ids, int32), ``dst`` (rebased to the shard: int32 for K2, int64
    for ``scatter_reduce_``) and ``weight`` in the original edge order."""

    def __init__(self, k: int, slot, lo: int, n: int, graph: Graph,
                 edges: Optional[np.ndarray]) -> None:
        self.k, self.slot, self.lo, self.n = k, slot, lo, n
        dev = slot.device
        src, dst, weight = graph.src, graph.dst, graph.weight
        if edges is not None:
            src, dst, weight = src[edges], dst[edges] - np.int32(lo), weight[edges]
        self.src = torch.as_tensor(src, device=dev)
        self.dst = torch.as_tensor(dst, device=dev)
        self.dst64 = self.dst.long()
        self.weight = torch.as_tensor(weight, device=dev)

    @property
    def device(self) -> torch.device:
        """Where the shard's tensors lie (a slot's "cuda" as "cuda:0")."""
        return self.src.device


class PregelMaster:
    def __init__(
        self,
        graph: Graph,
        computation: Computation,
        mesh: "Mesh | DeviceLike" = None,
        max_supersteps: int = 100,
        taskunit: Optional[Any] = None,
        job_id: str = "pregel",
        dispatch_turn: Optional[Any] = None,
    ) -> None:
        if getattr(computation, "undirected", False):
            graph = graph.undirected()
        if computation.combiner not in ("add", *_REDUCE):
            raise ValueError(f"unknown combiner {computation.combiner!r}")
        if computation.combiner == "add" and computation.msg_identity != 0.0:
            # the fold adds from 0.0, as the reference's scatter onto zeros
            raise ValueError("an 'add' combiner's identity is 0.0")
        self.graph = graph
        self.comp = computation
        self.mesh = mesh_of(mesh)
        self.max_supersteps = max_supersteps
        self.taskunit = taskunit
        self.job_id = job_id
        self.dispatch_turn = dispatch_turn
        V = graph.num_vertices

        def table(name: str, vshape, update: str) -> DenseTable:
            # range tables (the config's default): a shard is a vertex range
            return DenseTable(TableSpec(TableConfig(
                table_id=f"{job_id}:{name}", capacity=V, value_shape=vshape,
                num_blocks=min(V, 64), update_fn=update)), self.mesh)

        self.vertex_table = table("vertices", (computation.state_dim,), "assign")
        # the two swapped message tables (current <-> next)
        self._msg_tables = [table("msg-a", (), computation.combiner),
                            table("msg-b", (), computation.combiner)]
        self._has_msg = [table("has-a", (), "max"), table("has-b", (), "max")]
        self.device = self.vertex_table.device     # the first slot's: host reads land here
        self._cur = 0
        self.superstep_count = 0
        # seed the vertex state, and the message tables with "no message"
        self.vertex_table.write_all(computation.initial_state(V, self.device))
        for mt in self._msg_tables:
            mt.write_all(torch.full((V,), computation.msg_identity, dtype=torch.float32,
                                    device=self.device))
        self._shards = self._partition(graph)

    def _rows_of(self, k: int) -> int:
        """Vertices of shard ``k`` (the last may hold fewer)."""
        V = self.graph.num_vertices
        return max(0, min(self._per, V - k * self._per))

    def _partition(self, graph: Graph) -> List[_Shard]:
        """One :class:`_Shard` for each shard this process holds, computed on
        the first of its slots that holds it; the edges split by destination
        shard, each part in the original edge order (a stable partition). One
        shard keeps every edge as it is."""
        sh = self.vertex_table.sharding
        V = graph.num_vertices
        reads = sh.read_slots(0)
        self._per = sh.blocks_per_shard * self.vertex_table.spec.block_size
        if sh.num_shards == 1:
            return [_Shard(0, reads[0], 0, V, graph, None)]
        of_edge = graph.dst // self._per
        return [_Shard(k, slot, k * self._per, self._rows_of(k), graph,
                       np.flatnonzero(of_edge == k))
                for k, slot in sorted(reads.items())]

    # -- one superstep ----------------------------------------------------

    def _views(self, arr, shard: _Shard, width: tuple) -> torch.Tensor:
        """Shard ``shard``'s real rows of a table's storage (a view)."""
        t = arr.shards[shard.slot] if isinstance(arr, ShardedArray) else arr
        return t.view(-1, *width)[:shard.n]

    def _all_gather(self, parts: List[torch.Tensor]) -> Dict[torch.device, torch.Tensor]:
        """The shards' rows joined in vertex order, once on each device a
        shard lies on."""
        if len(parts) == 1:
            return {self._shards[0].device: parts[0]}
        out: Dict[torch.device, torch.Tensor] = {}
        for s in self._shards:
            if s.device not in out:
                out[s.device] = torch.cat([on_device(p, s.device) for p in parts])
        return out

    def _remote_parts(self, new_states: List[torch.Tensor], halts: List[torch.Tensor]):
        """Every shard's new states and halt votes, in shard order, when
        other processes hold some: this process's shards packed as
        ``[per, state_dim + 1]`` f32 (a halt is 0.0 or 1.0, exact) and sent
        in one all-gather."""
        sh = self.vertex_table.sharding
        dev = self._shards[0].device
        packed = {}
        for s, st, h in zip(self._shards, new_states, halts):
            p = torch.zeros((self._per, st.shape[1] + 1), dtype=torch.float32, device=dev)
            p[:s.n, :-1] = on_device(st, dev)
            p[:s.n, -1] = on_device(h, dev).to(torch.float32)
            packed[s.k] = p
        parts = gather_shards(sh, 0, packed)
        rows = [p[:self._rows_of(k)] for k, p in enumerate(parts)]
        return [r[:, :-1] for r in rows], [r[:, -1] > 0.5 for r in rows]

    def _superstep(self, varr, cur_msg, cur_has, nxt_msg, nxt_has, step: int):
        comp = self.comp
        identity = comp.msg_identity
        S = (comp.state_dim,)
        shards = self._shards
        new_states, halts = [], []
        for s in shards:
            state = self._views(varr, s, S)                     # views of the shard's
            msg = self._views(cur_msg, s, ())                   # storage
            has_msg = self._views(cur_has, s, ()) > 0.5
            new_state, halt = comp.compute_range(step, state, msg, has_msg, s.lo)
            new_states.append(new_state.to(torch.float32).contiguous())
            halts.append(halt)
        if len(shards) < self.vertex_table.sharding.num_shards:
            every_state, every_halt = self._remote_parts(new_states, halts)
        else:
            every_state, every_halt = new_states, halts
        all_states = self._all_gather(every_state)
        all_halts = self._all_gather(every_halt)
        flags = []
        for s, halt in zip(shards, halts):
            # active vertices send along their out-edges; halted ones send nothing
            edge_vals = comp.edge_message(step, gather_rows(all_states[s.device], s.src),
                                          s.weight)
            edge_on = torch.index_select(~all_halts[s.device], 0, s.src)
            edge_vals = torch.where(edge_on, edge_vals, identity)
            # fold per destination into the shard's range of the NEXT tables
            nxt = self._views(nxt_msg, s, ())
            if comp.combiner == "add":
                nxt.copy_(segment_sum_rows(edge_vals[:, None].contiguous(), s.dst, s.n)[:, 0])
            else:
                nxt.fill_(identity).scatter_reduce_(
                    0, s.dst64, edge_vals, _REDUCE[comp.combiner], include_self=True)
            nxt_has_msg = self._views(nxt_has, s, ())
            nxt_has_msg.zero_().scatter_reduce_(
                0, s.dst64, edge_on.to(torch.float32), "amax", include_self=True)
            flags.append(torch.stack([halt.all().to(torch.float32),
                                      nxt_has_msg.sum()]))
        for s, new_state in zip(shards, new_states):
            self._views(varr, s, S).copy_(new_state)
            # reset the CURRENT tables, read above, for reuse as next-next
            self._views(cur_msg, s, ()).fill_(identity)
            self._views(cur_has, s, ()).zero_()
        self._to_replicas(varr, cur_msg, cur_has, nxt_msg, nxt_has)
        return (varr, cur_msg, cur_has, nxt_msg, nxt_has), self._combine(flags)

    def _combine(self, flags: List[torch.Tensor]) -> torch.Tensor:
        """(all halted, messages sent) over the shards, in shard order, on the
        first shard's device: the superstep's one host read."""
        dev = self._shards[0].device
        sh = self.vertex_table.sharding
        if len(flags) < sh.num_shards:
            flags = gather_shards(sh, 0, {s.k: on_device(f, dev)
                                          for s, f in zip(self._shards, flags)})
        if len(flags) == 1:
            return flags[0]
        f = torch.stack([on_device(x, dev) for x in flags])
        return torch.stack([f[:, 0].min(), f[:, 1].sum()])

    def _to_replicas(self, *arrs) -> None:
        """Copy each computed shard to the other slots that hold it (a table
        replicated over the mesh: its vertex count does not split into the
        slots' block runs)."""
        owners = {s.slot for s in self._shards}
        owner_of = {s.k: s.slot for s in self._shards}
        for arr in arrs:
            if not isinstance(arr, ShardedArray):
                continue
            sh = arr.sharding
            for slot, t in arr.shards.items():
                if slot not in owners:
                    src = arr.shards[owner_of[sh.shard_of(slot)]]
                    t.copy_(on_device(src, t.device))

    # -- the loop (SuperstepControlMsg flow) ------------------------------

    def run(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        for step in range(self.max_supersteps):
            cur, nxt = self._cur, 1 - self._cur
            tables = [self.vertex_table, self._msg_tables[cur], self._has_msg[cur],
                      self._msg_tables[nxt], self._has_msg[nxt]]
            with self._turn(), self._tu("COMP"):
                flags = DenseTable.apply_step_multi(tables, self._superstep, step)
            self.superstep_count = step + 1
            self._cur = nxt  # the table swap (MessageManager.swap)
            all_halted, num_msgs = flags.tolist()    # the superstep's one host read
            if all_halted and num_msgs == 0.0:
                break
        with self._turn():
            values = self.vertex_values()
        return {
            "supersteps": self.superstep_count,
            "wall_sec": time.perf_counter() - t0,
            "vertex_values": values,
        }

    def vertex_values(self) -> np.ndarray:
        """The vertex table in vertex order, on the host: [V, state_dim]; on a
        mesh the shards are read in block order (the reference's
        ``_collect_values``)."""
        return self.vertex_table.pull_array().cpu().numpy()

    def _turn(self):
        """The job's pod unit (``dispatch_turn``), else a no-op."""
        if self.dispatch_turn is None:
            return contextlib.nullcontext()
        return self.dispatch_turn()

    def _tu(self, kind: str):
        if self.taskunit is None:
            return contextlib.nullcontext()
        return self.taskunit.scope(kind)

    def close(self) -> None:
        """Release every device-resident table (vertices and both message
        double-buffers, every shard) and the edge arrays. Job entities call
        this instead of reaching into internals."""
        for t in [self.vertex_table, *self._msg_tables, *self._has_msg]:
            t.drop()
        self._shards = []
