"""PregelMaster — the BSP superstep loop over device-resident tables.

Counterpart of ``harmony_tpu/pregel/master.py``: a vertex table and TWO
message tables (with their has-message flags) swapped every superstep, as the
reference's MessageManager swaps currentTable and nextTable; the loop ends
when every vertex has voted to halt and no message is in flight.

One superstep (:meth:`_superstep`, one :meth:`DenseTable.apply_step_multi`
over the five tables):

  * the vertex compute, vectorised over all vertices;
  * the gather of each edge's source state, ``new_state[src]``, through
    ``gather_rows`` (K1): a byte copy, so exact;
  * the edge messages, and their fold per destination into the NEXT message
    table: ``"add"`` through ``segment_sum_rows`` (K2), which adds each
    destination's messages in edge order from 0.0 with no float atomics, so
    the card gives the CPU's bits; ``"min"``/``"max"`` and the has-message
    fold through ``scatter_reduce_`` (``amin``/``amax``, the table's identity
    included), exact in any order;
  * the CURRENT message tables reset to the identity once they have been
    read (the reference's donated swap).

The superstep's two scalars (all halted, messages sent) come back in one
device-to-host copy. The tables live on one device: there is no mesh
argument (ROADMAP A.9).
"""
from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows
from harmony_tpu_torch.pregel.computation import Computation
from harmony_tpu_torch.pregel.graph import Graph
from harmony_tpu_torch.table.table import DenseTable, TableSpec
from harmony_tpu_torch.utils.platform import DeviceLike, resolve_device

_REDUCE = {"min": "amin", "max": "amax"}


class PregelMaster:
    def __init__(
        self,
        graph: Graph,
        computation: Computation,
        device: DeviceLike = None,
        max_supersteps: int = 100,
        job_id: str = "pregel",
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
        self.device = resolve_device(device)
        self.max_supersteps = max_supersteps
        self.job_id = job_id
        V = graph.num_vertices

        def table(name: str, vshape, update: str) -> DenseTable:
            # range tables (the config's default): pull_all is a view
            return DenseTable(TableSpec(TableConfig(
                table_id=f"{job_id}:{name}", capacity=V, value_shape=vshape,
                num_blocks=min(V, 64), update_fn=update)), self.device)

        self.vertex_table = table("vertices", (computation.state_dim,), "assign")
        # the two swapped message tables (current <-> next)
        self._msg_tables = [table("msg-a", (), computation.combiner),
                            table("msg-b", (), computation.combiner)]
        self._has_msg = [table("has-a", (), "max"), table("has-b", (), "max")]
        self._cur = 0
        self.superstep_count = 0
        # seed the vertex state, and the message tables with "no message"
        self.vertex_table.write_all(computation.initial_state(V, self.device))
        for mt in self._msg_tables:
            mt.write_all(torch.full((V,), computation.msg_identity, dtype=torch.float32,
                                    device=self.device))
        # the edge arrays on the device, once, as int32 (K1's and K2's ids);
        # scatter_reduce_ takes its destinations as int64
        self._src = torch.as_tensor(graph.src, device=self.device)
        self._dst = torch.as_tensor(graph.dst, device=self.device)
        self._dst64 = self._dst.long()
        self._weight = torch.as_tensor(graph.weight, device=self.device)

    # -- one superstep ----------------------------------------------------

    def _superstep(self, varr, cur_msg, cur_has, nxt_msg, nxt_has, step: int):
        comp = self.comp
        vspec = self.vertex_table.spec
        mspec = self._msg_tables[0].spec
        hspec = self._has_msg[0].spec
        V = self.graph.num_vertices
        identity = comp.msg_identity
        state = vspec.pull_all(varr)                     # [V, S], views of the
        msg = mspec.pull_all(cur_msg)                    # range tables' storage
        has_msg = hspec.pull_all(cur_has) > 0.5
        new_state, halt = comp.compute(step, state, msg, has_msg)
        new_state = new_state.to(torch.float32).contiguous()
        # active vertices send along their out-edges; halted ones send nothing
        edge_vals = comp.edge_message(step, gather_rows(new_state, self._src), self._weight)
        edge_on = torch.index_select(~halt, 0, self._src)
        edge_vals = torch.where(edge_on, edge_vals, identity)
        # fold per destination into the NEXT tables
        nxt = mspec.pull_all(nxt_msg)
        if comp.combiner == "add":
            nxt.copy_(segment_sum_rows(edge_vals[:, None].contiguous(), self._dst, V)[:, 0])
        else:
            nxt.fill_(identity).scatter_reduce_(
                0, self._dst64, edge_vals, _REDUCE[comp.combiner], include_self=True)
        nxt_has_msg = hspec.pull_all(nxt_has)
        nxt_has_msg.zero_().scatter_reduce_(
            0, self._dst64, edge_on.to(torch.float32), "amax", include_self=True)
        flags = torch.stack([halt.all().to(torch.float32), nxt_has_msg.sum()])
        vspec.pull_all(varr).copy_(new_state)
        # reset the CURRENT tables, read above, for reuse as next-next
        msg.fill_(identity)
        hspec.pull_all(cur_has).zero_()
        return (varr, cur_msg, cur_has, nxt_msg, nxt_has), flags

    # -- the loop (SuperstepControlMsg flow) ------------------------------

    def run(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        for step in range(self.max_supersteps):
            cur, nxt = self._cur, 1 - self._cur
            tables = [self.vertex_table, self._msg_tables[cur], self._has_msg[cur],
                      self._msg_tables[nxt], self._has_msg[nxt]]
            flags = DenseTable.apply_step_multi(tables, self._superstep, step)
            self.superstep_count = step + 1
            self._cur = nxt  # the table swap (MessageManager.swap)
            all_halted, num_msgs = flags.tolist()    # the superstep's one host read
            if all_halted and num_msgs == 0.0:
                break
        return {
            "supersteps": self.superstep_count,
            "wall_sec": time.perf_counter() - t0,
            "vertex_values": self.vertex_values(),
        }

    def vertex_values(self) -> np.ndarray:
        """The vertex table in vertex order, on the host: [V, state_dim]."""
        return self.vertex_table.pull_array().cpu().numpy()

    def close(self) -> None:
        """Release every device-resident table (vertices and both message
        double-buffers) and the edge arrays. Job entities call this instead
        of reaching into internals."""
        for t in [self.vertex_table, *self._msg_tables, *self._has_msg]:
            t.drop()
        self._src = self._dst = self._dst64 = self._weight = None
