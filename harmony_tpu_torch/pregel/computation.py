"""The vertex computation SPI.

Counterpart of ``harmony_tpu/pregel/computation.py`` (the reference's
``Computation`` + ``Vertex`` API and its message combiners), vectorised over
every vertex at once:

  * ``compute(superstep, state, msg, has_msg)``: the new state of all
    vertices and a vote-to-halt mask; a halted vertex that receives a message
    is active again, as in Pregel.
  * ``compute_range(superstep, state, msg, has_msg, first)``: the same over
    the vertices ``first``, ``first + 1``, ... of one shard of the tables
    (``pregel/master.py`` on a mesh). It is ``compute`` for a computation
    that reads nothing but each vertex's own values; one whose compute reads
    vertex ids overrides it (shortest path's source).
  * ``edge_message(superstep, src_state, weight)``: the value each edge
    carries from its source, over all edges; the master folds the messages
    to one destination with ``combiner`` ("add", "min" or "max").

``superstep`` is a Python int: the host runs the superstep loop and knows
it, so no device scalar carries it.
"""
from __future__ import annotations

from typing import Tuple

import torch


class Computation:
    combiner: str = "add"        # fold of the messages to one destination
    state_dim: int = 1           # per-vertex state width
    # the combiner's identity; also the "no message" value
    msg_identity: float = 0.0
    # True: messages flow along both directions of every edge; the master
    # symmetrises the graph first (Graph.undirected)
    undirected: bool = False

    def initial_state(self, num_vertices: int, device: torch.device) -> torch.Tensor:
        """[num_vertices, state_dim] f32 initial vertex values on ``device``."""
        raise NotImplementedError

    def compute(
        self,
        superstep: int,
        state: torch.Tensor,      # [V, state_dim]
        msg: torch.Tensor,        # [V] combined incoming message
        has_msg: torch.Tensor,    # [V] bool
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (new_state [V, state_dim], vote_to_halt [V] bool)."""
        raise NotImplementedError

    def compute_range(
        self,
        superstep: int,
        state: torch.Tensor,      # [n, state_dim], vertices first .. first + n - 1
        msg: torch.Tensor,
        has_msg: torch.Tensor,
        first: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``compute`` on one vertex range (see the module doc)."""
        return self.compute(superstep, state, msg, has_msg)

    def edge_message(
        self,
        superstep: int,
        src_state: torch.Tensor,  # [E, state_dim] gathered source states
        weight: torch.Tensor,     # [E]
    ) -> torch.Tensor:
        """[E] message values carried along each edge."""
        raise NotImplementedError
