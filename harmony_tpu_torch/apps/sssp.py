"""Single-source shortest path on the Pregel framework.

Counterpart of ``harmony_tpu/apps/sssp.py`` (the reference's shortest-path
graph app): the source starts at distance 0, every other vertex at INF; a
vertex takes min(current, min incoming message) and, when that improved it,
sends dist + edge weight along its out-edges; a vertex that did not improve
votes to halt (message-driven Bellman-Ford). Combiner: min.
"""
from __future__ import annotations

from typing import Tuple

import torch

from harmony_tpu_torch.pregel.computation import Computation

INF = 1e9  # exact in f32


class ShortestPathComputation(Computation):
    combiner = "min"
    state_dim = 1
    msg_identity = INF

    def __init__(self, source: int) -> None:
        self.source = source

    def initial_state(self, num_vertices: int, device: torch.device) -> torch.Tensor:
        dist = torch.full((num_vertices,), INF, dtype=torch.float32, device=device)
        dist[self.source] = 0.0
        return dist[:, None]

    def compute(self, superstep, state, msg, has_msg) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.compute_range(superstep, state, msg, has_msg, 0)

    def compute_range(self, superstep, state, msg, has_msg, first):
        """Vertex ``first + i`` at row ``i``: the source is found by its id."""
        dist = state[:, 0]
        candidate = torch.where(has_msg, msg, INF)
        new_dist = torch.minimum(dist, candidate)
        # superstep 0: only the source is active; afterwards only vertices
        # that improved keep sending, everyone else votes to halt
        if superstep == 0:
            ids = torch.arange(first, first + dist.shape[0], device=dist.device)
            active = ids == self.source
        else:
            active = new_dist < dist
        return new_dist[:, None], ~active

    def edge_message(self, superstep, src_state, weight) -> torch.Tensor:
        return src_state[:, 0] + weight
