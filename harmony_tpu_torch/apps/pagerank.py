"""PageRank on the Pregel framework.

Counterpart of ``harmony_tpu/apps/pagerank.py`` (the reference's PageRank
graph app): superstep 0 seeds rank 1/N and every vertex sends
rank/out_degree along its edges; later supersteps set rank = 0.15/N + 0.85 *
sum(messages); every vertex votes to halt once ``superstep >=
num_iterations``, which makes exactly ``num_iterations`` rank updates.
Combiner: add (K2 on the card).
"""
from __future__ import annotations

from typing import Tuple

import torch

from harmony_tpu_torch.pregel.computation import Computation
from harmony_tpu_torch.pregel.graph import Graph


class PageRankComputation(Computation):
    combiner = "add"
    state_dim = 2  # [rank, out_degree]
    msg_identity = 0.0

    def __init__(self, graph: Graph, num_iterations: int = 10, damping: float = 0.85):
        self.num_vertices = graph.num_vertices
        self.out_degree = graph.out_degree
        self.num_iterations = num_iterations
        self.damping = damping

    def initial_state(self, num_vertices: int, device: torch.device) -> torch.Tensor:
        rank = torch.full((num_vertices,), 1.0 / num_vertices, dtype=torch.float32,
                          device=device)
        deg = torch.as_tensor(self.out_degree, device=device)
        return torch.stack([rank, torch.clamp_min(deg, 1.0)], dim=1)

    def compute(self, superstep, state, msg, has_msg) -> Tuple[torch.Tensor, torch.Tensor]:
        rank, deg = state[:, 0], state[:, 1]
        base = (1.0 - self.damping) / self.num_vertices
        new_rank = base + self.damping * msg if superstep > 0 else rank
        halt = torch.full(rank.shape, superstep >= self.num_iterations, device=rank.device)
        return torch.stack([new_rank, deg], dim=1), halt

    def edge_message(self, superstep, src_state, weight) -> torch.Tensor:
        return src_state[:, 0] / src_state[:, 1]
