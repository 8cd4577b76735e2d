"""Connected components on the Pregel framework (min-label propagation).

Counterpart of ``harmony_tpu/apps/concomp.py``: every vertex starts labelled
with its own id, adopts the least label it hears and passes improvements on
(HashMin), along both directions of every edge. At halt two vertices share a
label iff they are weakly connected. Combiner: min.
"""
from __future__ import annotations

from typing import Tuple

import torch

from harmony_tpu_torch.pregel.computation import Computation

_NO_LABEL = 1e9


class ConnectedComponentsComputation(Computation):
    combiner = "min"
    state_dim = 1
    msg_identity = _NO_LABEL
    undirected = True  # HashMin floods both ways (weak components)

    def initial_state(self, num_vertices: int, device: torch.device) -> torch.Tensor:
        if num_vertices > 2 ** 24:
            # labels ride f32 message tables; past 2^24 consecutive ids round
            # together and distinct components would merge silently
            raise ValueError(
                f"{num_vertices} vertices exceed float32's exact-integer "
                "range (2^24); shard the graph or widen the message dtype"
            )
        return torch.arange(num_vertices, dtype=torch.float32, device=device)[:, None]

    def compute(self, superstep, state, msg, has_msg) -> Tuple[torch.Tensor, torch.Tensor]:
        label = state[:, 0]
        candidate = torch.where(has_msg, msg, _NO_LABEL)
        new_label = torch.minimum(label, candidate)
        # superstep 0: everyone announces its label once; afterwards only
        # vertices whose label improved keep talking
        if superstep == 0:
            active = torch.ones_like(has_msg)
        else:
            active = new_label < label
        return new_label[:, None], ~active

    def edge_message(self, superstep, src_state, weight) -> torch.Tensor:
        return src_state[:, 0]
