"""Graph container for Pregel jobs.

A copy of ``harmony_tpu/pregel/graph.py`` (numpy only): the graph is
edge-list arrays (src, dst, weight) plus per-vertex out-degrees, the layout
the superstep's gather and message fold need, with the same checks and error
texts. Vertex *state* lives in a DenseTable (``pregel/master.py``), which
also moves the edge arrays to the device, once, as int32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class Graph:
    def __init__(
        self,
        num_vertices: int,
        src: np.ndarray,
        dst: np.ndarray,
        weight: Optional[np.ndarray] = None,
    ) -> None:
        if src.shape != dst.shape:
            raise ValueError("src/dst must align")
        if len(src) and (
            (src >= num_vertices).any() or (dst >= num_vertices).any()
            or (src < 0).any() or (dst < 0).any()
        ):
            raise ValueError("edge endpoint out of range")
        self.num_vertices = num_vertices
        self.src = src.astype(np.int32)
        self.dst = dst.astype(np.int32)
        self.weight = (
            weight.astype(np.float32) if weight is not None else np.ones(len(src), np.float32)
        )
        self.out_degree = np.bincount(self.src, minlength=num_vertices).astype(np.float32)

    @property
    def num_edges(self) -> int:
        return len(self.src)

    def undirected(self) -> "Graph":
        """Symmetrized copy: every edge also exists reversed (same weight).
        Computations that flood both ways need it (connected components'
        HashMin: a directed edge alone carries labels forward only)."""
        return Graph(
            self.num_vertices,
            np.concatenate([self.src, self.dst]),
            np.concatenate([self.dst, self.src]),
            np.concatenate([self.weight, self.weight]),
        )

    @staticmethod
    def from_edge_list(num_vertices: int, edges) -> "Graph":
        """edges: iterable of (src, dst) or (src, dst, weight)."""
        arr = [tuple(e) for e in edges]
        src = np.array([e[0] for e in arr])
        dst = np.array([e[1] for e in arr])
        w = (
            np.array([e[2] for e in arr], np.float32)
            if arr and len(arr[0]) > 2
            else None
        )
        return Graph(num_vertices, src, dst, w)


def random_graph(
    num_vertices: int, avg_degree: int = 4, seed: int = 0, weighted: bool = False
) -> Graph:
    """Synthetic digraph: every vertex gets ``avg_degree`` out-edges to
    uniform targets (self-loops dropped), optionally with uniform [0.5, 1.5)
    weights (for shortest-path runs). The reference's draws, byte for byte."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(num_vertices), avg_degree)
    dst = rng.integers(0, num_vertices, size=src.shape)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = rng.uniform(0.5, 1.5, size=src.shape).astype(np.float32) if weighted else None
    return Graph(num_vertices, src, dst, w)


def load_edge_list(path: str, num_vertices: int = 0) -> Graph:
    """Parse a whitespace edge-list file (``src dst [weight]`` per line,
    ``#`` comments): the CLI's ``--graph-file``."""
    src, dst, w = [], [], []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) not in (2, 3):
                raise ValueError(f"{path}:{lineno}: expected 'src dst [weight]'")
            src.append(int(parts[0]))
            dst.append(int(parts[1]))
            if len(parts) > 2:
                w.append(float(parts[2]))
            elif w:
                raise ValueError(
                    f"{path}:{lineno}: unweighted edge in a weighted file "
                    "(every line must carry a weight, or none)"
                )
    if w and len(w) != len(src):
        raise ValueError(f"{path}: only {len(w)} of {len(src)} edges weighted")
    n = num_vertices or (max(max(src), max(dst)) + 1 if src else 0)
    return Graph(
        n, np.asarray(src), np.asarray(dst),
        np.asarray(w, np.float32) if w else None,
    )
