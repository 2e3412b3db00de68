"""Padded adjacency tensors — the on-device graph representation.

The reference stores the graph as ``std::vector<std::vector<uint32_t>>``
(reference include/index_bipartite.h:140-170) and traverses it by pointer
chasing. Here the graph is a dense ``int32 [N, M_pad]`` tensor with a
sentinel (``N``) marking padding slots, so thousands of queries gather
neighbor rows in lockstep. Host copy of ``mysteryann_tpu/graph/adjacency.py``;
the device copy is a torch tensor made from ``neighbors``.

Degree statistics mirror what the reference prints after a build
(reference src/index_bipartite.cpp:221-230, 1160-1179).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class PaddedGraph:
    """Fixed-width adjacency. ``neighbors[i, j] == n_nodes`` ⇒ padding."""

    neighbors: np.ndarray  # int32 [N, M_pad]
    ep: int                # entry point (medoid) node id

    @property
    def n_nodes(self) -> int:
        return self.neighbors.shape[0]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def degrees(self) -> np.ndarray:
        return (self.neighbors < self.n_nodes).sum(axis=1).astype(np.int32)

    def degree_stats(self) -> dict:
        d = self.degrees
        return {
            "max": int(d.max()),
            "min": int(d.min()),
            "avg": float(d.mean()),
            "zero": int((d == 0).sum()),
        }

    def validate(self) -> None:
        """Graph invariants: ids in range, no self-edges, no duplicate edges."""
        n, m = self.neighbors.shape
        nb = self.neighbors
        valid = nb < n
        if nb.min() < 0:
            raise ValueError("negative neighbor id")
        rows = np.arange(n)[:, None]
        if np.any((nb == rows) & valid):
            raise ValueError("self-edge present")
        # duplicates: sort each row of valid entries, look for equal adjacent
        s = np.sort(np.where(valid, nb, n + rows), axis=1)  # pads made unique
        if np.any((s[:, 1:] == s[:, :-1]) & (s[:, 1:] < n)):
            raise ValueError("duplicate edge present")
        if not (0 <= self.ep < n):
            raise ValueError(f"entry point {self.ep} out of range [0,{n})")


def from_lists(lists: Sequence[Sequence[int]], ep: int, m_pad: int | None = None) -> PaddedGraph:
    """Pack ragged adjacency lists into a PaddedGraph (host-side)."""
    n = len(lists)
    if m_pad is None:
        m_pad = max((len(l) for l in lists), default=1) or 1
    nb = np.full((n, m_pad), n, dtype=np.int32)
    for i, l in enumerate(lists):
        l = list(l)[:m_pad]
        nb[i, : len(l)] = l
    return PaddedGraph(neighbors=nb, ep=ep)


def to_lists(g: PaddedGraph) -> List[List[int]]:
    n = g.n_nodes
    return [[int(x) for x in row if x < n] for row in g.neighbors]
