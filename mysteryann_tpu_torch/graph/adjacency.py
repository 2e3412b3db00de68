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


# -- the reference's ragged graph-file payload: per row [deg u32][ids u32…] --


def ragged_words(neighbors: np.ndarray, n: int) -> np.ndarray:
    """The ``[deg u32][ids u32…]`` word stream of every row of a padded
    adjacency, built in one array (entries outside [0, n) are padding)."""
    nb = np.ascontiguousarray(neighbors, np.int32)
    valid = (nb >= 0) & (nb < n)
    degs = valid.sum(axis=1).astype(np.int64)
    row_starts = np.zeros(nb.shape[0], np.int64)
    np.cumsum(1 + degs[:-1], out=row_starts[1:])
    out = np.empty(int(nb.shape[0] + degs.sum()), np.uint32)
    out[row_starts] = degs.astype(np.uint32)
    rank = np.cumsum(valid, axis=1) - 1
    out[(row_starts[:, None] + 1 + rank)[valid]] = nb[valid].astype(np.uint32)
    return out


def ragged_row_starts(payload: np.ndarray, n_rows: int | None = None):
    """Word offsets of the first ``n_rows`` rows of a ragged stream (every
    row when None), and the offset past the last one.

    Row starts follow the data-dependent recurrence s + 1 + deg — the only
    sequential part of a load. The walk reads the payload in chunks of
    Python ints (a whole-payload ``tolist()`` is ~28 B/word of transient
    memory)."""
    starts, off, lo, words = [], 0, 0, []
    size, chunk = payload.size, 1 << 22
    while off < size and (n_rows is None or len(starts) < n_rows):
        starts.append(off)
        if not lo <= off < lo + len(words):
            lo = off
            words = payload[lo: lo + chunk].tolist()
        off += 1 + words[off - lo]
    return np.asarray(starts, np.int64), off


def ragged_to_padded(payload: np.ndarray, starts: np.ndarray, sentinel: int,
                     m_pad: int | None = None) -> np.ndarray:
    """int32 [rows, m_pad] adjacency from a ragged stream's rows (width: the
    widest row, at least 1; wider rows are truncated to ``m_pad``), padded
    with ``sentinel``. Words past the payload's end read as padding."""
    degs = payload[starts].astype(np.int64)
    m_pad = m_pad or max(int(degs.max(initial=0)), 1)
    nb = np.full((starts.size, m_pad), sentinel, np.int32)
    cols = np.arange(m_pad, dtype=np.int64)
    pos = starts[:, None] + 1 + cols[None, :]
    mask = ((cols[None, :] < np.minimum(degs, m_pad)[:, None])
            & (pos < payload.size))
    nb[mask] = payload[pos[mask]].astype(np.int32)
    return nb
