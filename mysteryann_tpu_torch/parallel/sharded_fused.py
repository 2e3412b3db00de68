"""mp-sharded fused-table serving — the 10M+ sublinear engine.

Port of ``mysteryann_tpu/parallel/sharded_fused.py``. The single-card fused
engine (``search/fused.py``) serves from one byte-row table of N·R bytes:
23.0 GB at 10M rows of width 32, d = 128, int4 (R = 2,304 B). Here the
table is row-sharded over the ``mp`` mesh axis — shard j holds rows
[j·sn, (j+1)·sn), sn = ceil(N / mp), and a sentinel row of its own — and
every mp peer runs the same loop (``search.fused.fused_lockstep``, the
single-card engine's) on the same queries:

1. every peer picks the step's expansions from its pool (replicated over
   ``mp``: no communication);
2. the owner of each pick gathers its local byte row (K1) and scores the
   row's inline int8 / int4 neighbours with ``_score_packed_rows``, the
   single-card scoring; the other peers gather their local sentinel row;
3. one ``psum`` over ``mp`` for the distances and one for the ids (as
   ``id + 1``: a column no rank owns sums to 0 and comes back as -1, then
   the invalid id). Each pick has one owner, and the others contribute
   ``-0.0`` (``x + -0.0 == x``) and 0, so the peers receive the owner's
   bits and the results are the single-card engine's;
4. the pool merge runs replicated; queries are sharded over ``dp`` and
   never communicate.

The exact f32 rerank of the pool head reads the base, sharded the same
way, by an owner-masked psum. The seed sample stays replicated (1-in-2 of
10M rows in bf16 is 1.28 GB a rank).

Every rank of the mesh builds the searcher and calls ``search`` with its
own dp shard of the queries (``parallel.shard_base(mesh, q, "dp")``); the
mp peers of a rank must hold the same queries. The loop's stop test reads
only the pool, so mp peers make the same collectives; dp shards may stop
at different steps and share no collective in the loop.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F_

from mysteryann_tpu_torch.ops.distances import Metric, prepare_vectors
from mysteryann_tpu_torch.ops.gather import gather_rows, gather_rows_any
from mysteryann_tpu_torch.parallel.mesh import Mesh, psum, shard_sizes
from mysteryann_tpu_torch.search.fused import (_exact_dists, _pack_chunk,
                                               _row_bytes, _score_packed_rows,
                                               fused_lockstep)
from mysteryann_tpu_torch.search.seeding import make_seed_sample, seed_scan

_I32 = torch.int32


def _pack_shard(base: torch.Tensor, nb: np.ndarray, lo: int, sn: int,
                n_global: int, M: int, d: int, bits: int,
                chunk: int = 16384) -> torch.Tensor:
    """Rows [lo, lo+sn) of the global adjacency ``nb`` [N, M] packed into one
    shard's byte-row table, uint8 [sn+1, R] on ``base``'s device, the local
    sentinel row last (the JAX package's ``_pack_shard_host``).

    ``base`` is the metric-prepared, column-padded f32 base [N, d]: a row's
    inline neighbours may live in any shard. Rows past the corpus (lo+i >=
    N) pack as sentinel rows — invalid ids, zero vectors — so the tail
    shard's padding rows are inert. The bytes of a row are
    ``pack_neighbor_table``'s for the same id. Each rank packs its own
    shard straight into its table: no rank ever holds the others'."""
    dev = base.device
    out = torch.empty((sn + 1, _row_bytes(M, d, bits)), dtype=torch.uint8,
                      device=dev)
    for s in range(0, sn, chunk):
        c = min(chunk, sn - s)
        rows = torch.full((c, M), n_global, dtype=_I32, device=dev)
        avail = max(0, min(lo + s + c, n_global) - (lo + s))
        if avail:
            rows[:avail] = torch.from_numpy(np.ascontiguousarray(
                nb[lo + s: lo + s + avail], np.int32)).to(dev)
        out[s: s + c] = _pack_chunk(base, rows, n_base=n_global, M=M, d=d,
                                    bits=bits)
    out[sn:] = _pack_chunk(base, torch.full((1, M), n_global, dtype=_I32,
                                            device=dev),
                           n_base=n_global, M=M, d=d, bits=bits)
    return out


class ShardedFusedSearcher:
    """Fused byte-row serving with the table row-sharded over ``mp``.

    The same results as the single-card ``FusedSearcher`` at the same
    parameters (merge mode) and batch: the shards hold the same packed
    rows, scoring and the loop are the single-card code, and the
    owner-masked psums add nothing to the owner's values."""

    def __init__(self, mesh: Mesh, index, base, max_degree: int = 0,
                 seed_sample: int = 0, bits: int = 8):
        """``base``: the whole base (numpy — a memmap is fine — or a
        tensor), the same on every rank. The rank prepares it on its device
        to pack its shard and draw the seed sample, then keeps its rows
        only."""
        self.mesh = mesh
        self.metric = index.metric
        dev = mesh.device
        full = prepare_vectors(base, self.metric, dev)
        align = 8 if bits == 8 else 16
        self._col_pad = (align - full.shape[1] % align) % align
        if self._col_pad:
            full = F_.pad(full, (0, self._col_pad))
        n, d = full.shape
        nb = np.asarray(index.graph.neighbors)
        if max_degree and max_degree < nb.shape[1]:
            nb = nb[:, :max_degree]
        M = -(-nb.shape[1] // 16) * 16
        if M > nb.shape[1]:
            nb = np.concatenate(
                [nb, np.full((n, M - nb.shape[1]), n, nb.dtype)], axis=1)
        sn = -(-n // mesh.shape["mp"])
        self.off = mesh.coord("mp") * sn
        self.table = _pack_shard(full, nb, self.off, sn, n, M, d, bits)
        # the rerank base, the same row split, zero rows padding the tail
        # shard: cut from the prepared base, so its bits are the
        # single-card searcher's
        self.base_sh = torch.zeros((sn, d), dtype=torch.float32, device=dev)
        avail = max(0, min(self.off + sn, n) - self.off)
        self.base_sh[:avail] = full[self.off: self.off + avail]
        self._samp = (make_seed_sample(full, seed_sample)
                      if seed_sample else None)
        del full
        self.eps = torch.tensor([index.graph.ep], dtype=_I32, device=dev)
        self.n, self.d, self.M, self.sn, self.bits = n, d, M, sn, bits

    def _owned(self, ids: torch.Tensor) -> torch.Tensor:
        return (ids >= self.off) & (ids < self.off + self.sn) & (ids < self.n)

    def search(self, queries, k: int, L: int, expand: int = 1,
               seeds: int = 0, max_hops: int = 0, rerank: int = 0,
               device_out: bool = False) -> Tuple:
        """This rank's dp shard of the queries [B/dp, d] → (ids [B/dp, k],
        dists, cmps, hops) as numpy, or as tensors on the rank's device
        with ``device_out=True`` (`parallel.gather_dp` assembles them).
        Every rank of the mesh calls it."""
        if seeds and self._samp is None:
            raise ValueError("seeds > 0 needs seed_sample=r at init")
        if seeds > L:
            raise ValueError(f"seeds ({seeds}) must be <= L ({L})")
        if k > L:
            raise ValueError(f"k ({k}) must be <= L ({L})")
        mesh, metric, n, M, d = self.mesh, self.metric, self.n, self.M, self.d
        q = prepare_vectors(queries, metric, mesh.device)
        if self._col_pad:
            q = F_.pad(q, (0, self._col_pad))
        B = q.shape[0]
        q_sq = (torch.sum(q * q, dim=1, keepdim=True)
                if metric == Metric.L2 else None)

        def step(cur):
            mine = self._owned(cur)
            rows = gather_rows(self.table, torch.where(
                mine, cur - self.off, self.sn).reshape(-1))
            nd, nbrs = _score_packed_rows(q, rows, metric, q_sq, B=B,
                                          F=expand * M, M=M, d=d,
                                          bits=self.bits, expand=expand)
            own_f = mine.repeat_interleave(M, dim=1)
            nd = psum(torch.where(own_f, nd, -0.0), mesh, "mp")
            nbrs = psum(torch.where(own_f, nbrs + 1, 0), mesh, "mp") - 1
            return nd, torch.where(nbrs >= 0, nbrs, n + 1)

        def exact(ids):
            mine = self._owned(ids)
            vecs = gather_rows_any(self.base_sh, torch.where(
                mine, ids - self.off, 0).reshape(-1)).reshape(ids.shape + (d,))
            return psum(torch.where(mine, _exact_dists(q, vecs, metric, q_sq),
                                    -0.0), mesh, "mp")

        seed_ids = seed_d = None
        if seeds:
            seed_ids, seed_d = seed_scan(*self._samp, q, n_seeds=seeds,
                                         metric=metric)
        out = fused_lockstep(
            q, self.eps, step, exact, k=k, L=L, metric=metric,
            max_hops=max_hops or 4 * L + 32, n_base=n, M=M,
            visited_mode="merge", expand=expand, seed_ids=seed_ids,
            seed_d=seed_d, bits=self.bits, rerank=rerank)
        if device_out:
            return out
        return tuple(o.cpu().numpy() for o in out)

    def benchmark(self, queries, k: int, L: int, warmup: int = 1,
                  **kw) -> dict:
        """Timed ``search`` of this rank's query shard; ``qps`` counts the
        queries of every dp shard over the slowest rank's window: the
        ranks meet in a collective before the clock starts and before it
        stops, and the window is closed by ``torch.cuda.synchronize()``
        on a card. ``ids`` / ``dists`` are this rank's."""
        mesh = self.mesh
        q = prepare_vectors(queries, self.metric, mesh.device)
        total = sum(shard_sizes(mesh, q.shape[0], "dp"))

        def sync():
            if q.device.type == "cuda":
                torch.cuda.synchronize(q.device)
            psum(torch.zeros(1, device=q.device), mesh, ("dp", "mp"))

        for _ in range(warmup):
            self.search(q, k, L, device_out=True, **kw)
        sync()
        t0 = time.perf_counter()
        out = self.search(q, k, L, device_out=True, **kw)
        sync()
        dt = time.perf_counter() - t0
        ids, dists, cmps, hops = (o.cpu().numpy() for o in out)
        return {"L_pq": L, "k": k, "qps": total / dt,
                "avg_cmps": float(cmps.mean()),
                "avg_hops": float(hops.mean()),
                "ids": ids.astype(np.int32), "dists": dists}
