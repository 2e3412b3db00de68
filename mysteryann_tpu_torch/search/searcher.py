"""High-level query API over a built index.

Port of ``mysteryann_tpu/search/searcher.py``, the equivalent of the
reference's search drivers: load index + base, then ``SearchRoarGraph`` per
query (reference src/index_bipartite.cpp:2311-2420, driven by
tests/test_search_roargraph.cpp:203-209). A Searcher holds the base vectors
and the adjacency on one device and streams query batches through the
lockstep beam search.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Tuple

import numpy as np
import torch

from mysteryann_tpu_torch.ops.distances import prepare_vectors
from mysteryann_tpu_torch.search.beam import beam_search, run_query_batches
from mysteryann_tpu_torch.search.seeding import make_seed_sample, seed_scan

if TYPE_CHECKING:  # avoid circular import (graph.roargraph uses search.beam)
    from mysteryann_tpu_torch.graph.roargraph import RoarGraphIndex


class Searcher:
    def __init__(self, index: "RoarGraphIndex", base,
                 seed_sample: int = 0,
                 device: torch.device | str | None = None):
        """``base`` is a numpy array or a tensor; everything lives on
        ``device`` (default: ``base``'s device for a tensor, else the card;
        ``device="cpu"`` runs on the CPU).
        ``seed_sample=r`` keeps a strided 1-in-r bf16 base sample for
        per-query entry-point scans (`search(seeds=S)`)."""
        self.metric = index.metric
        self.base = prepare_vectors(base, self.metric, device)
        self.device = self.base.device
        self.neighbors = torch.from_numpy(np.ascontiguousarray(
            index.graph.neighbors, np.int32)).to(self.device)
        self.eps = torch.tensor([index.graph.ep], dtype=torch.int32,
                                device=self.device)
        self._samp = (make_seed_sample(self.base, seed_sample)
                      if seed_sample else None)

    def search(
        self, queries, k: int, L: int,
        query_batch: int = 1024, expand: int = 1,
        visited_mode: str = "bitmask", device_out: bool = False,
        seeds: int = 0,
    ) -> Tuple:
        """Returns (ids [Q,k], dists [Q,k], cmps [Q], hops [Q]) as numpy, or
        as tensors on the Searcher's device with ``device_out=True``."""
        if seeds and self._samp is None:
            raise ValueError("seeds > 0 needs Searcher(seed_sample=r)")
        if seeds > L:
            raise ValueError(f"seeds ({seeds}) must be <= L ({L})")
        q = prepare_vectors(queries, self.metric, self.device)
        nq = q.shape[0]
        qb = min(query_batch, nq)

        def run(qs):
            seed_ids = None
            if seeds:
                # seed_d stays None: beam_search rescores the seeds in f32,
                # so reported dists stay exact
                seed_ids, _ = seed_scan(
                    *self._samp, qs, n_seeds=seeds, metric=self.metric)
            r = beam_search(self.base, self.neighbors, self.eps, qs,
                            k=k, L=L, metric=self.metric, expand=expand,
                            visited_mode=visited_mode, seed_ids=seed_ids)
            return r.ids, r.dists, r.cmps, r.hops

        return run_query_batches(q, nq, qb, run, device_out)

    def benchmark(self, queries, k: int, L: int,
                  query_batch: int = 1024, warmup: int = 1,
                  expand: int = 1, visited_mode: str = "bitmask",
                  seeds: int = 0) -> dict:
        """Timed sweep entry — the reference driver's per-L_pq row
        (tests/test_search_roargraph.cpp:190,231-236). The queries are on
        the device before the clock starts; on a CUDA device the timed
        region is closed by ``torch.cuda.synchronize()`` on both sides, and
        results are copied to the host after it."""
        q = prepare_vectors(queries, self.metric, self.device)
        qb = min(query_batch, q.shape[0])
        on_cuda = q.device.type == "cuda"

        def sync():
            if on_cuda:
                torch.cuda.synchronize(q.device)

        for _ in range(warmup):
            self.search(q[:qb], k, L, query_batch=qb, expand=expand,
                        visited_mode=visited_mode, device_out=True,
                        seeds=seeds)
        sync()
        t0 = time.perf_counter()
        out = self.search(q, k, L, query_batch=qb, expand=expand,
                          visited_mode=visited_mode, device_out=True,
                          seeds=seeds)
        sync()
        dt = time.perf_counter() - t0
        ids, dists, cmps, hops = (o.cpu().numpy() for o in out)
        return {
            "L_pq": L, "k": k,
            "qps": q.shape[0] / dt,
            "avg_cmps": float(cmps.mean()),
            "avg_hops": float(hops.mean()),
            "mean_latency_ms": 1000.0 * dt / max(1, -(-q.shape[0] // qb)),
            "ids": ids.astype(np.int32), "dists": dists,
        }
