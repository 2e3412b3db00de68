"""Coarse-scan entry-point seeding.

Port of ``mysteryann_tpu/search/seeding.py``. CPU graph indexes reach the
target neighbourhood through upper hierarchy levels (HNSW) or a fixed
medoid walk (the reference, RoarGraph src/index_bipartite.cpp:2322-2353).
Here the same job is one matmul over a strided sample of the base, kept in
bf16, returning per-query seeds that land the beam inside the target
neighbourhood. The sample holds ~1/r of each query's true top-k, so the
scan alone is no answer — the graph walk does the precision work.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mysteryann_tpu_torch.ops.distances import Metric
from mysteryann_tpu_torch.ops.knn import _tiled_topk


def make_seed_sample(base_dev: torch.Tensor, rate: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Strided 1-in-`rate` sample of the (metric-prepared) base, kept in
    bf16: (sample [S, d] bf16, row norms [S] f32, ids [S] int32)."""
    n = base_dev.shape[0]
    ids = torch.arange(0, n, rate, dtype=torch.int32, device=base_dev.device)
    samp = base_dev[::rate]
    return (samp.to(torch.bfloat16).contiguous(),
            torch.sum(samp * samp, dim=1), ids)


def seed_scan(samp, samp_sq, samp_ids, q, n_seeds: int, metric: Metric):
    """Top-`n_seeds` sample members per query: (ids [B, S], dists [B, S]).

    The scan reads bf16 values (the query is rounded to bf16 like the
    sample) and accumulates their products in float32, which is what the
    JAX package's bf16 matmul with a float32 result computes. Selection is
    exact (the JAX package's ``approx_min_k`` is exact on its CPU backend),
    ties going to the lower sample index. The sample is scanned in tiles
    with a running top-k (``ops.knn._tiled_topk``), so the [B, S] score
    block is never whole — a 1-in-2 sample of 1M rows would make it 16 GB
    at 8,192 queries; the result does not depend on the tile.
    """
    metric = Metric.parse(metric)
    qb = q.to(torch.bfloat16).float()
    q_sq = (torch.sum(q * q, dim=1, keepdim=True)
            if metric == Metric.L2 else None)

    def score_tile(t0, t1):
        ip = qb @ samp[t0:t1].float().t()
        if q_sq is None:
            return -ip
        # clamp: the bf16 ip can push ||q-s||² ulp-negative for a query
        # equal to a sampled point
        return torch.clamp(q_sq - 2.0 * ip + samp_sq[t0:t1], min=0.0)

    vals, idx = _tiled_topk(score_tile, q.shape[0], samp.shape[0], n_seeds,
                            samp.shape[0], q.device)
    # vals carry bf16 rounding of the inputs; the classic Searcher passes
    # seed_d=None so beam_search rescores the seeds in f32
    return samp_ids[idx.long()], vals
