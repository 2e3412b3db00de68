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
from mysteryann_tpu_torch.ops.score_select import aligned_rows, score_topk


def make_seed_sample(base_dev: torch.Tensor, rate: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Strided 1-in-`rate` sample of the (metric-prepared) base, kept in
    bf16: (sample [S, d] bf16, row norms [S] f32, ids [S] int32). The
    sample's rows start 16 bytes apart (``aligned_rows``), so the fused
    scan reads it in place."""
    n = base_dev.shape[0]
    ids = torch.arange(0, n, rate, dtype=torch.int32, device=base_dev.device)
    samp = base_dev[::rate]
    return (aligned_rows(samp.to(torch.bfloat16).contiguous()),
            torch.sum(samp * samp, dim=1), ids)


def seed_scan(samp, samp_sq, samp_ids, q, n_seeds: int, metric: Metric):
    """Top-`n_seeds` sample members per query: (ids [B, S], dists [B, S]).

    The scan reads bf16 values (the query is rounded to bf16 like the
    sample) and accumulates their products in float32, which is what the
    JAX package's bf16 matmul with a float32 result computes; for l2 the
    query's norm is taken from the unrounded query, as there. Selection is
    exact (the JAX package's ``approx_min_k`` is exact on its CPU backend),
    ties going to the lower sample index. One fused call
    (``ops/score_select.score_topk``): on the card the kernel K3f, which
    writes no [B, S] score block; on the CPU the plain version, which scans
    the sample in tiles with a running top-k, so the block is never whole
    there either — a 1-in-2 sample of 1M rows would make it 16 GB at 8,192
    queries; the result does not depend on the tile.
    """
    metric = Metric.parse(metric)
    q_sq = torch.sum(q * q, dim=1) if metric == Metric.L2 else None
    vals, idx = score_topk(q.to(torch.bfloat16), samp, n_seeds, metric,
                           q_sq, samp_sq)
    # vals carry bf16 rounding of the inputs; the classic Searcher passes
    # seed_d=None so beam_search rescores the seeds in f32
    return samp_ids[idx], vals
