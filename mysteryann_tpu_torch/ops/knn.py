"""Exact k-nearest-neighbor search — tiled matmul + running top-k merge.

Port of ``mysteryann_tpu/ops/knn.py``. The reference outsources this step
(its build loads a DiskANN-computed query→base kNN file, reference
src/index_bipartite.cpp:2622-2639); here it is owned: base tiles stream
through a float32 matmul against a resident query block, and each tile's
distances fold into a running top-k. It produces both the build's input
(train-query kNN) and the ground truth for recall.

Selection is exact everywhere. Ties are broken by the lower base index,
as ``lax.top_k`` does, by selecting on the composite (distance, index) key
(``ops.sort.topk_smallest``). The TPU package's ``approx=True`` path
(``lax.approx_min_k``) becomes the same exact selection, so ``approx`` and
``recall_target`` change nothing here.

PyTorch does not fuse the matmul into the selection, so every tile's
[B, tile] distance block and its int64 selection key are materialized: the
tile is sized from the memory the device has free (``_tile_rows``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mysteryann_tpu_torch.ops.distances import Metric, pairwise_dist, prepare_vectors
from mysteryann_tpu_torch.ops.sort import topk_smallest

# bytes of temporaries per element of a [B, tile] block: the f32 distances,
# their int32 order image and the int64 selection key, plus topk's scratch
_BYTES_PER_ELEM = 48
_CPU_BLOCK_BYTES = 256 << 20


def _tile_rows(n_queries: int, tile: int, device: torch.device) -> int:
    """Largest base tile (≤ ``tile``) whose temporaries fit a quarter of the
    device's free memory (a fixed 256 MB block on the CPU)."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = free // 4
    else:
        budget = _CPU_BLOCK_BYTES
    fit = budget // max(1, n_queries * _BYTES_PER_ELEM)
    return int(max(256, min(tile, fit)))


def _merge_topk(best, t_d, t_i, k: int):
    """Fold a tile's (dists, ids) into the running top-k — the tiny exact
    [B, k+kk] merge; ties keep the earlier entry, like ``lax.top_k``."""
    best_d, best_i = best
    cat_d = torch.cat([best_d, t_d], dim=1)
    cat_i = torch.cat([best_i, t_i], dim=1)
    vals, pos = topk_smallest(cat_d, k)
    return vals, cat_i.gather(1, pos)


def exact_knn_device(
    queries: torch.Tensor,
    base: torch.Tensor,
    k: int,
    metric: Metric = Metric.IP,
    tile: int = 131072,
    approx: bool = False,
    precision: str = "default",
    recall_target: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN of `queries` [B, d] in `base` [N, d] → (dists [B,k], ids [B,k] i32).

    Scans base in tiles of at most `tile` rows (fewer when device memory is
    short; the result does not depend on the tile). ``approx``,
    ``precision`` and ``recall_target`` are accepted for call-site parity
    with the JAX package and change nothing: selection is exact and
    matmuls are float32.
    """
    metric = Metric.parse(metric)
    nb = base.shape[0]
    B = queries.shape[0]
    tile = _tile_rows(B, min(tile, nb), base.device)
    best = (
        torch.full((B, k), float("inf"), dtype=torch.float32,
                   device=base.device),
        torch.full((B, k), -1, dtype=torch.int32, device=base.device),
    )
    for t0 in range(0, nb, tile):
        dists = pairwise_dist(queries, base[t0: t0 + tile], metric=metric)
        t_d, t_pos = topk_smallest(dists, min(k, dists.shape[1]))
        del dists
        best = _merge_topk(best, t_d, t_pos.to(torch.int32) + t0, k)
    return best


def exact_knn(
    queries: np.ndarray,
    base: np.ndarray,
    k: int,
    metric: Metric | str = Metric.IP,
    query_batch: int = 4096,
    base_tile: int = 65536,
    approx: bool = False,
    precision: str = "default",
    device: torch.device | str | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-level exact kNN: streams query batches through ``device``
    (default: ``base``'s device for a tensor, else the CPU).

    Returns (dists [Q,k] f32, ids [Q,k] i32) as numpy. Handles metric
    preprocessing (cosine normalization) on the device.
    """
    metric = Metric.parse(metric)
    base_d = prepare_vectors(base, metric, device)
    nq = queries.shape[0]
    base_tile = min(base_tile, int(base.shape[0]))
    out_d = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int32)
    for s in range(0, nq, query_batch):
        e = min(s + query_batch, nq)
        qb = prepare_vectors(queries[s:e], metric, base_d.device)
        d_, i_ = exact_knn_device(qb, base_d, k, metric=metric,
                                  tile=base_tile, approx=approx,
                                  precision=precision)
        out_d[s:e] = d_.cpu().numpy()
        out_i[s:e] = i_.cpu().numpy()
    return out_d, out_i


def compute_ground_truth(
    queries: np.ndarray,
    base: np.ndarray,
    k: int,
    metric: Metric | str = Metric.IP,
    **kw,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact GT in the reference's GT convention (ids u32 + dists f32),
    computed in full float32."""
    d, i = exact_knn(queries, base, k, metric=metric, precision="highest", **kw)
    return i.astype(np.uint32), d
