"""Exact k-nearest-neighbor search — tiled matmul + running top-k merge.

Port of ``mysteryann_tpu/ops/knn.py``. The reference outsources this step
(its build loads a DiskANN-computed query→base kNN file, reference
src/index_bipartite.cpp:2622-2639); here it is owned: base tiles stream
through a float32 matmul against a resident query block, and each tile's
distances fold into a running top-k. It produces both the build's input
(train-query kNN) and the ground truth for recall.

Selection is exact everywhere. Ties are broken by the lower base index,
as ``lax.top_k`` does, by selecting on the composite (distance, index) key
(``ops.sort.topk_smallest``: the k-selection kernel K3 on the card). The TPU
package's ``approx=True`` path (``lax.approx_min_k``, the TPU's
partial-reduce) becomes the same exact selection, so ``approx`` and
``recall_target`` change nothing here.

On f32 and int8 operands the matmul is not fused into the selection, so
every tile's [B, tile] distance block is materialized, and on the CPU its
int64 selection key too: the tile is sized from the memory the device has
free and the bytes the selection holds there (``_tile_rows``). On bf16
operands the product and the selection are one kernel on the card (K3f,
``ops/score_select.py``).

The int8 scans (``int8_knn_device``, ``int8_global_knn_device``) take their
s8 · s8 → s32 products from a library matmul, as the JAX package leaves
them to XLA: ``torch._int_mm`` on a CUDA device, else an f32 matmul of the
int8 values, which is exact while every partial sum fits f32's 24-bit
significand (d ≤ 1024 for any int8 values; larger d raises there).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mysteryann_tpu_torch.ops.distances import Metric, pairwise_dist, prepare_vectors
from mysteryann_tpu_torch.ops.sort import (_REF_BYTES_PER_ELEM,
                                           selection_bytes, topk_smallest,
                                           topk_smallest_ref)

# bytes of temporaries per element of a [B, tile] block, besides what the
# selection holds (ops/sort.selection_bytes): the f32 distances and the
# score tile's own temporaries (a matmul result beside its negation, the
# int8 scans' s32 product)
_TILE_BYTES_PER_ELEM = 16
_CPU_BLOCK_BYTES = 256 << 20


def _tile_rows(n_queries: int, tile: int, device: torch.device,
               select=topk_smallest) -> int:
    """Largest base tile (≤ ``tile``) whose temporaries, the score tile's
    and those of the selection ``select``, fit a quarter of the device's
    free memory (a fixed 256 MB block on the CPU)."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = free // 4
    else:
        budget = _CPU_BLOCK_BYTES
    per_elem = _TILE_BYTES_PER_ELEM + (
        _REF_BYTES_PER_ELEM if select is topk_smallest_ref
        else selection_bytes(device))
    fit = budget // max(1, n_queries * per_elem)
    return int(max(256, min(tile, fit)))


def _merge_topk(best, t_d, t_i, k: int, select=topk_smallest):
    """Fold a tile's (dists, ids) into the running top-k — the tiny exact
    [B, k+kk] merge; ties keep the earlier entry, like ``lax.top_k``."""
    best_d, best_i = best
    cat_d = torch.cat([best_d, t_d], dim=1)
    cat_i = torch.cat([best_i, t_i], dim=1)
    vals, pos = select(cat_d, k)
    return vals, cat_i.gather(1, pos)


def _tiled_topk(score_tile, B: int, nb: int, k: int, tile: int,
                device: torch.device, select=topk_smallest
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running exact top-k of a scan: ``score_tile(t0, t1)`` gives the
    distances [B, t1 - t0] of base rows t0..t1, at most ``tile`` rows at a
    time (fewer when device memory is short; the result does not depend on
    the tile) → (dists [B, k], ids [B, k] int32), selected by ``select``
    (``topk_smallest_ref``: the plain version on any device)."""
    tile = _tile_rows(B, min(tile, nb), device, select)
    best = (
        torch.full((B, k), float("inf"), dtype=torch.float32, device=device),
        torch.full((B, k), -1, dtype=torch.int32, device=device),
    )
    for t0 in range(0, nb, tile):
        dists = score_tile(t0, min(t0 + tile, nb))
        t_d, t_pos = select(dists, min(k, dists.shape[1]))
        del dists
        best = _merge_topk(best, t_d, t_pos.to(torch.int32) + t0, k,
                           select)
    return best


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
    products accumulate in float32. Both operands bf16: the fused score
    product and selection (``ops/score_select.score_topk``: K3f on the card
    for k <= 256, no distance block written; the same tiles on the CPU).
    """
    metric = Metric.parse(metric)
    if (queries.dtype == torch.bfloat16 and base.dtype == torch.bfloat16
            and 0 < k <= base.shape[0]):
        from mysteryann_tpu_torch.ops.distances import squared_norms
        from mysteryann_tpu_torch.ops.score_select import score_topk
        q_sq = t_sq = None
        if metric == Metric.L2:
            q_sq = squared_norms(queries).float()
            t_sq = squared_norms(base).float()
        d, i = score_topk(queries, base, k, metric, q_sq, t_sq, tile=tile)
        return d, i.to(torch.int32)
    return _tiled_topk(
        lambda t0, t1: pairwise_dist(queries, base[t0:t1], metric=metric),
        queries.shape[0], base.shape[0], k, tile, base.device)


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
    (default: ``base``'s device for a tensor, else the card;
    ``device="cpu"`` runs on the CPU).

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


# 128² · d ≤ 2²⁴: every partial sum of int8 products is an exact f32 integer
_EXACT_F32_DIM = (1 << 24) // (128 * 128)
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _s8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` for int8 ``a`` [m, d] and ``b`` [n, d] → exact int32
    [m, n]. On a CUDA device ``torch._int_mm`` (its rules: m > 16, d and n
    multiples of 8 — m and n are zero-padded to them, d must be); elsewhere
    an f32 matmul of the int8 values (TF32 off), exact for d ≤ 1024."""
    m, d = a.shape
    n = b.shape[0]
    if a.is_cuda and d % 8 == 0:
        mp, npad = max(m, 17), (-n) % 8
        if mp > m:
            a = torch.cat([a, a.new_zeros((mp - m, d))])
        if npad:
            b = torch.cat([b, b.new_zeros((npad, d))])
        return torch._int_mm(a.contiguous(), b.contiguous().t())[:m, :n]
    if d > _EXACT_F32_DIM:
        raise ValueError(f"int8 scan of d={d} on {a.device}: an f32 matmul "
                         f"is exact only for d <= {_EXACT_F32_DIM}")
    return (a.float() @ b.float().t()).to(torch.int32)


def quantize_rows_int8(x: torch.Tensor, _folded: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: x ≈ q * scale[:, None].

    ``_folded`` forms the scale as ``amax · f32(1/127)``: inside a compiled
    function XLA folds the division by the constant 127 into that multiply,
    so the JAX package's ``int8_knn_device`` quantizes its queries so."""
    amax = torch.clamp(torch.amax(torch.abs(x), dim=1), min=1e-30)
    scale = amax * _INV_127 if _folded else amax / 127.0
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def quantize_global_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One symmetric int8 scale for the whole table: x ≈ q * scale.

    A uniform base-side scale makes raw s8 · s8 → s32 scores
    order-preserving per query for IP/cosine, so the selection can take the
    matmul output without a rescale. Small-norm rows lose more precision
    than with per-row scales; the f32 rerank absorbs it.
    """
    amax = torch.amax(torch.abs(x))
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def int8_global_knn_device(
    q_i8: torch.Tensor,        # int8 [B, d] (per-row query quantization is
    base_i8: torch.Tensor,     #              order-preserving; base is global)
    k: int,
    tile: int = 262144,
    recall_target: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(negated s32 scores as f32 [B, k], ids [B, k] int32) of a
    global-scale int8 scan.

    IP/cosine only: with one base-side scale, -s32 ranks as the true
    negated inner product does per query. Scores are raw negated s8 · s8
    sums; callers rerank the head in f32 (``FlatIndex``). Selection is
    exact (lowest id first among ties); ``recall_target`` changes nothing.
    """
    def score_tile(t0, t1):
        return -_s8_dot(q_i8, base_i8[t0:t1]).to(torch.float32)

    return _tiled_topk(score_tile, q_i8.shape[0], base_i8.shape[0], k, tile,
                      base_i8.device)


def int8_knn_device(
    queries: torch.Tensor,      # f32 [B, d] (metric-preprocessed)
    base_i8: torch.Tensor,      # int8 [N, d]
    base_scale: torch.Tensor,   # f32 [N]
    k: int,
    metric: Metric = Metric.IP,
    tile: int = 131072,
    base_norm: torch.Tensor | None = None,   # f32 [N] ||b||² (L2 only)
    recall_target: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN through an int8 scan with per-row scales: (dists [B, k], ids
    [B, k] int32). Scores carry per-row quantization error, so callers
    rerank the head in f32 (``FlatIndex(precision="int8")``). The rescale
    keeps the JAX package's order, ``(s32·q_scale)·base_scale`` then
    ``q_sq - 2·ip + ||b||²``, so its values match. Selection is exact;
    ``recall_target`` changes nothing.
    """
    metric = Metric.parse(metric)
    if metric == Metric.L2 and base_norm is None:
        # zero norms would silently rank by inner product instead of L2
        raise ValueError("int8_knn_device with metric=L2 requires "
                         "base_norm (||b||^2 per row)")
    q_i8, q_scale = quantize_rows_int8(queries, _folded=True)
    q_scale = q_scale[:, None]
    q_sq = (torch.sum(queries * queries, dim=1, keepdim=True)
            if metric == Metric.L2 else None)

    def score_tile(t0, t1):
        s32 = _s8_dot(q_i8, base_i8[t0:t1])
        ip = (s32.to(torch.float32) * q_scale) * base_scale[None, t0:t1]
        del s32
        if q_sq is None:
            return ip.neg_()
        return q_sq - 2.0 * ip + base_norm[None, t0:t1]

    return _tiled_topk(score_tile, queries.shape[0], base_i8.shape[0], k,
                      tile, base_i8.device)
