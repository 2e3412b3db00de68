"""Batched occlusion pruning — the RoarGraph edge-selection rule.

Port of ``mysteryann_tpu/graph/prune.py``. All four reference prune
functions share one shape (reference src/index_bipartite.cpp:
PruneBiSearchBaseGetBase:1612-1694, PruneProjectionReverseCandidates:
1527-1610, PruneProjectionInternalReverseCandidates:1434-1525,
PruneProjectionBaseSearchCandidates:1846-1940):

1. dedup candidates, drop the source node, sort by (distance-to-source, id);
2. greedy scan: keep candidate ``p`` unless some already-kept ``t`` has
   ``d(p, t) < d(p, src)`` (the occlusion rule), until ``cap`` kept;
3. optional fill pass: append closest occluded candidates until ``cap``;
4. the connectivity-pass variant refuses to *seed* the kept set with a
   candidate already present in the node's projection list, and its
   pass 1 never revisits entries positioned before the chosen seed
   (src/index_bipartite.cpp:1857-1864);
5. ``two_pass=True`` reproduces the reference's second scan of the
   connectivity-pass variant (:1897-1931): entries skipped before the seed
   get a second chance against the pass-1 kept set.

The scan is sequential in the kept set but only ``cap`` steps long; it runs
as a host loop over a precomputed candidate-pairwise distance tile
``[B, C, C]`` (one batched matmul), so the whole batch prunes in lockstep.
Every row is independent of the others in its batch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mysteryann_tpu_torch.ops.distances import Metric
from mysteryann_tpu_torch.ops.gather import gather_rows_any
from mysteryann_tpu_torch.ops.sort import sort_multi

_INF = float("inf")


def _row_of(pd: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """pd[b, j[b], :] for pd [B, C, C], j [B]."""
    B, _, C = pd.shape
    return pd.gather(1, j.view(B, 1, 1).expand(B, 1, C))[:, 0]


def batched_occlusion_prune(
    src_vecs: torch.Tensor,     # f32 [B, d] — the node whose list is being built
    src_ids: torch.Tensor,      # i32 [B] — its id (excluded from candidates)
    cand_ids: torch.Tensor,     # i32 [B, C] — sentinel >= N marks empty slots
    cand_dists: torch.Tensor,   # f32 [B, C] — distance(candidate, src)
    base: torch.Tensor | None,  # f32 [N, d]; None with gather_fn + n_base
    cap: int,
    metric: Metric = Metric.IP,
    fill: bool = True,
    not_seedable: torch.Tensor | None = None,  # bool [B, C]
    two_pass: bool = False,
    cand_vecs: torch.Tensor | None = None,  # f32 [B, C, d], pre-gathered rows
    gather_fn=None,             # flat ids [K] -> vecs [K, d]; default: base
    n_base: int = 0,            # N when base is None (sharded callers)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (pruned_ids i32 [B, cap] sentinel-padded, counts i32 [B]).

    ``gather_fn`` decouples the scan from where the vectors live: the
    sharded build (``parallel.sharded_build``, base row-sharded over
    ``mp``) fetches them by an owner-masked psum and runs this same
    keep-scan, so sharded and single-device prunes agree by construction.

    ``cand_vecs`` ([B, C, d], aligned with ``cand_ids``) reuses the
    candidate rows a caller already fetched (``dists_to_src``
    ``return_vecs=True``) instead of gathering the same rows again;
    reordering them by the sort permutation gives the same vectors as a
    gather after the sort.
    """
    metric = Metric.parse(metric)
    n = base.shape[0] if base is not None else n_base
    if n <= 0:
        raise ValueError("batched_occlusion_prune needs base or n_base")
    B, C = cand_ids.shape
    dev = cand_ids.device

    valid = (cand_ids < n) & (cand_ids != src_ids[:, None]) & (cand_ids >= 0)
    d_sorted_key = torch.where(valid, cand_dists,
                               torch.full_like(cand_dists, _INF))
    seed_block = (torch.zeros((B, C), dtype=torch.bool, device=dev)
                  if not_seedable is None else not_seedable)

    # sort by (dist, id); invalid slots sink to the end. The iota rides
    # along as the permutation for reordering pre-gathered vectors.
    perm0 = torch.arange(C, dtype=torch.int32, device=dev).expand(B, C)
    d_s, id_s, seedblk_s, perm = sort_multi(
        (d_sorted_key, cand_ids, seed_block, perm0), num_keys=2)
    valid_s = torch.isfinite(d_s)
    # dedup: same id ⇒ same dist ⇒ adjacent after the sort
    dup = torch.zeros((B, C), dtype=torch.bool, device=dev)
    dup[:, 1:] = id_s[:, 1:] == id_s[:, :-1]
    valid_s = valid_s & ~dup

    # candidate-pairwise distances [B, C, C] — one batched matmul. Clip
    # BOTH ends: the valid mask admits negative ids as input, and the
    # gather's contract is indices in [0, N)
    if cand_vecs is not None:
        d = cand_vecs.shape[-1]
        vecs = cand_vecs.gather(1, perm.long()[:, :, None].expand(B, C, d))
    else:
        flat_ids = torch.clamp(id_s, 0, n - 1).reshape(-1)
        vecs = (gather_rows_any(base, flat_ids) if gather_fn is None
                else gather_fn(flat_ids)).reshape(B, C, -1)
    ip = torch.bmm(vecs, vecs.transpose(1, 2))
    if metric in (Metric.IP, Metric.COSINE):
        pd = -ip
    else:
        sq = torch.sum(vecs * vecs, dim=-1)
        pd = torch.clamp(sq[:, :, None] - 2.0 * ip + sq[:, None, :], min=0.0)
    del ip, vecs

    seedable_s = ~seedblk_s
    pos = torch.arange(C, device=dev).expand(B, C)

    # seed first (reference :1861-1864): the walk skips not-seedable
    # candidates while the kept set is empty — and a skip at one's turn
    # is PERMANENT, so not-seedable candidates positioned before the
    # seed stay excluded even after seeding
    avail0 = valid_s & seedable_s
    has0 = torch.any(avail0, dim=1)
    j0 = torch.argmax(avail0.to(torch.uint8), dim=1)               # [B]
    kept = (pos == j0[:, None]) & has0[:, None]
    # pass 1 never revisits entries before the seed (reference :1857-1866).
    # A row with NO seedable candidate keeps nothing in pass 1
    valid_all = valid_s
    pre_seed = torch.where(has0[:, None], pos < j0[:, None],
                           torch.ones_like(valid_s))
    valid_s = valid_s & ~(seedblk_s & pre_seed)
    occ = has0[:, None] & (_row_of(pd, j0) < d_s)
    cnt = has0.to(torch.int32)

    # Keep-driven scan: occlusion only grows, so "keep the first available
    # candidate, occlude its shadow" `cap` times visits exactly the keep
    # set of the sequential sorted-order walk.
    def keep_steps(valid_mask, steps, kept, occ, cnt):
        for _ in range(steps):
            avail = valid_mask & ~occ & ~kept
            has = torch.any(avail, dim=1)
            j = torch.argmax(avail.to(torch.uint8), dim=1)          # [B]
            do = has & (cnt < cap)
            kept = kept | ((pos == j[:, None]) & do[:, None])
            # future candidate c is occluded by kept j if pd[j, c] < d[c]
            occ = occ | (do[:, None] & (_row_of(pd, j) < d_s))
            cnt = cnt + do.to(torch.int32)
        return kept, occ, cnt

    kept, occ, cnt = keep_steps(valid_s, cap - 1, kept, occ, cnt)
    if two_pass:
        # reference second pass (:1897-1931): re-scan from the start —
        # pre-seed-skipped entries get a chance against the pass-1 kept
        # set; everything pass 1 occluded stays occluded
        kept, occ, cnt = keep_steps(valid_all, cap, kept, occ, cnt)

    # order: kept candidates (sorted) first, then (if fill) valid non-kept
    # — drawn from the FULL valid set (the reference's fill pass
    # :1685-1691 iterates every candidate)
    if fill:
        key = torch.where(kept, pos, torch.where(valid_all, pos + C, 2 * C))
    else:
        key = torch.where(kept, pos, 2 * C)
    order_key, out_ids = sort_multi((key.to(torch.int32), id_s), num_keys=1)
    out_ids = torch.where(order_key[:, :cap] < 2 * C, out_ids[:, :cap],
                          torch.full_like(out_ids[:, :cap], n))
    counts = torch.sum(out_ids < n, dim=1, dtype=torch.int32)
    return out_ids, counts


def dists_to_src(src_vecs: torch.Tensor, cand_ids: torch.Tensor,
                 base: torch.Tensor | None, metric: Metric = Metric.IP,
                 return_vecs: bool = False, gather_fn=None, n_base: int = 0):
    """distance(candidate[b, c], src[b]) for prune inputs; [B, C].

    ``return_vecs=True`` also returns the gathered candidate rows
    [B, C, d] so the caller can hand them to `batched_occlusion_prune`
    (``cand_vecs=``) instead of fetching the same rows again.
    ``gather_fn`` / ``n_base``: as in `batched_occlusion_prune`.
    """
    metric = Metric.parse(metric)
    n = base.shape[0] if base is not None else n_base
    flat = torch.clamp(cand_ids, 0, n - 1).reshape(-1)
    vecs = (gather_rows_any(base, flat) if gather_fn is None
            else gather_fn(flat)).reshape(
        cand_ids.shape + (src_vecs.shape[-1],))
    ip = torch.bmm(vecs, src_vecs[:, :, None])[:, :, 0]
    if metric in (Metric.IP, Metric.COSINE):
        d = -ip
    else:
        sq_c = torch.sum(vecs * vecs, dim=-1)
        sq_s = torch.sum(src_vecs * src_vecs, dim=-1, keepdim=True)
        d = torch.clamp(sq_c - 2.0 * ip + sq_s, min=0.0)
    d = torch.where((cand_ids >= 0) & (cand_ids < n), d,
                    torch.full_like(d, _INF))
    return (d, vecs) if return_vecs else d
