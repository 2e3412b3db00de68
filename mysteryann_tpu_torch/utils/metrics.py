"""Evaluation metrics matching the reference search drivers (numpy; host
copy of ``mysteryann_tpu/utils/metrics.py``).

- recall@k: mean set-intersection with ground truth
  (ComputeRecall, reference tests/test_search_roargraph.cpp:23-36);
- rderr: mean relative distance error with IP/cosine un-negation
  (ComputeRderr, reference tests/test_search_roargraph.cpp:38-62).
"""

from __future__ import annotations

import numpy as np

from mysteryann_tpu_torch.ops.distances import Metric


def compute_recall(found_ids: np.ndarray, gt_ids: np.ndarray, k: int) -> float:
    # vectorized set-intersection: sort each row of both sides, then count
    # membership via searchsorted — O(Q·k·log k), no per-query Python loop
    # (a 32k-query bench row was spending seconds in intersect1d calls)
    found = np.sort(found_ids[:, :k].astype(np.int64), axis=1)
    gt = np.sort(gt_ids[:, :k].astype(np.int64), axis=1)
    q = gt.shape[0]
    # dedup within each row (matches intersect1d's set semantics): an id
    # equal to its left neighbor contributes no new hit
    f_uniq = np.concatenate(
        [np.ones((q, 1), bool), found[:, 1:] != found[:, :-1]], axis=1)
    g_uniq = np.concatenate(
        [np.ones((q, 1), bool), gt[:, 1:] != gt[:, :-1]], axis=1)
    # row-offset trick: shift each row into a disjoint value range so one
    # flat searchsorted handles all queries at once
    span = max(int(found.max(initial=0)), int(gt.max(initial=0))) + 2
    off = (np.arange(q, dtype=np.int64) * span)[:, None]
    g_flat = np.where(g_uniq, gt + off, -1).ravel()
    g_flat = np.sort(g_flat)
    f_flat = (found + off).ravel()
    pos = np.searchsorted(g_flat, f_flat)
    pos = np.minimum(pos, g_flat.size - 1)
    hit = (g_flat[pos] == f_flat) & f_uniq.ravel()
    return float(hit.sum() / (q * k))


def compute_rderr(found_dists: np.ndarray, gt_dists: np.ndarray, k: int,
                  metric: Metric | str = Metric.IP) -> float:
    """Mean relative distance error over the top-k.

    IP/cosine distances are negated inner products; un-negate before the
    ratio like the reference does, guarding zero denominators.
    """
    metric = Metric.parse(metric)
    f = found_dists[:, :k].astype(np.float64)
    g = gt_dists[:, :k].astype(np.float64)
    if metric in (Metric.IP, Metric.COSINE):
        f, g = -f, -g
    denom = np.where(np.abs(g) < 1e-12, 1e-12, g)
    err = (g - f) / denom  # found is never better than GT; err >= 0 up to fp
    return float(np.mean(np.abs(err)))
