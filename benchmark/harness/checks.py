"""The comparison that decides ``correct``.

It judges what the timed path returned: every answer of every call of the
window (and of the traced calls after it), ids and float32 distances, at the
cell's own batch. The configuration's reference works the exact neighbours
out again from the same base and queries, after the program's state is
freed; the program's graph, tables and scores are never read.

Three numbers, each with its limit:

- ``bad_answers``: answered queries whose row is malformed (an id outside
  the base, an id twice, a distance that is not finite, or distances not
  ascending), plus the queries of calls that raised or returned another
  shape. An exact comparison: the limit is 0.
- ``dist_gap``: the largest gap between a returned distance and the float64
  distance of the returned id to its query. The configurations state exact
  float32 distances with TF32 off; the limit sits between what sound runs
  read and what the TF32 control reads (``PERF.md`` gives both).
- ``recall_at_<k>``: recall@k of every answered query against the
  reference's exact top-k, held to the floor the configuration states.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch


@dataclass
class Answer:
    """One call's answer as the host received it."""
    offset: int               # first pool row of the call
    size: int                 # queries the call sent
    ids: torch.Tensor         # int [B, k] on the host
    dists: torch.Tensor       # f32 [B, k] on the host


def _first_occurrence(ids: torch.Tensor) -> torch.Tensor:
    """Whether each entry of a row is the first of its value in the row."""
    eq = ids[:, :, None] == ids[:, None, :]
    earlier = torch.tril(torch.ones(ids.shape[1], ids.shape[1],
                                    dtype=torch.bool, device=ids.device), -1)
    return ~(eq & earlier).any(2)


def judge(answers: List[Answer], failed: int, pool: torch.Tensor,
          base: torch.Tensor, config: dict, reference,
          chunk: int = 65536) -> Tuple[dict, float | None, int]:
    """(numbers, recall, bad): ``numbers`` maps each compared name to its
    value, limit and verdict; ``recall`` is recall@k of every answered
    query; ``bad`` the queries that count as failed."""
    k = int(config["serve"]["k"])
    metric = config["world"]["metric"]
    limits = config["checks"]
    n_base = base.shape[0]
    dev = pool.device
    gt, _ = reference.exact_topk(pool, base, k, metric)
    bad, hits, answered, gap = int(failed), 0, 0, 0.0

    group: List[Answer] = []

    def flush():
        nonlocal bad, hits, answered, gap
        if not group:
            return
        rows = torch.cat([torch.arange(a.offset, a.offset + a.size)
                          for a in group]).to(dev)
        ids = torch.cat([a.ids for a in group]).to(dev).long()
        d = torch.cat([a.dists for a in group]).to(dev).float()
        group.clear()
        valid = (ids >= 0) & (ids < n_base)
        first = _first_occurrence(ids)
        finite = torch.isfinite(d)
        ascending = torch.ones_like(valid[:, 0])
        if d.shape[1] > 1:
            ascending = (d[:, 1:] >= d[:, :-1]).all(1)
        ok_row = valid.all(1) & first.all(1) & finite.all(1) & ascending
        bad += int((~ok_row).sum())
        answered += ids.shape[0]
        hit = (ids[:, :, None] == gt[rows][:, None, :]).any(2)
        hits += int((hit & valid & first).sum())
        ref = reference.distances_f64(pool[rows], base,
                                      torch.where(valid, ids, 0), metric)
        g = torch.where(valid & finite, (d.double() - ref).abs(),
                        torch.zeros_like(ref))
        gap = max(gap, float(g.max()) if g.numel() else 0.0)

    size = 0
    for a in answers:
        if (tuple(a.ids.shape) != (a.size, k)
                or tuple(a.dists.shape) != (a.size, k)):
            bad += a.size
            continue
        group.append(a)
        size += a.size
        if size >= chunk:
            flush()
            size = 0
    flush()

    recall = hits / (answered * k) if answered else None
    numbers = {
        "bad_answers": {"value": bad, "limit": 0, "rule": "<="},
        "dist_gap": {"value": gap, "limit": limits["dist_gap"],
                     "rule": "<="},
        f"recall_at_{k}": {"value": recall,
                           "limit": limits["recall_floor"], "rule": ">="},
    }
    for v in numbers.values():
        x = v["value"]
        v["ok"] = x is not None and bool(
            x <= v["limit"] if v["rule"] == "<=" else x >= v["limit"])
    return numbers, recall, bad


def compute_recall(found_ids: np.ndarray, gt_ids: np.ndarray, k: int
                   ) -> float:
    """Mean recall@k by set intersection (copied from the port's
    ``utils/metrics.compute_recall``, the reference's ComputeRecall,
    tests/test_search_roargraph.cpp:23-36): the tests' yardstick for
    ``judge``'s recall."""
    found = np.sort(found_ids[:, :k].astype(np.int64), axis=1)
    gt = np.sort(gt_ids[:, :k].astype(np.int64), axis=1)
    q = gt.shape[0]
    f_uniq = np.concatenate(
        [np.ones((q, 1), bool), found[:, 1:] != found[:, :-1]], axis=1)
    g_uniq = np.concatenate(
        [np.ones((q, 1), bool), gt[:, 1:] != gt[:, :-1]], axis=1)
    span = max(int(found.max(initial=0)), int(gt.max(initial=0))) + 2
    off = (np.arange(q, dtype=np.int64) * span)[:, None]
    g_flat = np.sort(np.where(g_uniq, gt + off, -1).ravel())
    f_flat = (found + off).ravel()
    pos = np.minimum(np.searchsorted(g_flat, f_flat), g_flat.size - 1)
    hit = (g_flat[pos] == f_flat) & f_uniq.ravel()
    return float(hit.sum() / (q * k))
