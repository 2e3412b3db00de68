"""Sharded exact kNN — the multi-card ground-truth / build-input scan.

Port of ``mysteryann_tpu/parallel/sharded_knn.py``: queries sharded over
``dp``, base sharded over ``mp``. Each rank scans its [Q_shard × B_shard]
block with ``ops.knn.exact_knn_device`` and keeps a local top-k; the
per-query candidates are all-gathered over ``mp`` and merged into the
global top-k. The merge breaks ties by the lowest global id, as the
single-device scan does, so sharded and single-device results agree
exactly wherever the dot products do.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mysteryann_tpu_torch.ops.distances import Metric
from mysteryann_tpu_torch.ops.knn import exact_knn_device
from mysteryann_tpu_torch.ops.sort import topk_smallest
from mysteryann_tpu_torch.parallel.mesh import Mesh, all_gather, shard_sizes


def sharded_exact_knn(
    mesh: Mesh,
    queries: torch.Tensor,   # this rank's dp shard [Q/dp, d]
    base: torch.Tensor,      # this rank's mp shard [N/mp, d]
    k: int,
    metric: Metric = Metric.IP,
    tile: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dists [Q/dp, k], ids [Q/dp, k] int32) of this rank's queries, with
    global base ids; `parallel.gather_dp` assembles the [Q, k] result.
    Every rank of the mesh calls it."""
    metric = Metric.parse(metric)
    q_rows = shard_sizes(mesh, queries.shape[0], "dp")
    n_rows = shard_sizes(mesh, base.shape[0], "mp")
    if len(set(q_rows)) > 1 or len(set(n_rows)) > 1:
        raise ValueError("dp must divide Q and mp must divide N "
                         f"(got Q={sum(q_rows)}, N={sum(n_rows)}, "
                         f"mesh={mesh.shape})")
    shard_n = base.shape[0]
    d_loc, i_loc = exact_knn_device(queries, base, k=min(k, shard_n),
                                    metric=metric, tile=min(tile, shard_n))
    i_loc = i_loc + mesh.coord("mp") * shard_n          # globalize ids
    # every shard's candidates, shard-major: among equal distances the
    # lower position is the lower global id
    d_all = all_gather(d_loc, mesh, "mp", dim=1)
    i_all = all_gather(i_loc, mesh, "mp", dim=1)
    vals, pos = topk_smallest(d_all, k)
    return vals, i_all.gather(1, pos)
