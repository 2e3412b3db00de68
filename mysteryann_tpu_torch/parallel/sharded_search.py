"""Multi-card search.

Port of ``mysteryann_tpu/parallel/sharded_search.py``. Two scaling modes:

- `query_parallel_search`: the index fits one card → every rank holds the
  whole base and graph and searches its slice of the queries (pure data
  parallelism — the analogue of the reference's ``omp parallel for`` over
  queries, tests/test_search_roargraph.cpp:203-209).

- `distributed_beam_search`: the index does NOT fit one card → base
  vectors and the padded adjacency are row-sharded over ``mp``, queries
  over ``dp``. Each lockstep expansion:

    1. the owner of each expanded node gathers its neighbour row (the row
       gather K1, ``ops.gather``) and the others contribute zeros; one
       ``psum`` over ``mp`` gives every peer the rows (int32 [B, e·M]);
    2. every peer gathers vectors (K1) only for the neighbour ids it owns,
       computes their distances with the single-device ``_batch_dist``,
       zeroes the rest, and a second ``psum`` combines them (f32 [B, F]) —
       vectors never leave their rank, only distances do;
    3. selection, dedup and the pool merge run replicated on every mp peer
       (`search.beam.lockstep`, the single-device loop).

  An owner-masked psum adds zeros to the owner's value, so rows and
  distances are the owner's bits and the traversal is the single-device
  one. The loop's stopping test reads only the pool, which is replicated
  over ``mp``, so every mp peer makes the same collectives in the same
  order; dp shards stop at different steps and share no collective inside
  the loop.
"""

from __future__ import annotations

import torch

from mysteryann_tpu_torch.ops.distances import Metric
from mysteryann_tpu_torch.ops.gather import gather_rows_any
from mysteryann_tpu_torch.parallel.mesh import Mesh, psum, shard_sizes
from mysteryann_tpu_torch.search.beam import (SearchResult, _batch_dist,
                                              beam_search, lockstep)


def query_parallel_search(
    mesh: Mesh, base, neighbors, eps, queries, k: int, L: int,
    metric: Metric = Metric.IP, **kw,
) -> SearchResult:
    """Data parallel only: ``base`` / ``neighbors`` / ``eps`` whole on every
    rank, ``queries`` this rank's shard over ``("dp", "mp")`` (see
    `parallel.shard_base`); returns this rank's results. Every rank of the
    mesh calls it."""
    rows = shard_sizes(mesh, queries.shape[0], ("dp", "mp"))
    if len(set(rows)) > 1:
        raise ValueError(f"dp*mp must divide B (got B={sum(rows)}, "
                         f"mesh={mesh.shape})")
    return beam_search(base, neighbors, eps, queries, k=k, L=L,
                       metric=metric, **kw)


def distributed_beam_search(
    mesh: Mesh,
    base: torch.Tensor,       # this rank's mp shard of the rows [N/mp, d]
    neighbors: torch.Tensor,  # its mp shard [N/mp, M] int32, global ids,
                              # sentinel >= N
    eps: torch.Tensor,        # [E] int32 entry points (the same everywhere)
    queries: torch.Tensor,    # this rank's dp shard [B/dp, d]
    k: int,
    L: int,
    metric: Metric = Metric.IP,
    max_hops: int = 0,
    visited_mode: str = "bitmask",
    collect_expanded: int = 0,
    expand: int = 1,
) -> SearchResult:
    """Beam search over a row-sharded index; returns this rank's dp shard
    of the results (`parallel.gather_dp` assembles them). Every rank of the
    mesh calls it.

    ``visited_mode``: "bitmask" keeps the exact per-query visited bitmask
    (``[B/dp, N/32]`` per rank — fine to ~10M); "merge" drops it and
    dedups re-encountered ids inside the pool merge — the option at
    100M-class N; "pool" tests membership against the candidate pool
    only (the mode the connectivity pass traverses with). See
    `search.beam.beam_search`.

    ``collect_expanded=H`` returns the expansion history (reference
    full_retset), as `beam_search` does — the sharded build's phase D
    needs it. ``expand``: nodes popped per lockstep step. Selection and
    merge are the single-device engine's, so the traversal equals
    `beam_search`'s at every expand."""
    metric = Metric.parse(metric)
    if visited_mode not in ("bitmask", "merge", "pool"):
        raise ValueError(f"unknown visited_mode {visited_mode!r}")
    shard_n = base.shape[0]
    dp, mp = mesh.shape["dp"], mesh.shape["mp"]
    n_rows = shard_sizes(mesh, shard_n, "mp")
    q_rows = shard_sizes(mesh, queries.shape[0], "dp")
    if len(set(n_rows)) > 1 or len(set(q_rows)) > 1:
        raise ValueError(f"mp ({mp}) must divide N ({sum(n_rows)}); dp "
                         f"({dp}) must divide B ({sum(q_rows)})")
    if neighbors.shape[0] != shard_n:
        raise ValueError(f"neighbour shard has {neighbors.shape[0]} rows, "
                         f"base shard {shard_n}")
    E = int(eps.shape[0])
    if L < E:
        # the single-device engine's guard, raised before any collective
        raise ValueError(f"L ({L}) must be >= number of entry points "
                         f"E ({E})")
    return _lockstep_sharded(mesh, base, neighbors, eps, queries, k=k, L=L,
                             metric=metric, max_hops=max_hops,
                             visited_mode=visited_mode,
                             collect_expanded=collect_expanded, expand=expand)


def _lockstep_sharded(mesh: Mesh, base: torch.Tensor,
                      neighbors: torch.Tensor, eps: torch.Tensor,
                      queries: torch.Tensor, *, k: int, L: int,
                      metric: Metric, max_hops: int, visited_mode: str,
                      collect_expanded: int, expand: int) -> SearchResult:
    """`distributed_beam_search` past its checks. The collectives run over
    ``mp`` only, so the dp shards may hold different numbers of queries
    (the sharded build's last batch of a round); the mp peers of a rank
    must hold the same ones."""
    shard_n, d = base.shape
    M = neighbors.shape[1]
    n = shard_n * mesh.shape["mp"]
    off = mesh.coord("mp") * shard_n

    def owned(ids):
        return (ids >= off) & (ids < off + shard_n)

    def local(ids):
        return torch.clamp(ids - off, 0, shard_n - 1).reshape(-1)

    def rows_of(ids):    # [Bl, c] global ids -> [Bl, c, M]
        rows = gather_rows_any(neighbors, local(ids)).reshape(
            ids.shape + (M,))
        rows = psum(torch.where(owned(ids)[..., None], rows,
                                torch.zeros_like(rows)), mesh, "mp")
        return torch.where((ids < n)[..., None], rows,
                           torch.full_like(rows, n))

    def dists_of(ids):   # [Bl, F] global ids -> f32 [Bl, F]
        vecs = gather_rows_any(base, local(ids)).reshape(ids.shape + (d,))
        dloc = _batch_dist(queries, vecs, metric)
        return psum(torch.where(owned(ids), dloc, torch.zeros_like(dloc)),
                    mesh, "mp")

    ep_ids = eps.to(device=queries.device, dtype=torch.int32)[None, :].expand(
        queries.shape[0], eps.shape[0])
    return lockstep(ep_ids, dists_of(ep_ids), rows_of, dists_of, k=k, L=L,
                    n_base=n, n_total=n, M=M, max_hops=max_hops,
                    expand=expand, visited_mode=visited_mode,
                    collect_expanded=collect_expanded)
