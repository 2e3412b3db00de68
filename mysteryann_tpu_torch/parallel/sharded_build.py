"""Multi-card RoarGraph build — every heavy phase sharded over the mesh.

Port of ``mysteryann_tpu/parallel/sharded_build.py``. The reference's build
is its biggest compute: two OpenMP loops over shared memory (reference
src/index_bipartite.cpp:1059-1097, phase A over the training queries, and
:1192-1220, phase D over the base nodes). This is the mesh-parallel
counterpart, shaped so that a corpus larger than one card's memory can be
built, not only served:

- the big tensors are row-sharded over ``mp``: the base vectors
  ``[N/mp, d]`` and the live supply graph ``[N/mp, 2M]``;
- the work (phase-A queries, phase-D node batches, every prune) is dealt
  over ``dp``;
- vectors never leave their owner's memory for good: the owner of each id
  gathers its row (K1, ``ops.gather``), the other ranks contribute
  ``-0.0`` and one ``psum`` over ``mp`` gives every peer the owner's bits
  (``x + -0.0 == x`` for every float), so each distance is computed from
  the same values as on one device;
- each phase-D round folds into the supply graph shard by shard: an mp
  shard is one row slab of the port's slab fold
  (``graph.roargraph._fold_rows``), and an overflowing row's reverse list
  is recomputed from the round's replicated chunk (``_rev_rows_for_ids``).

Batches: a rank prunes and searches exactly the batches that single-device
``build_roargraph`` makes with ``query_batch`` and ``search_batch`` divided
by ``dp``; they are dealt round-robin over the dp ranks and assembled by
one all-gather over dp per step of the build.

Exactness: `sharded_build_roargraph` returns the graph that
``graph.build_roargraph`` builds with ``connectivity_engine="classic"``
from the same inputs, at every ``connectivity_expand`` and pass count
(tests/test_torch_sharded_build.py). Phase D always searches with the
distributed classic beam: the fused byte-row engine is a single-card
accelerator whose int8 traversal visits other nodes, so its graph is a
different (equally valid) one. ``connectivity_engine="fused"`` is
refused and ``"auto"`` means classic here.

SPMD: every rank of the mesh calls these functions with the same host
arguments and gets the same result. The mp peers of a rank hold the same
work, so they make the same collectives in the same order; a dp rank with
no rows in a batch skips it together with its mp peers, and the loops'
bounds read only replicated values.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch
import torch.distributed as dist

from mysteryann_tpu_torch.graph.adjacency import PaddedGraph
from mysteryann_tpu_torch.graph.roargraph import (
    RoarGraphIndex, _aggregate_reverse, _append_novel, _batched_prune_rows,
    _cap_degree, _compact_truncate_device, _edge_dists, _ensure_reachability,
    _fold_rows, _membership, _merge_forward_reverse, _own_overwrite,
    _prune_batch, _refill_rows_device, _rev_rows_for_ids, _round_edges,
    _rounds_for_pass, _to_dev, compute_medoid)
from mysteryann_tpu_torch.ops.distances import Metric, prepare_vectors
from mysteryann_tpu_torch.ops.gather import gather_rows_any
from mysteryann_tpu_torch.parallel.mesh import (Mesh, all_gather, gather_dp,
                                                psum)
from mysteryann_tpu_torch.parallel.sharded_knn import sharded_exact_knn
from mysteryann_tpu_torch.parallel.sharded_search import _lockstep_sharded
from mysteryann_tpu_torch.utils.params import BuildConfig
from mysteryann_tpu_torch.utils.timers import Timer, device_sync
from mysteryann_tpu_torch.utils.trace import tracer

_I32 = torch.int32


# --------------------------------------------------------------------------
# sharded primitives
# --------------------------------------------------------------------------


def _owned(mesh: Mesh, ids: torch.Tensor, shard_n: int):
    """(ids this rank owns, their local rows clamped into the shard)."""
    off = mesh.coord("mp") * shard_n
    return ((ids >= off) & (ids < off + shard_n),
            torch.clamp(ids - off, 0, shard_n - 1))


def take_rows_sharded(mesh: Mesh, arr: torch.Tensor, ids) -> torch.Tensor:
    """Rows ``ids`` (global ids, numpy or tensor) of an mp-row-sharded 2-D
    array whose shard on this rank is ``arr`` [N/mp, w], on every rank: the
    owner's rows through K1, the others' ``-0.0`` (``0`` for integers),
    one psum over mp — the owner's bits, for any dtype."""
    ids = _to_dev(ids, arr.device).reshape(-1)
    owned, loc = _owned(mesh, ids, arr.shape[0])
    rows = gather_rows_any(arr, loc)
    fill = torch.full_like(rows, -0.0 if rows.dtype.is_floating_point else 0)
    return psum(torch.where(owned[:, None], rows, fill), mesh, "mp")


def scatter_rows_sharded(mesh: Mesh, arr: torch.Tensor, ids,
                         rows) -> torch.Tensor:
    """Overwrite rows ``ids`` (global) of an mp-row-sharded 2-D array with
    ``rows`` [K, w] (the same on every rank), in place in this rank's
    shard ``arr``; returns it. No collective: each rank writes what it
    owns."""
    ids = _to_dev(ids, arr.device).reshape(-1)
    owned, loc = _owned(mesh, ids, arr.shape[0])
    sel = torch.nonzero(owned)[:, 0]
    arr[loc[sel].long()] = _to_dev(rows, arr.device, arr.dtype)[sel]
    return arr


def _owner_gather(mesh: Mesh, base_sh: torch.Tensor):
    """flat global ids → their vectors from the mp-sharded base (psummed
    vectors, as the JAX package's ``_owner_gather``): the prune's
    ``gather_fn``."""
    return functools.partial(take_rows_sharded, mesh, base_sh)


def sharded_prune_rows(
    mesh: Mesh,
    base_sh: torch.Tensor,        # this rank's mp shard [N/mp, d]
    node_ids,                     # [K] global row ids
    cand,                         # [K, C] candidate ids (sentinel n)
    cap: int,
    metric: Metric,
    batch: int,
    fill: bool,
    not_seedable=None,            # [K, C] bool
    n: int | None = None,
) -> torch.Tensor:
    """Occlusion-prune rows with vectors from the sharded base: the exact
    keep-scan of ``_batched_prune_rows``, gathers owner-masked over mp.
    Returns [K, min(cap, C)] ids on every rank (the arguments are the same
    on every rank: numpy or tensors).

    ``batch`` counts rows over the dp ranks: the rows are cut into batches
    of ceil(batch / dp) — the batches ``_batched_prune_rows`` makes at
    batch / dp — dealt round-robin over dp. Every rank makes the same
    number of steps (a dp rank past the last row prunes nothing in the
    last one), then one all-gather over dp assembles the rows."""
    metric = Metric.parse(metric)
    dev = base_sh.device
    n = n if n is not None else base_sh.shape[0] * mesh.shape["mp"]
    dp, c = mesh.shape["dp"], mesh.coord("dp")
    node_ids, cand = _to_dev(node_ids, dev), _to_dev(cand, dev)
    ns = (None if not_seedable is None
          else _to_dev(not_seedable, dev, torch.bool))
    K, C = cand.shape
    w = min(cap, C)
    if K == 0:
        return torch.empty((0, w), dtype=_I32, device=dev)
    b = max(1, -(-batch // dp))
    steps = -(-K // (b * dp))
    out = torch.full((steps, b, w), n, dtype=_I32, device=dev)
    gather = _owner_gather(mesh, base_sh)
    for i in range(steps):
        s = (i * dp + c) * b
        e = min(s + b, K)
        if e > s:   # the same on every mp peer: they share this dp slot
            out[i, : e - s] = _batched_prune_rows(
                None, node_ids[s:e], cand[s:e], cap, metric, b, fill,
                None if ns is None else ns[s:e], gather_fn=gather, n_base=n)
    return all_gather(out, mesh, "dp", dim=1).reshape(-1, w)[:K]


def _fold_round_sharded(mesh: Mesh, supply_sh: torch.Tensor,
                        chunk_lists: torch.Tensor, r0: int, n: int):
    """``graph.roargraph._fold_round_device`` with the supply mp-row-sharded:
    each rank folds its shard as one row slab of the slab fold — the
    own-row overwrite, then the round's reverse edges (replicated,
    chunk-sized) that land in its rows. Returns (supply_sh, the round's
    edges, fit [N] of every row, gathered over mp)."""
    lo = mesh.coord("mp") * supply_sh.shape[0]
    _own_overwrite(supply_sh, chunk_lists, r0, lo=lo, n=n)
    edges = _round_edges(chunk_lists, r0, n)
    fit = _fold_rows(supply_sh, edges, lo, n)
    return supply_sh, edges, all_gather(fit.to(torch.uint8), mesh,
                                        "mp").bool()


# --------------------------------------------------------------------------
# the sharded build
# --------------------------------------------------------------------------


def sharded_build_roargraph(
    mesh: Mesh,
    base: np.ndarray,
    train_queries: np.ndarray,
    learn_base_knn: np.ndarray,
    cfg: BuildConfig = BuildConfig(),
    verbose: bool = False,
) -> RoarGraphIndex:
    """Mesh-parallel `graph.build_roargraph`; every rank returns the same
    `RoarGraphIndex` (host arrays). Every rank of the mesh calls it with the
    same arguments.

    mp must divide N. See the module docstring for the layout, the
    batches and the exactness contract. Phase seconds go to the tracer
    (``build.phaseA``, ``build.phaseBC``, ``build.phaseD``, E included).
    """
    metric = Metric.parse(cfg.metric)
    M = cfg.M_pjbp
    n = base.shape[0]
    mp = mesh.shape["mp"]
    if n % mp:
        raise ValueError(f"mp ({mp}) must divide N ({n})")
    if cfg.connectivity_engine == "fused":
        raise ValueError(
            "the sharded build searches phase D with the distributed "
            "classic engine; use connectivity_engine='classic' (or 'auto', "
            "which means classic here). The fused byte-row engine is a "
            "single-card accelerator — see the module docstring.")
    log = (functools.partial(print, file=sys.stderr, flush=True)
           if verbose and dist.get_rank() == 0 else (lambda *a, **k: None))
    dev = mesh.device
    dev_sync = device_sync(dev)
    tr = tracer()

    # the medoid from the whole prepared base is the single-device
    # arithmetic; the rank then keeps its own rows only
    with Timer("medoid", sync=dev_sync) as t_med:
        full = prepare_vectors(base, metric, dev)
        ep = compute_medoid(full)
        shard_n = n // mp
        lo = mesh.coord("mp") * shard_n
        base_sh = full[lo: lo + shard_n].clone()
        del full
    prune = functools.partial(sharded_prune_rows, mesh, base_sh, n=n)
    knn = np.asarray(learn_base_knn[:, : cfg.M_sq], np.int64)

    # ---- phase A: projection prune, queries dealt over dp ------------------
    with Timer("phaseA", sync=dev_sync) as t_a:
        tgt_all32 = knn[:, 0].astype(np.int32)
        cand = np.where(knn == tgt_all32[:, None], n, knn).astype(np.int32)
        pruned_all = prune(tgt_all32, cand, M, metric, cfg.query_batch,
                           fill=True).cpu().numpy()
        winners_tgt, first_idx = np.unique(knn[:, 0], return_index=True)
        forward = np.full((n, M), n, np.int32)
        forward[winners_tgt] = pruned_all[first_idx]
    log(f"sharded phase A: {winners_tgt.size}/{knn.shape[0]} targets "
        f"({t_a.elapsed:.2f}s)")

    # ---- phase B+C: reverse edges + merge prune ----------------------------
    with Timer("phaseBC", sync=dev_sync) as t_bc:
        pv = pruned_all < n
        e_src = np.repeat(knn[:, 0], M)[pv.ravel()]
        e_dst = pruned_all.ravel().astype(np.int64)[pv.ravel()]
        _, uniq = np.unique(e_dst * np.int64(n) + e_src, return_index=True)
        e_src, e_dst = e_src[uniq], e_dst[uniq]
        e_dist = _edge_dists(base_sh, e_src, e_dst, metric, take=functools
                             .partial(take_rows_sharded, mesh, base_sh))
        rev = _aggregate_reverse(e_src, e_dst, e_dist.cpu().numpy(), n,
                                 r_max=3 * M)
        projection = _merge_forward_reverse(
            None, _to_dev(forward, dev), _to_dev(rev, dev), cap=M,
            metric=metric, batch=cfg.query_batch, fill=True,
            prune_rows=prune)
        del forward, pruned_all, rev
    log(f"sharded phase B/C ({t_bc.elapsed:.2f}s)")

    # ---- phase D: connectivity, supply mp-sharded; E: reachability --------
    with Timer("phaseD", sync=dev_sync) as t_d:
        final = projection
        for p_i in range(max(1, cfg.connectivity_passes)):
            supply = _connectivity_pass_sharded(
                mesh, base_sh, final, ep, cfg, metric, log, pass_i=p_i)
            final = _append_novel(final, supply, cap_add=2 * M, n=n)
            if final.shape[1] > 2 * M:
                final = _cap_degree(final, None, 2 * M, metric,
                                    cfg.query_batch, n, prune_rows=prune)
        final = _ensure_reachability(
            final.cpu().numpy(), ep, None, metric, log,
            knn=functools.partial(_stranded_knn, mesh, base_sh, metric))
    log(f"sharded phase D+E ({t_d.elapsed:.2f}s)")
    tr.record("build.medoid", t_med.elapsed)
    tr.record("build.phaseA", t_a.elapsed, queries=int(knn.shape[0]))
    tr.record("build.phaseBC", t_bc.elapsed)
    tr.record("build.phaseD", t_d.elapsed, nodes=int(n))
    return RoarGraphIndex(graph=PaddedGraph(neighbors=final, ep=ep),
                          metric=metric, dim=base.shape[1])


def _connectivity_pass_sharded(mesh: Mesh, base_sh: torch.Tensor,
                               projection: torch.Tensor, ep: int, cfg,
                               metric: Metric, log, pass_i: int = 0
                               ) -> torch.Tensor:
    """Phase D with the supply mp-sharded and the node batches dealt over
    dp: ``graph.roargraph._connectivity_pass`` (classic engine) — the
    pass's round schedule, the search of each node from the entry point
    over the live supply graph, the prune of its history, the arrival-order
    fold with the overflow prune + refill, and the tail's re-prune of rows
    over M — with every device step on the shards. ``projection`` [N, M']
    is replicated; returns the pass's [N, M] on every rank."""
    dev = base_sh.device
    shard_n = base_sh.shape[0]
    dp, c = mesh.shape["dp"], mesh.coord("dp")
    n = shard_n * mesh.shape["mp"]
    M, L, W = cfg.M_pjbp, cfg.L_pjpq, 2 * cfg.M_pjbp
    # a rank's search batch: the single-device batch at search_batch / dp
    b = max(8, min(-(-cfg.search_batch // dp), n))
    # the prune batch by the single-device rule, the least over the ranks
    # (ranks sharing a card see different free memory)
    pb = int(psum(torch.tensor([_prune_batch(
        dataclasses.replace(cfg, search_batch=b), dev)], device=dev),
        mesh, ("dp", "mp"), op=dist.ReduceOp.MIN))
    prune = functools.partial(sharded_prune_rows, mesh, base_sh, n=n)
    gather = _owner_gather(mesh, base_sh)
    eps = torch.tensor([ep], dtype=_I32, device=dev)
    H = cfg.history_mult * L
    rounds = _rounds_for_pass(cfg, pass_i)
    chunk = -(-n // rounds)

    lo = mesh.coord("mp") * shard_n
    supply = torch.full((shard_n, W), n, dtype=_I32, device=dev)
    supply[:, : min(projection.shape[1], W)] = \
        projection[lo: lo + shard_n, :W]
    r0 = 0
    for round_i in range(rounds):
        r1 = min(r0 + chunk, n)
        steps = -(-(r1 - r0) // (b * dp))
        mine = torch.full((steps, b, M), n, dtype=_I32, device=dev)
        for i in range(steps):
            s = r0 + (i * dp + c) * b
            e = min(s + b, r1)
            if e <= s:   # the same on every mp peer
                continue
            ids = torch.arange(s, e, dtype=_I32, device=dev)
            pool = _lockstep_sharded(
                mesh, base_sh, supply, eps, gather(ids), k=1, L=L,
                metric=metric, max_hops=0, visited_mode="pool",
                collect_expanded=H, expand=cfg.connectivity_expand).hist_ids
            # the seed must not be a projection neighbour (:1861-1864)
            ns = _membership(pool, projection[s:e], n)
            mine[i, : e - s] = _batched_prune_rows(
                None, ids, pool, M, metric, pb, fill=False, not_seedable=ns,
                gather_fn=gather, n_base=n)
        chunk_lists = torch.full((chunk, M), n, dtype=_I32, device=dev)
        chunk_lists[: r1 - r0] = all_gather(mine, mesh, "dp", dim=1
                                            ).reshape(-1, M)[: r1 - r0]
        supply, edges, fit = _fold_round_sharded(mesh, supply, chunk_lists,
                                                 r0, n)
        over = torch.nonzero(~fit)[:, 0].to(_I32)
        if over.shape[0]:
            cand = torch.cat([take_rows_sharded(mesh, supply, over),
                              _rev_rows_for_ids(chunk_lists, r0, over, n, W,
                                                edges)], dim=1)
            pruned = prune(over, cand, M, metric, pb * dp, fill=False)
            scatter_rows_sharded(mesh, supply, over,
                                 _refill_rows_device(pruned, cand, n))
        log(f"\rsharded connectivity round {round_i + 1}/{rounds}", end="")
        r0 = r1
    log("")

    # overflow re-prune + compact-truncate to M (reference :1224-1248, no
    # fill; projection members can't seed), on the gathered supply
    supply = all_gather(supply, mesh, "mp")
    over = torch.nonzero(torch.sum(supply < n, dim=1) > M)[:, 0].to(_I32)
    final = _compact_truncate_device(supply, cap=M, n=n)
    if over.shape[0]:
        cand = gather_rows_any(supply, over)
        ns = _membership(cand, gather_rows_any(projection, over), n)
        final[over.long()] = prune(over, cand, M, metric, pb * dp,
                                   fill=False, not_seedable=ns)
    return final


def _stranded_knn(mesh: Mesh, base_sh: torch.Tensor, metric: Metric,
                  ids: np.ndarray) -> np.ndarray:
    """Phase E's 32 nearest base ids of base rows ``ids`` (the same on every
    rank) through the sharded exact kNN: rows dealt over dp (padded to a
    multiple of dp), scanned against every mp shard, gathered back."""
    dp, c = mesh.shape["dp"], mesh.coord("dp")
    B = ids.size
    per = -(-B // dp)
    pad = np.zeros(per * dp, np.int32)
    pad[:B] = ids
    q = take_rows_sharded(mesh, base_sh, pad[c * per: (c + 1) * per])
    _, cand = sharded_exact_knn(mesh, q, base_sh, k=32, metric=metric,
                                tile=131072)
    return gather_dp(mesh, cand).cpu().numpy()[:B]
