"""Batched lockstep beam search over a padded graph.

Port of ``mysteryann_tpu/search/beam.py``, the recast of the reference's
one-query-at-a-time best-first loop (``SearchRoarGraph``, reference
src/index_bipartite.cpp:2311-2420):

- the sorted fixed-capacity ``NeighborPriorityQueue`` (reference
  neighbor.h:150-192) becomes a sorted candidate pool ``[B, L]``, merged
  each step with a (distance, id) sort;
- the epoch-tagged ``VisitedListPool`` (reference
  include/visited_list_pool.h) becomes a per-query bitmask
  ``int32 [B, ceil(N/32)]``, updated with a duplicate-safe scatter-OR
  (int32 words: a sum of distinct bits equals their OR, bit 31 included);
- ``closest_unexpanded()`` becomes an argmax over the unexpanded mask of
  the sorted pool (first True = smallest distance);
- one step expands `expand` nodes for *every* query in the batch —
  neighbour-row gather, visited check, vector gather, batched distance,
  sorted merge. Both gathers go through the row-gather kernel
  (``ops.gather``);
- per-query (cmps, hops) counters match the reference's reporting
  (src/index_bipartite.cpp:2354-2419).

The JAX package runs the steps in a ``lax.while_loop``. Here it is a host
loop of tensor ops that stops once no query is live; liveness is read back
from the device only every ``CHECK_EVERY`` steps (a read is a device→host
sync). The extra steps after every query has finished change nothing, and
the loop never runs past ``max_hops``, so results equal the JAX package's
where the cap binds too. Each query's result is independent of the other
queries in its batch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from mysteryann_tpu_torch.ops.distances import Metric
from mysteryann_tpu_torch.ops.gather import gather_rows_any
from mysteryann_tpu_torch.ops.sort import sort_multi

_INF = float("inf")
# steps between liveness reads (each read is a device→host sync)
CHECK_EVERY = 8


class SearchResult(NamedTuple):
    ids: torch.Tensor     # int32 [B, k]
    dists: torch.Tensor   # f32   [B, k]
    cmps: torch.Tensor    # int32 [B] — distance computations (reference "cmps")
    hops: torch.Tensor    # int32 [B] — node expansions (reference "hops")
    # expansion history (reference full_retset) when collect_expanded > 0:
    hist_ids: torch.Tensor | None = None   # int32 [B, H], sentinel-padded
    hist_d: torch.Tensor | None = None     # f32 [B, H]


def _batch_dist(q: torch.Tensor, vecs: torch.Tensor,
                metric: Metric) -> torch.Tensor:
    """Distances query[b] → vecs[b, m]: [B, d] x [B, M, d] -> [B, M].

    L2 norms are recomputed from the gathered vectors."""
    ip = torch.bmm(vecs, q[:, :, None])[:, :, 0]
    if metric in (Metric.IP, Metric.COSINE):
        return -ip
    qn = torch.sum(q * q, dim=-1, keepdim=True)
    vn = torch.sum(vecs * vecs, dim=-1)
    return torch.clamp(qn - 2.0 * ip + vn, min=0.0)


def _scatter_or_bits(visited: torch.Tensor, words: torch.Tensor,
                     bits: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """OR `bits` into `visited[b, words[b, m]]` in place, duplicate-word safe.

    Distinct neighbours falling in the same visited word carry distinct bit
    positions, so within one row the combined contribution for a word is
    the *sum* of its members' bits == their OR (int32 wrap-around keeps
    that true for bit 31). After combining, duplicate scatter indices
    write identical values, so the scatter is well-defined. Inactive
    entries are pointed at word 0, where they write what the active
    entries of word 0 write (or word 0 unchanged). O(M^2) combine — M is
    the fan-out.
    """
    bits = torch.where(active, bits, torch.zeros_like(bits))
    words = torch.where(active, words, torch.zeros_like(words)).long()
    same_word = words[:, :, None] == words[:, None, :]               # [B, M, M]
    combined = torch.sum(
        torch.where(same_word, bits[:, None, :], torch.zeros_like(bits[:, None, :])),
        dim=2, dtype=torch.int32)                                    # [B, M]
    new_vals = visited.gather(1, words) | combined
    return visited.scatter_(1, words, new_vals)


def _bit_of(ids: torch.Tensor) -> torch.Tensor:
    """int32 word holding bit ``ids & 31`` (bit 31 is the sign bit)."""
    return torch.bitwise_left_shift(torch.ones_like(ids), ids & 31)


def _first_occurrence(x: torch.Tensor) -> torch.Tensor:
    """bool [B, F]: x[b, j] is the first entry of its value in row b."""
    sv, si = torch.sort(x, dim=1, stable=True)
    dup = torch.zeros_like(x, dtype=torch.bool)
    dup[:, 1:] = sv[:, 1:] == sv[:, :-1]
    return torch.zeros_like(dup).scatter_(1, si, ~dup)


def _hop2(neighbors: torch.Tensor, hop1: torch.Tensor,
          n_total: int) -> torch.Tensor:
    """The neighbours of the hop-1 ids ``hop1`` [B, c] (sentinel ``n_total``
    rows stay all-sentinel), flattened to a [B, c·M] fan-out."""
    B, c = hop1.shape
    rows = gather_rows_any(neighbors,
                           torch.clamp(hop1, max=n_total - 1).reshape(-1))
    rows = rows.reshape(B, c, neighbors.shape[1])
    rows = torch.where((hop1 < n_total)[:, :, None], rows,
                       torch.full_like(rows, n_total))
    return rows.reshape(B, -1)


def beam_search(
    base: torch.Tensor,            # f32 [N, d] (metric-preprocessed)
    neighbors: torch.Tensor,       # int32 [N(+Nq), M_pad], sentinel >= n_total
    eps: torch.Tensor,             # int32 [E] entry point ids (shared by batch)
    queries: torch.Tensor,         # f32 [B, d]
    k: int,
    L: int,
    metric: Metric = Metric.IP,
    max_hops: int = 0,
    expand: int = 1,
    two_hop: bool = False,
    visited_mode: str = "bitmask",
    collect_expanded: int = 0,
    seed_ids: torch.Tensor | None = None,   # int32 [B, S] per-query entries
    seed_d: torch.Tensor | None = None,     # f32 [B, S] their distances
    two_hop_chunk: int = 0,  # >0: hop-2 groups processed per inner step
) -> SearchResult:
    """Best-first beam search of `queries` over the padded graph.

    `two_hop=True` reproduces the bipartite search pattern (reference
    src/index_bipartite.cpp:282-356): pool entries are base nodes, and an
    expansion visits neighbours-of-neighbours (base→query→base). In that
    mode `neighbors` covers base + query nodes ``[N + Nq, M]`` (global id
    space, sentinel ``N + Nq``), vectors are gathered for base ids only, the
    bitmask spans the base ids, and ``expand`` is forced to 1. Hop 2 runs
    either as one ``[B, M·M]`` fan-out or, with ``0 < two_hop_chunk < M``,
    in chunks of ``two_hop_chunk`` hop-1 rows merged one after the other;
    the incremental merges keep the top L exactly, so both give the same
    results.

    `visited_mode` selects the dedup structure:

    - ``"bitmask"``: per-query bitmask over all N base points — the exact
      analogue of the reference's VisitedListPool; an id is scored at most
      once (reference-parity ``cmps``). Costs [B, N/32] int32 of state and
      a scatter per step.
    - ``"pool"``: membership test against the candidate pool only. Sound
      because re-insertion of a dropped candidate is impossible — the
      pool's worst kept distance never increases. Ids reached again may be
      re-*scored* (higher ``cmps``) but are rejected at the merge, so
      traversal order and results are unchanged.
    - ``"merge"``: no dedup structure at all. Re-encountered ids are
      re-scored and deduplicated INSIDE the merge: sort by (id,
      expanded-first, dist), keep the first copy of each id run, resort by
      distance. Results can differ from "bitmask" by ulp-level ties only.
    """
    metric = Metric.parse(metric)
    if k > L:
        raise ValueError(f"k ({k}) must be <= L ({L})")
    if visited_mode not in ("bitmask", "pool", "merge"):
        raise ValueError(f"unknown visited_mode {visited_mode!r}")
    use_bitmask = visited_mode == "bitmask"
    use_merge = visited_mode == "merge"
    dev = base.device
    i32 = torch.int32
    n_base, d = base.shape
    n_total, M = neighbors.shape
    B = queries.shape[0]
    if max_hops <= 0:
        max_hops = 4 * L + 32
    n_words = -(-n_base // 32) if use_bitmask else 1

    def gather_vecs(ids):  # ids int32 [...], clamped row gather
        flat = torch.clamp(ids, max=n_base - 1).reshape(-1)
        return gather_rows_any(base, flat).reshape(ids.shape + (d,))

    # ---- seed pool with entry points -------------------------------------
    if seed_ids is not None:
        ep_ids = seed_ids.to(i32)
        ep_d = (seed_d if seed_d is not None
                else _batch_dist(queries, gather_vecs(ep_ids), metric))
    else:
        ep_ids = eps.to(i32)[None, :].expand(B, eps.shape[0])
        ep_d = _batch_dist(queries, gather_vecs(ep_ids), metric)
    E = ep_ids.shape[1]
    pad = L - E
    if pad < 0:
        raise ValueError(f"L={L} must be >= number of entry points E={E}")
    cand_ids = torch.cat(
        [ep_ids, torch.full((B, pad), n_total, dtype=i32, device=dev)], dim=1)
    cand_d = torch.cat(
        [ep_d, torch.full((B, pad), _INF, device=dev)], dim=1)
    cand_exp = torch.cat(
        [torch.zeros((B, E), dtype=torch.bool, device=dev),
         torch.ones((B, pad), dtype=torch.bool, device=dev)], dim=1)
    cand_d, cand_ids, cand_exp = sort_multi((cand_d, cand_ids, cand_exp), 2)

    visited = torch.zeros((B, n_words), dtype=i32, device=dev)
    if use_bitmask:
        _scatter_or_bits(visited, ep_ids >> 5, _bit_of(ep_ids),
                         ep_ids < n_base)

    cmps = torch.full((B,), E, dtype=i32, device=dev)
    hops = torch.zeros((B,), dtype=i32, device=dev)

    # expansion history (reference full_retset, src/index_bipartite.cpp:1318):
    # every (id, dist) popped as closest_unexpanded, in pop order. Column H
    # of the buffers takes the writes the JAX package drops.
    H = max(collect_expanded, 1)
    hist_ids = torch.full((B, H + 1), n_total, dtype=i32, device=dev)
    hist_d = torch.full((B, H + 1), _INF, device=dev)

    e = 1 if two_hop else expand
    L_iota = torch.arange(L, dtype=i32, device=dev).expand(B, L)
    e_iota = torch.arange(e, dtype=i32, device=dev)[None, :]

    def process(cand_ids, cand_d, cand_exp, nbrs):
        """Score a fan-out [B, F] of global ids (sentinel >= n_total) and
        merge it into the pool; updates `visited` and `cmps` in place."""
        in_base = nbrs < n_base   # only base nodes are scored/inserted
        nb_c = torch.where(in_base, nbrs, torch.zeros_like(nbrs))
        if use_merge:
            fresh = in_base      # dedup happens inside the merge sort
        else:
            if use_bitmask:
                words = nb_c >> 5
                bits = _bit_of(nb_c)
                seen = (visited.gather(1, words.long()) & bits) != 0
            else:
                # pool membership (see visited_mode docstring)
                seen = torch.any(nbrs[:, :, None] == cand_ids[:, None, :],
                                 dim=2)
            # intra-slice duplicates reduce to one representative: they
            # would corrupt the sum-as-OR trick and insert twice
            fresh = in_base & ~seen & _first_occurrence(nbrs)        # [B, F]
            if use_bitmask:
                _scatter_or_bits(visited, words, bits, fresh)

        # -- distances for fresh neighbours --------------------------------
        nd = _batch_dist(queries, gather_vecs(nb_c), metric)
        nd = torch.where(fresh, nd, torch.full_like(nd, _INF))
        new_ids = torch.where(fresh, nbrs, torch.full_like(nbrs, n_total))
        cmps.add_(torch.sum(fresh, dim=1, dtype=i32))

        # -- sorted merge into the pool -----------------------------------
        all_d = torch.cat([cand_d, nd], dim=1)
        all_i = torch.cat([cand_ids, new_ids], dim=1)
        all_e = torch.cat([cand_exp, ~fresh], dim=1)
        if use_merge:
            # id-grouped dedup: sort by (id, expanded-first, dist), keep
            # the FIRST copy of every id run, null the rest, then resort
            # by distance. Keyed on id alone: a re-scored distance need
            # not be bit-identical to the first encounter
            all_i, not_e, all_d = sort_multi((all_i, ~all_e, all_d), 3)
            dup = torch.zeros_like(not_e)
            dup[:, 1:] = all_i[:, 1:] == all_i[:, :-1]
            all_d = torch.where(dup, torch.full_like(all_d, _INF), all_d)
            all_i = torch.where(dup, torch.full_like(all_i, n_total), all_i)
            all_e = dup | ~not_e
        all_d, all_i, all_e = sort_multi((all_d, all_i, all_e), 2)
        return all_i[:, :L], all_d[:, :L], all_e[:, :L]

    for it in range(max_hops):
        if it % CHECK_EVERY == 0 and not bool(torch.any(~cand_exp)):
            break
        # -- pick the `expand` closest unexpanded entries per query --------
        unexp = ~cand_exp                                           # [B, L]
        if e == 1:
            sel = torch.argmax(unexp.to(torch.uint8), dim=1)[:, None]
            sel_valid = torch.any(unexp, dim=1)[:, None]
        else:
            # positions of the first `expand` unexpanded entries (sorted pool)
            rank = torch.cumsum(unexp.to(i32), dim=1) - 1
            onrank = unexp & (rank < e)
            nsel = torch.sum(onrank, dim=1)
            key = torch.where(onrank, L_iota, L + 1)
            sel = torch.topk(key, e, dim=1, largest=False, sorted=True).values
            sel_valid = sel <= L
            sel = torch.clamp(sel, max=L - 1)
            sel_valid = sel_valid & (e_iota < nsel[:, None])
        sel = sel.long()

        cur = torch.where(sel_valid, cand_ids.gather(1, sel),
                          torch.full_like(sel, n_total, dtype=i32))  # [B, e]
        if collect_expanded > 0:
            cur_d = torch.where(sel_valid, cand_d.gather(1, sel),
                                torch.full_like(sel, _INF, dtype=torch.float32))
            pos = hops[:, None] + e_iota
            pos = torch.where(sel_valid & (pos < H), pos, H).long()
            hist_ids.scatter_(1, pos, cur)
            hist_d.scatter_(1, pos, cur_d)
        # mark the picks expanded; column L takes the invalid picks
        sel_set = torch.where(sel_valid, sel, L)
        exp_p = torch.cat([cand_exp, torch.ones((B, 1), dtype=torch.bool,
                                                device=dev)], dim=1)
        cand_exp = exp_p.scatter_(1, sel_set, True)[:, :L]

        # -- gather neighbour rows (row-gather kernel) ---------------------
        cur_c = torch.clamp(cur, max=n_total - 1)
        nbrs = gather_rows_any(neighbors, cur_c.reshape(-1)).reshape(B, e, M)
        nbrs = torch.where((cur < n_total)[:, :, None], nbrs,
                           torch.full_like(nbrs, n_total))
        if not two_hop:
            fanouts = [nbrs.reshape(B, e * M)]
        else:
            # hop 2, base→query→base: [B, c, M] neighbour-row gathers per
            # chunk of c hop-1 rows (all M at once without chunking)
            c = two_hop_chunk if 0 < two_hop_chunk < M else M
            nbrs1 = nbrs.reshape(B, M)       # two_hop forces e == 1
            fanouts = (_hop2(neighbors, nbrs1[:, s: s + c], n_total)
                       for s in range(0, M, c))
        for fan in fanouts:
            cand_ids, cand_d, cand_exp = process(cand_ids, cand_d, cand_exp,
                                                 fan)
        hops.add_(torch.sum(sel_valid, dim=1, dtype=i32))

    return SearchResult(
        ids=cand_ids[:, :k], dists=cand_d[:, :k], cmps=cmps, hops=hops,
        hist_ids=hist_ids[:, :H] if collect_expanded > 0 else None,
        hist_d=hist_d[:, :H] if collect_expanded > 0 else None)


def run_query_batches(q: torch.Tensor, nq: int, qb: int,
                      run: Callable[[torch.Tensor], Tuple],
                      device_out: bool) -> Tuple:
    """Shared query-batching driver: stream batches of ``qb`` rows of `q`
    [nq, d] through ``run(qs) -> tuple of [rows, ...] tensors`` and
    concatenate the columns. A query's result does not depend on its batch,
    so the last batch is simply shorter (the JAX package pads it to one
    compiled shape). ``device_out`` leaves results on the device."""
    outs = [run(q[s: s + qb]) for s in range(0, nq, qb)]
    cols = [torch.cat(c) if len(c) > 1 else c[0] for c in zip(*outs)]
    if device_out:
        return tuple(cols)
    return tuple(c.cpu().numpy() for c in cols)


def search_batched(base, neighbors, eps, queries, k, L, metric=Metric.IP,
                   query_batch: int = 1024, **kw) -> Tuple:
    """Host wrapper: stream query batches through `beam_search`; returns
    numpy (ids, dists, cmps, hops)."""
    metric = Metric.parse(metric)
    if not isinstance(queries, torch.Tensor):
        queries = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
    queries = queries.to(base.device)
    nq = queries.shape[0]
    qb = min(query_batch, nq)

    def run(qs):
        r = beam_search(base, neighbors, eps, qs, k=k, L=L, metric=metric,
                        **kw)
        return r.ids, r.dists, r.cmps, r.hops

    return run_query_batches(queries, nq, qb, run, device_out=False)
