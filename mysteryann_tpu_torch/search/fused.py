"""Fused neighbour-block search — one byte row gathered per expansion.

Port of ``mysteryann_tpu/search/fused.py``. Each node's neighbour vectors
are stored INLINE, quantized to int8 (or int4), together with their scales
and ids, in ONE byte row of a table ``uint8 [N+1, R]``::

    [ M·d·bits/8 quantized values | M f32 scales | M i32 ids ]

so an expansion fetches a single row through the row-gather kernel K1
(``ops.gather``) instead of an adjacency row plus M vector rows. Traversal
distances are quantized; the head of the pool is re-ranked with exact f32
distances (a small gather of rows per query), so reported distances are
exact and the quantization only shifts traversal order.

The JAX package pads each row to a multiple of 1 KB and shapes the table
``[N+1, R/128, 128]`` for the TPU's DMA tiling; that padding has no role
here. With ``M % 16 == 0`` (``pack_neighbor_table`` pads M) and
``d % 8 == 0`` at int8 (``d % 16 == 0`` at int4), R is a multiple of 128 B,
so every row starts 16-byte aligned and K1 moves it in 16-byte words.
``fused_table_from_jax`` strips the padding from a JAX table, so the two
packages' tables compare byte for byte.

Sentinels: row ``n_base`` is the sentinel row (zero vectors, invalid ids)
that an invalid pick gathers; invalid neighbour ids are ``n_base + 1`` and
pool padding is ``n_base + 2``.

As in ``search/beam.py`` the JAX ``lax.while_loop`` is a host loop of
tensor ops that reads liveness from the device every ``CHECK_EVERY``
steps; the extra steps after every query has finished change nothing.

Memory: N·R bytes, e.g. 6.5 GB for 1M nodes at width 48, d=128, int8.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F_

from mysteryann_tpu_torch.ops.distances import (Metric, array_device,
                                                prepare_vectors)
from mysteryann_tpu_torch.ops.gather import gather_rows, gather_rows_any
from mysteryann_tpu_torch.ops.sort import sort_multi
from mysteryann_tpu_torch.search.beam import (CHECK_EVERY, _INF, _bit_of,
                                              _first_occurrence,
                                              _scatter_or_bits,
                                              run_query_batches)
from mysteryann_tpu_torch.search.seeding import make_seed_sample, seed_scan

if TYPE_CHECKING:
    from mysteryann_tpu_torch.graph.roargraph import RoarGraphIndex

_I32 = torch.int32


def _row_bytes(M: int, d: int, bits: int = 8) -> int:
    """Bytes of one table row: quantized values, then M scales and M ids."""
    return M * d * bits // 8 + 8 * M


def _pack_chunk(base: torch.Tensor, rows: torch.Tensor, n_base: int, M: int,
                d: int, bits: int = 8) -> torch.Tensor:
    """Quantize and byte-pack one chunk of neighbour blocks.

    rows int32 [c, M] (sentinel >= n_base) → uint8 [c, R]: per-neighbour
    symmetric int8 (or int4 when ``bits=4``) quantization of the
    neighbour's vector, its f32 scale and its id (ids >= n_base become
    n_base+1, "invalid").
    """
    c = rows.shape[0]
    valid = rows < n_base
    v = gather_rows_any(
        base, torch.clamp(rows, max=n_base - 1).reshape(-1)).reshape(c, M, d)
    amax = torch.amax(torch.abs(v), dim=2)
    qmax = 127.0 if bits == 8 else 7.0
    # the JAX package's compiled function divides by the constant qmax as a
    # product with its float32 reciprocal; the same product packs the same
    # scale bits
    sc = torch.where(valid, amax * float(np.float32(1.0 / qmax)),
                     torch.zeros_like(amax))
    qv = torch.where(sc[..., None] > 0,
                     v / torch.clamp(sc, min=1e-30)[..., None],
                     torch.zeros_like(v))
    qv = torch.clamp(torch.round(qv), -qmax, qmax).to(torch.int8)
    ids = torch.where(valid, rows, n_base + 1).to(_I32)

    if bits == 4:
        # split-halves layout: byte j holds element j in its low nibble and
        # element j + d/2 in its high nibble (the unpack needs no interleave)
        qu = qv.view(torch.uint8)
        qv_b = (((qu[..., d // 2:] & 0xF) << 4) | (qu[..., : d // 2] & 0xF)
                ).reshape(c, M * d // 2)
    else:
        qv_b = qv.view(torch.uint8).reshape(c, M * d)
    sc_b = sc.to(torch.float32).contiguous().view(torch.uint8)    # [c, 4M]
    id_b = ids.contiguous().view(torch.uint8)                      # [c, 4M]
    return torch.cat([qv_b, sc_b, id_b], dim=1)


def _bitonic_merge_triple(d: torch.Tensor, i: torch.Tensor, e: torch.Tensor,
                          L: int):
    """Merge a sorted pool with new entries into a sorted pool.

    Inputs are [B, P], P a power of two, laid out bitonically: the
    ascending pool, then +inf padding, then the new entries in DESCENDING
    order. log2(P) compare-exchange stages of selects replace a full sort.
    Order key is lexicographic (dist, id). Returns the first L columns.
    """
    B, P = d.shape
    if P & (P - 1):
        raise ValueError(f"bitonic width {P} is not a power of two")
    s = P // 2
    while s >= 1:
        shp = (B, P // (2 * s), 2, s)
        dr, ir, er = d.reshape(shp), i.reshape(shp), e.reshape(shp)
        lo_d, hi_d = dr[:, :, 0], dr[:, :, 1]
        lo_i, hi_i = ir[:, :, 0], ir[:, :, 1]
        lo_e, hi_e = er[:, :, 0], er[:, :, 1]
        swap = (hi_d < lo_d) | ((hi_d == lo_d) & (hi_i < lo_i))
        d = torch.stack([torch.where(swap, hi_d, lo_d),
                         torch.where(swap, lo_d, hi_d)], dim=2).reshape(B, P)
        i = torch.stack([torch.where(swap, hi_i, lo_i),
                         torch.where(swap, lo_i, hi_i)], dim=2).reshape(B, P)
        e = torch.stack([torch.where(swap, hi_e, lo_e),
                         torch.where(swap, lo_e, hi_e)], dim=2).reshape(B, P)
        s //= 2
    return d[:, :L], i[:, :L], e[:, :L]


def _nibbles(x: torch.Tensor) -> torch.Tensor:
    """Signed 4-bit value of each nibble ``x`` in [0, 16), as float32:
    ``(x ^ 8) - 8`` sign-extends without shifting a signed type."""
    return (x ^ 8).to(torch.float32) - 8.0


def _score_packed_rows(q: torch.Tensor, rows: torch.Tensor, metric: Metric,
                       q_sq: torch.Tensor | None, B: int, F: int, M: int,
                       d: int, bits: int, expand: int):
    """Unpack gathered byte rows and score their inline neighbours.

    ``rows`` is the uint8 [B·expand, R] gather output; returns (nd [B, F]
    f32 distances, nbrs [B, F] int32 global ids). The quantized values are
    widened to float32 and multiplied with the f32 query, as the JAX
    package's f32 × bf16 einsum promotes them."""
    qbytes = M * d * bits // 8
    if bits == 4:
        u = rows[:, :qbytes]                                  # [B·e, M·d/2]
        halves = (_nibbles(u & 0xF).reshape(B, F, d // 2),
                  _nibbles(u >> 4).reshape(B, F, d // 2))
        ip_q = (torch.bmm(halves[0], q[:, : d // 2, None])
                + torch.bmm(halves[1], q[:, d // 2:, None]))[:, :, 0]
    else:
        block = rows[:, :qbytes].view(torch.int8).to(torch.float32
                                                     ).reshape(B, F, d)
        ip_q = torch.bmm(block, q[:, :, None])[:, :, 0]
    sc = rows[:, qbytes: qbytes + 4 * M].contiguous().view(
        torch.float32).reshape(B, F)
    nbrs = rows[:, qbytes + 4 * M: qbytes + 8 * M].contiguous().view(
        _I32).reshape(B, F)
    ip = ip_q * sc
    if metric in (Metric.IP, Metric.COSINE):
        return -ip, nbrs
    if bits == 4:
        vn = (torch.sum(halves[0] * halves[0], dim=2)
              + torch.sum(halves[1] * halves[1], dim=2))
    else:
        vn = torch.sum(block * block, dim=2)
    nd = q_sq - 2.0 * ip + vn * sc * sc
    return nd, nbrs


def _fused_beam(table: torch.Tensor, base: torch.Tensor, eps: torch.Tensor,
                q: torch.Tensor, k: int, L: int, metric: Metric,
                max_hops: int, n_base: int, M: int, d: int,
                collect_expanded: int = 0, visited_mode: str = "merge",
                expand: int = 1, seed_ids: torch.Tensor | None = None,
                seed_d: torch.Tensor | None = None,
                exit_f: float | None = None, bits: int = 8,
                rerank: int = 0):
    """Beam search of ``q`` [B, d] over the fused table; returns (ids
    [B, k], dists [B, k], cmps [B], hops [B]) and, with
    ``collect_expanded=H > 0``, the expansion history [B, H] (reference
    full_retset, src/index_bipartite.cpp:1318): the first H nodes popped,
    in pop order, padded with ``n_base + 2``.

    ``expand`` pops that many closest-unexpanded entries per step (fan-out
    expand·M). ``visited_mode``: "merge" dedups re-encountered ids inside
    the pool sort (the serving default); "pool" tests membership against
    the live pool; "bitmask" keeps a per-query visited bitmask (each id
    scored once — reference-parity ``cmps``); the last two merge new
    entries through a bitonic cascade. ``seed_ids``/``seed_d`` [B, S]
    replace the global entry points ``eps`` with per-query seeds and their
    (approximate) distances. ``exit_f``: a query stops once its closest
    unexpanded candidate is beyond ``d_k + exit_f·(d_k − d_0)``.
    ``rerank`` sets the depth of the exact f32 rerank of the pool head.
    """
    metric = Metric.parse(metric)
    B = q.shape[0]
    F = expand * M
    q_sq = (torch.sum(q * q, dim=1, keepdim=True) if metric == Metric.L2
            else None)

    def step(cur):
        # THE gather: one packed byte row per expansion (K1)
        rows = gather_rows(table, torch.clamp(cur, max=n_base).reshape(-1))
        return _score_packed_rows(q, rows, metric, q_sq, B=B, F=F, M=M, d=d,
                                  bits=bits, expand=expand)

    def exact(ids):
        vecs = gather_rows_any(base, torch.clamp(ids, max=n_base - 1)
                               .reshape(-1)).reshape(ids.shape + (d,))
        return _exact_dists(q, vecs, metric, q_sq)

    return fused_lockstep(
        q, eps, step, exact, k=k, L=L, metric=metric, max_hops=max_hops,
        n_base=n_base, M=M, collect_expanded=collect_expanded,
        visited_mode=visited_mode, expand=expand, seed_ids=seed_ids,
        seed_d=seed_d, exit_f=exit_f, bits=bits, rerank=rerank)


def _exact_dists(q: torch.Tensor, vecs: torch.Tensor, metric: Metric,
                 q_sq: torch.Tensor | None) -> torch.Tensor:
    """Exact f32 distances of ``vecs`` [B, c, d] to their queries ``q``
    [B, d]; ``q_sq`` is the queries' squared norms [B, 1] (L2 only)."""
    ip = torch.bmm(vecs, q[:, :, None])[:, :, 0]
    if metric in (Metric.IP, Metric.COSINE):
        return -ip
    return q_sq - 2.0 * ip + torch.sum(vecs * vecs, 2)


def fused_lockstep(q: torch.Tensor, eps: torch.Tensor,
                   step: Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                        torch.Tensor]],
                   exact: Callable[[torch.Tensor], torch.Tensor], *,
                   k: int, L: int, metric: Metric, max_hops: int,
                   n_base: int, M: int, collect_expanded: int = 0,
                   visited_mode: str = "merge", expand: int = 1,
                   seed_ids: torch.Tensor | None = None,
                   seed_d: torch.Tensor | None = None,
                   exit_f: float | None = None, bits: int = 8,
                   rerank: int = 0):
    """The fused engine's loop, with the row fetch and the exact distances
    supplied by the caller (`_fused_beam`'s arguments and results).

    ``step(cur)``: the picks ``cur`` int32 [B, expand] (``n_base`` for no
    pick) → (nd f32 [B, expand·M], nbrs int32 [B, expand·M]): the
    quantized distances and the ids of the picks' inline neighbours, ids
    >= ``n_base`` invalid. ``exact(ids)``: int32 [B, c] → f32 [B, c], the
    exact distances of valid ids to their queries (any value for invalid
    ids) — the unseeded entry points' and the rerank head's.

    The single-card engine gathers a byte row of its table per pick;
    ``parallel.ShardedFusedSearcher`` gathers the owner's row and sums the
    scores over ``mp``. The loop reads only the pool to decide when to
    stop, so callers whose pools are equal make the same calls.
    """
    if visited_mode not in ("merge", "bitmask", "pool"):
        raise ValueError(f"unknown visited_mode {visited_mode!r}")
    use_bitmask = visited_mode == "bitmask"
    use_pool = visited_mode == "pool"
    metric = Metric.parse(metric)
    dev = q.device
    B = q.shape[0]
    n_total = n_base + 2   # sentinel row n_base; invalid id n_base+1
    if 2 * n_total + 1 >= 1 << 31:
        raise ValueError(f"n_base={n_base} too large for the merge key")

    if seed_ids is not None:
        if seed_d is None:
            raise ValueError("seed_ids needs seed_d")
        ep_ids = seed_ids.to(_I32)
    else:
        ep_ids = eps.to(_I32)[None, :].expand(B, eps.shape[0]).contiguous()
    E = ep_ids.shape[1]
    pad = L - E
    if pad < 0:
        raise ValueError(f"L={L} must be >= number of entry points E={E}")
    ep_d = seed_d.to(torch.float32) if seed_ids is not None else exact(ep_ids)
    cand_ids = torch.cat(
        [ep_ids, torch.full((B, pad), n_total, dtype=_I32, device=dev)], 1)
    cand_d = torch.cat([ep_d, torch.full((B, pad), _INF, device=dev)], 1)
    cand_exp = torch.cat(
        [torch.zeros((B, E), dtype=torch.bool, device=dev),
         torch.ones((B, pad), dtype=torch.bool, device=dev)], 1)
    cand_d, cand_ids, cand_exp = sort_multi((cand_d, cand_ids, cand_exp), 2)

    # column H of the history takes the writes the JAX package drops
    H = max(collect_expanded, 1)
    hist = torch.full((B, H + 1), n_total, dtype=_I32, device=dev)

    visited = torch.zeros((B, -(-n_base // 32) if use_bitmask else 1),
                          dtype=_I32, device=dev)
    if use_bitmask:
        ep_c = torch.clamp(ep_ids, max=n_base - 1)
        _scatter_or_bits(visited, ep_c >> 5, _bit_of(ep_c), ep_ids < n_base)
    F = expand * M                                      # per-step fan-out
    P = 1 << (L + F - 1).bit_length()                   # bitonic width
    cmps = torch.full((B,), E, dtype=_I32, device=dev)
    hops = torch.zeros((B,), dtype=_I32, device=dev)
    L_iota = torch.arange(L, dtype=_I32, device=dev).expand(B, L)
    e_iota = torch.arange(expand, dtype=_I32, device=dev)[None, :]
    inf_col = torch.full((B, 1), _INF, device=dev)

    def maybe_exit(pool_d, pool_e):
        if exit_f is None:
            return pool_e
        d0, dk = pool_d[:, 0], pool_d[:, k - 1]
        min_unexp = torch.amin(torch.where(pool_e, inf_col, pool_d), dim=1)
        stop = (min_unexp > dk + exit_f * (dk - d0)) & torch.isfinite(dk)
        return pool_e | stop[:, None]

    for it in range(max_hops):
        if it % CHECK_EVERY == 0 and not bool(torch.any(~cand_exp)):
            break
        unexp = ~cand_exp
        if expand == 1:
            sel = torch.argmax(unexp.to(torch.uint8), dim=1)[:, None]
            sel_valid = torch.any(unexp, dim=1)[:, None]
        else:
            # positions of the first `expand` unexpanded entries
            rank = torch.cumsum(unexp.to(_I32), dim=1) - 1
            onrank = unexp & (rank < expand)
            nsel = torch.sum(onrank, dim=1)
            key = torch.where(onrank, L_iota, L + 1)
            sel = torch.topk(key, expand, dim=1, largest=False,
                             sorted=True).values
            sel_valid = (sel <= L) & (e_iota < nsel[:, None])
            sel = torch.clamp(sel, max=L - 1)
        sel = sel.long()
        cur = torch.where(sel_valid, cand_ids.gather(1, sel),
                          torch.full_like(sel, n_base, dtype=_I32))
        # mark the picks expanded; column L takes the invalid picks
        exp_p = torch.cat([cand_exp, torch.ones((B, 1), dtype=torch.bool,
                                                device=dev)], dim=1)
        cand_exp = exp_p.scatter_(1, torch.where(sel_valid, sel, L),
                                  True)[:, :L]
        if collect_expanded > 0:
            pos = hops[:, None] + e_iota
            pos = torch.where(sel_valid & (pos < H), pos, H).long()
            hist.scatter_(1, pos, cur)

        nd, nbrs = step(cur)
        hops.add_(torch.sum(sel_valid, dim=1, dtype=_I32))

        if use_bitmask or use_pool:
            in_b = nbrs < n_base
            if use_pool:
                seen = torch.any(nbrs[:, :, None] == cand_ids[:, None, :],
                                 dim=2)
            else:
                nb_c = torch.where(in_b, nbrs, 0)
                words, bitv = nb_c >> 5, _bit_of(nb_c)
                seen = (visited.gather(1, words.long()) & bitv) != 0
            fresh = in_b & ~seen & _first_occurrence(nbrs)
            if use_bitmask:
                _scatter_or_bits(visited, words, bitv, fresh)
            nd = torch.where(fresh, nd, _INF)
            new_ids = torch.where(fresh, nbrs, n_total)
            cmps.add_(torch.sum(fresh, dim=1, dtype=_I32))
            # sort the F new entries, then ONE bitonic merge into the pool
            nd_s, ni_s, ne_s = sort_multi((nd, new_ids, ~fresh), 2)
            pad_w = P - L - F
            all_d = torch.cat([cand_d, torch.full((B, pad_w), _INF,
                                                  device=dev),
                               nd_s.flip(1)], dim=1)
            all_i = torch.cat([cand_ids, torch.full((B, pad_w), n_total,
                                                    dtype=_I32, device=dev),
                               ni_s.flip(1)], dim=1)
            all_e = torch.cat([cand_exp, torch.ones((B, pad_w),
                                                    dtype=torch.bool,
                                                    device=dev),
                               ne_s.flip(1)], dim=1)
            cand_d, cand_ids, cand_exp = _bitonic_merge_triple(
                all_d, all_i, all_e, L)
            cand_exp = maybe_exit(cand_d, cand_exp)
            continue

        # merge mode: re-encountered ids are re-scored and deduplicated in
        # the merge — sort by (id, not-expanded, dist), keep the first copy
        # of every id run (the expanded one, else the best-scoring one),
        # resort by (dist, id). Padding (~fresh) enters pre-expanded.
        fresh = nbrs < n_base
        nd = torch.where(fresh, nd, _INF)
        new_ids = torch.where(fresh, nbrs, n_total)
        cmps.add_(torch.sum(fresh, dim=1, dtype=_I32))
        all_d = torch.cat([cand_d, nd], dim=1)
        all_i = torch.cat([cand_ids, new_ids], dim=1)
        not_e = ~torch.cat([cand_exp, ~fresh], dim=1)
        # (id, not-expanded) in one int32 image — ids < 2**30, so
        # 2·id + not_e orders like the pair, and one int64 sort on
        # (image, dist) replaces the JAX package's 3-key sort
        key, all_d = sort_multi((all_i * 2 + not_e.to(_I32), all_d), 2)
        all_i, not_e = key >> 1, (key & 1).bool()
        dup = torch.zeros_like(not_e)
        dup[:, 1:] = all_i[:, 1:] == all_i[:, :-1]
        all_d = torch.where(dup, _INF, all_d)
        all_i = torch.where(dup, n_total, all_i)
        all_e = dup | ~not_e
        all_d, all_i, all_e = sort_multi((all_d, all_i, all_e), 2)
        cand_ids, cand_d = all_i[:, :L], all_d[:, :L]
        cand_exp = maybe_exit(cand_d, all_e[:, :L])

    # exact f32 rerank of the pool head (also drops residual id copies
    # that entered via different quantized source blocks); int4 traversal
    # misorders the pool more, so its rerank reaches deeper
    kk = min(L, rerank or max(2 * k, k + 8) * (2 if bits == 4 else 1))
    head = cand_ids[:, :kk]
    ed = torch.where(head < n_base, exact(head), _INF)
    ed, ei = sort_multi((ed, head), 2)
    dup = torch.zeros_like(ei, dtype=torch.bool)
    dup[:, 1:] = ei[:, 1:] == ei[:, :-1]
    ed, ei = sort_multi((torch.where(dup, _INF, ed), ei), 2)
    if collect_expanded > 0:
        return ei[:, :k], ed[:, :k], cmps, hops, hist[:, :H]
    return ei[:, :k], ed[:, :k], cmps, hops


def pack_neighbor_table(base: torch.Tensor, neighbors, chunk: int = 16384,
                        into: torch.Tensor | None = None, bits: int = 8,
                        ) -> Tuple[torch.Tensor, int]:
    """Pack a padded adjacency into the fused byte-row table.

    ``base`` is the metric-prepared f32 [N, d] on its device; ``neighbors``
    int32 [N, M] with sentinel >= N, a numpy array or a tensor (the
    connectivity pass repacks its device-resident supply graph). Returns
    (table uint8 [N+1, R] on ``base``'s device, M padded to a multiple of
    16).

    Chunks are packed into one preallocated table, so the f32 gather
    scratch stays bounded and the table is never concatenated; ``into``
    recycles a table of the same shape (every row is overwritten). Row N
    is the sentinel: zero vectors, invalid ids.
    """
    n, d = base.shape
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if d % (8 if bits == 8 else 16):
        # the same rule as the JAX package: callers pad dims once
        # (io.formats.data_align, or FusedSearcher's column zero-pad)
        raise ValueError(f"fused byte-row packing needs dim % "
                         f"{8 if bits == 8 else 16} == 0 at bits={bits}, "
                         f"got d={d}; zero-pad the vectors")
    dev = base.device
    if not isinstance(neighbors, torch.Tensor):
        neighbors = torch.from_numpy(np.ascontiguousarray(neighbors,
                                                          np.int32))
    neighbors = neighbors.to(device=dev, dtype=_I32)
    M0 = neighbors.shape[1]
    if M0 % 16:
        neighbors = F_.pad(neighbors, (0, 16 - M0 % 16), value=n)
    M = neighbors.shape[1]
    shape = (n + 1, _row_bytes(M, d, bits))
    if (into is not None and tuple(into.shape) == shape
            and into.dtype == torch.uint8 and into.device == dev):
        table = into
    else:
        table = torch.empty(shape, dtype=torch.uint8, device=dev)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        table[s:e] = _pack_chunk(base, neighbors[s:e], n_base=n, M=M, d=d,
                                 bits=bits)
    table[n:] = _pack_chunk(base, torch.full((1, M), n, dtype=_I32,
                                             device=dev),
                            n_base=n, M=M, d=d, bits=bits)
    return table, M


def fused_table_from_jax(table_np: np.ndarray, n: int, M: int, d: int,
                         bits: int = 8,
                         device: torch.device | str | None = None
                         ) -> torch.Tensor:
    """The JAX package's table ``[n+1, R_pad/128, 128]`` (as numpy) as this
    package's ``uint8 [n+1, R]`` on ``device`` (default: the card): the TPU
    row padding is stripped."""
    t = np.asarray(table_np, np.uint8)
    if t.shape[0] != n + 1:
        raise ValueError(f"table has {t.shape[0]} rows, want n+1={n + 1}")
    R = _row_bytes(M, d, bits)
    flat = t.reshape(n + 1, -1)
    if flat.shape[1] < R:
        raise ValueError(f"table rows hold {flat.shape[1]} B < {R} B")
    return torch.from_numpy(np.ascontiguousarray(flat[:, :R])).to(
        array_device(device))


class FusedSearcher:
    """Serving engine over inline quantized neighbour-block byte rows."""

    def __init__(self, index: "RoarGraphIndex", base, chunk: int = 65536,
                 max_degree: int = 0, seed_sample: int = 0, bits: int = 8,
                 device: torch.device | str | None = None):
        """``base`` is a numpy array or a tensor; everything lives on
        ``device`` (default: ``base``'s device for a tensor, else the card;
        ``device="cpu"`` runs on the CPU).
        ``max_degree`` keeps the first (closest) neighbours of each node.
        ``seed_sample=r`` keeps a strided 1-in-r bf16 sample of the base
        for per-query entry-point scans (``search(seeds=...)``).
        ``bits=4`` packs traversal rows two values per byte — half the
        row bytes for coarser traversal distances; the exact f32 rerank
        keeps reported distances exact either way."""
        self.metric = index.metric
        self.base = prepare_vectors(base, self.metric, device)
        self.device = self.base.device
        align = 8 if bits == 8 else 16
        self._col_pad = (align - self.base.shape[1] % align) % align
        if self._col_pad:
            # zero columns change no IP/L2/cosine distance; they keep the
            # quantized region a whole number of 16-byte words
            self.base = F_.pad(self.base, (0, self._col_pad))
        n, d = self.base.shape
        nb = np.asarray(index.graph.neighbors)
        if max_degree and max_degree < nb.shape[1]:
            nb = nb[:, :max_degree]  # adjacency is closest-first per node
        self.eps = torch.tensor([index.graph.ep], dtype=_I32,
                                device=self.device)
        self.bits = bits
        self.table, self.M = pack_neighbor_table(self.base, nb, chunk=chunk,
                                                 bits=bits)
        self.n_base, self.d = n, d
        self._samp = (make_seed_sample(self.base, seed_sample)
                      if seed_sample else None)

    def search(self, queries, k: int, L: int, query_batch: int = 8192,
               max_hops: int = 0, device_out: bool = False,
               visited_mode: str = "auto", expand: int = 1, seeds: int = 0,
               exit_f: float | None = None, rerank: int = 0) -> Tuple:
        """Returns (ids [Q,k], dists [Q,k], cmps [Q], hops [Q]) as numpy, or
        as tensors on the searcher's device with ``device_out=True``."""
        if seeds and self._samp is None:
            raise ValueError("seeds > 0 needs FusedSearcher(seed_sample=r)")
        if seeds > L:
            raise ValueError(f"seeds ({seeds}) must be <= L ({L})")
        if k > L:
            # the pool holds L candidates
            raise ValueError(f"k ({k}) must be <= L ({L})")
        q = prepare_vectors(queries, self.metric, self.device)
        if self._col_pad:
            q = F_.pad(q, (0, self._col_pad))
        nq = q.shape[0]
        mh = max_hops or 4 * L + 32
        if visited_mode == "auto":
            visited_mode = "merge"  # bitmask = parity accounting only

        def run(qs):
            seed_ids = seed_d = None
            if seeds:
                seed_ids, seed_d = seed_scan(*self._samp, qs, n_seeds=seeds,
                                             metric=self.metric)
            return _fused_beam(
                self.table, self.base, self.eps, qs, k=k, L=L,
                metric=self.metric, max_hops=mh, n_base=self.n_base,
                M=self.M, d=self.d, visited_mode=visited_mode,
                expand=expand, seed_ids=seed_ids, seed_d=seed_d,
                exit_f=exit_f, bits=self.bits, rerank=rerank)

        return run_query_batches(q, nq, min(query_batch, nq), run,
                                 device_out)

    def benchmark(self, queries, k: int, L: int, query_batch: int = 8192,
                  warmup: int = 1, visited_mode: str = "auto",
                  expand: int = 1, seeds: int = 0,
                  exit_f: float | None = None, rerank: int = 0) -> dict:
        """Timed sweep entry, as ``Searcher.benchmark``: the queries are on
        the device before the clock starts; on a CUDA device the timed
        region is closed by ``torch.cuda.synchronize()`` on both sides, and
        results are copied to the host after it."""
        q = prepare_vectors(queries, self.metric, self.device)
        qb = min(query_batch, q.shape[0])
        kw = dict(visited_mode=visited_mode, expand=expand, seeds=seeds,
                  exit_f=exit_f, rerank=rerank)

        def sync():
            if q.device.type == "cuda":
                torch.cuda.synchronize(q.device)

        for _ in range(warmup):
            self.search(q[:qb], k, L, query_batch=qb, device_out=True, **kw)
        sync()
        t0 = time.perf_counter()
        out = self.search(q, k, L, query_batch=qb, device_out=True, **kw)
        sync()
        dt = time.perf_counter() - t0
        ids, dists, cmps, hops = (o.cpu().numpy() for o in out)
        return {"L_pq": L, "k": k, "qps": q.shape[0] / dt,
                "avg_cmps": float(cmps.mean()),
                "avg_hops": float(hops.mean()),
                "mean_latency_ms": 1000.0 * dt / max(1, -(-q.shape[0] // qb)),
                "ids": ids.astype(np.int32), "dists": dists}
