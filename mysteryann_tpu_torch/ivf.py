"""IVF (inverted-file) index — sublinear exact-distance search.

Port of ``mysteryann_tpu/ivf.py``. The corpus is partitioned with k-means,
each cluster's vectors are stored CONTIGUOUSLY in a padded block table
``[nc, cap, d]``, and each query scans only its top-``nprobe`` clusters. A
cluster block is one fat row of the table (hundreds of KB), so fetching
blocks is bulk row gathering (kernel K1, ``ops.gather``), and the
per-cluster distance computation is one batched matmul — the ScaNN/SOAR
decomposition (PAPERS.md) without the quantization stage: distances stay
exact f32 (or exact s8·s8 → s32 with ``store="int8"``), and selection is
exact, ties to the lower index (the JAX package's ``approx_min_k`` is exact
on its CPU backend too, with its own tie order). The reference has no IVF;
this is surface beyond it.

Build: Lloyd iterations on the device (assignment = chunked matmul argmin;
update = deterministic segment sums, ``ops.segment``), then a
capacity-bounded reassignment on the host so the padded ``[nc, cap, d]``
layout wastes bounded memory (overflow points move to their next-nearest
cluster with room). ``build_ivf_streaming`` builds an int8 index from a
tile function without a resident f32 corpus.

Serving: the grouped path (``search(grouped=True)``, the default) builds a
cluster-major query map on the device (``_ivf_group``), scans chunks of C
clusters per step — K1 fetches the ``[C, cap, d]`` blocks, one ``bmm``
scores every (cluster, probe-slot) pair — and merges each query's
candidates (``_ivf_merge``). The ungrouped path (``_ivf_search``) gathers a
``[B, cap, d]`` block per probe; it is the grouped path's parity partner.
The s8·s8 products are an f32 ``bmm`` of the int8 values (exact for
d ≤ 1024, TF32 off — ``ops.distances``); past that, ``torch._int_mm`` per
cluster on the card.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Tuple

import numpy as np
import torch

from mysteryann_tpu_torch.index import register_index
from mysteryann_tpu_torch.ops.distances import (Metric, array_device,
                                                pairwise_dist, prepare_vectors)
from mysteryann_tpu_torch.ops.gather import gather_rows, gather_rows_any
from mysteryann_tpu_torch.ops.knn import _EXACT_F32_DIM, _s8_dot, exact_knn_device
from mysteryann_tpu_torch.ops.segment import segment_sum
from mysteryann_tpu_torch.ops.sort import sort_multi, topk_smallest

_I32 = torch.int32
_INF = float("inf")


def _assign(x, centroids, metric: Metric) -> torch.Tensor:
    """Nearest centroid per row (first index among ties), int32 [n]."""
    return torch.argmin(pairwise_dist(x, centroids, metric=metric),
                        dim=1).to(_I32)


def _ivf_topc(q, centroids, nprobe: int, metric: Metric) -> torch.Tensor:
    """The ``nprobe`` nearest clusters per query, int32 [B, nprobe]."""
    cd = pairwise_dist(q, centroids, metric=metric)
    return topk_smallest(cd, nprobe)[1].to(_I32)


def _ivf_group(top_c: torch.Tensor, nc: int, qmax: int):
    """Cluster-major query map on the device: top_c [B, p] -> (qmap
    [nc, qmax] int32 with sentinel B, slots [B, p, 2] = (cluster, rank),
    valid [B, p]).

    Probes beyond a cluster's ``qmax`` slot budget are dropped (valid=False,
    masked at the merge), and so are entries with ``top_c >= nc``. The
    JAX package's dropped scatter writes (``mode="drop"``) land here in an
    extra row ``nc`` that is cut off.
    """
    B, p = top_c.shape
    dev = top_c.device
    flat_c = top_c.reshape(-1).to(_I32)
    arrival = torch.arange(B * p, dtype=_I32, device=dev)   # q-major order
    cs, ar = sort_multi((flat_c, arrival), 2)
    is_start = torch.ones_like(cs, dtype=torch.bool)
    is_start[1:] = cs[1:] != cs[:-1]
    pos = torch.arange(B * p, dtype=_I32, device=dev)
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = pos - seg_start
    keep = (rank < qmax) & (cs < nc)
    qs = ar // p
    qmap = torch.full((nc + 1, qmax), B, dtype=_I32, device=dev)
    qmap[torch.where(keep, cs, nc).long(),
         torch.where(keep, rank, 0).long()] = torch.where(keep, qs, B)
    # scatter (cluster, rank) back to (query, probe) order via arrival
    ar = ar.long()
    slots = torch.zeros((B * p, 2), dtype=_I32, device=dev)
    slots[ar, 0] = torch.where(keep, cs, 0)
    slots[ar, 1] = torch.where(keep, rank, 0)
    valid = torch.zeros(B * p, dtype=torch.bool, device=dev)
    valid[ar] = keep
    return qmap[:nc], slots.reshape(B, p, 2), valid.reshape(B, p)


def _grouped_scan_core(q, qmap, blocks, block_ids, k: int, cap: int,
                       n_base: int, dist_fn):
    """Shared chunked cluster-major scan (see the public wrappers below).

    Scans CHUNKS of C clusters; each step fetches its chunk's blocks with
    the gather kernel (K1 — one fat row of ``cap·d`` elements per cluster)
    and runs one batched matmul over every (cluster, probe-slot) pair in the
    chunk. Returns per-(cluster, slot) candidates: ids / dists
    [nc, qmax, k].
    """
    B, qmax = q.shape[0], qmap.shape[1]
    nc, dev = blocks.shape[0], blocks.device
    kk = min(k, cap)
    # chunk size: bound the [C, qmax, cap] score block
    C = max(1, min(nc, 64, 8192 // max(1, qmax)))
    cidx = torch.arange(nc, dtype=_I32, device=dev)
    ids = torch.empty((nc, qmax, kk), dtype=_I32, device=dev)
    vals = torch.empty((nc, qmax, kk), dtype=torch.float32, device=dev)
    for c0 in range(0, nc, C):
        c1 = min(c0 + C, nc)
        blk = gather_rows(blocks, cidx[c0:c1])              # K1: [C, cap, d]
        bids = block_ids[c0:c1]                             # [C, cap]
        qrow = torch.clamp(qmap[c0:c1], max=B - 1)          # [C, qmax]
        qv = gather_rows_any(q, qrow.reshape(-1)).reshape(c1 - c0, qmax, -1)
        dist = dist_fn(qv, blk)                             # [C, qmax, cap]
        dist = torch.where(bids[:, None, :] < n_base, dist, _INF)
        v, pos = topk_smallest(dist.reshape(-1, cap), kk)
        vals[c0:c1] = v.reshape(c1 - c0, qmax, kk)
        ids[c0:c1] = bids.gather(1, pos.reshape(c1 - c0, -1)).reshape(
            c1 - c0, qmax, kk)
    if k > cap:  # degenerate tiny clusters
        vals = torch.cat([vals, vals.new_full((nc, qmax, k - cap), _INF)], 2)
        ids = torch.cat([ids, ids.new_full((nc, qmax, k - cap), n_base)], 2)
    return ids, vals


def _ivf_scan_grouped(q, qmap, blocks, block_ids, k: int, metric: Metric,
                      cap: int, n_base: int):
    """Cluster-major scan: batched matmuls over the queries that probe each
    cluster (``qmap`` [nc, qmax], sentinel = B). Each cluster block is read
    once per batch. Returns ids / dists [nc, qmax, k]."""
    def dist_fn(qv, blk):
        ip = torch.bmm(qv, blk.transpose(1, 2))
        if metric in (Metric.IP, Metric.COSINE):
            return -ip
        qn = torch.sum(qv * qv, dim=2, keepdim=True)
        bn = torch.sum(blk * blk, dim=2)
        return qn - 2.0 * ip + bn[:, None, :]

    return _grouped_scan_core(q, qmap, blocks, block_ids, k, cap, n_base,
                              dist_fn)


def _ivf_scan_grouped_i8(q_i8, qmap, blocks, block_ids, k: int, cap: int,
                         n_base: int):
    """int8 twin of `_ivf_scan_grouped` (IP/cosine only): one global base
    scale + per-row query scales keep raw s8·s8 → s32 scores
    order-preserving per query, so ranking needs no dequantization. The
    returned "distances" are raw -s32 in each query's own scale — valid for
    per-query merging, not comparable across queries; callers rerank (or
    rescale by q_scale · g_scale) for reportable distances."""
    def dist_fn(qv, blk):
        if qv.shape[2] <= _EXACT_F32_DIM:
            # every partial sum is an integer below 2²⁴: the f32 bmm of the
            # int8 values is the exact s32 product
            return -torch.bmm(qv.float(), blk.float().transpose(1, 2))
        return -torch.stack([_s8_dot(a, b) for a, b in zip(qv, blk)]).float()

    return _grouped_scan_core(q_i8, qmap, blocks, block_ids, k, cap, n_base,
                              dist_fn)


def _ivf_merge(cand_ids, cand_d, slots, valid, k: int):
    """Per-query merge: gather each query's p×k candidates and take the
    top k. ``slots`` [B, p, 2] = (cluster, slot-within-cluster) of the
    query's probes in the scan output; ``valid`` [B, p] masks dropped
    probes."""
    B = slots.shape[0]
    s0, s1 = slots[:, :, 0].long(), slots[:, :, 1].long()
    ci = cand_ids[s0, s1].reshape(B, -1)                   # [B, p·k]
    cd = torch.where(valid[:, :, None], cand_d[s0, s1], _INF).reshape(B, -1)
    vals, pos = topk_smallest(cd, k)
    return ci.gather(1, pos), vals


def _ivf_probe_scan(q, qmap, slots, valid, blocks, block_ids, k: int,
                    store: str, metric: Metric, cap: int, n_base: int,
                    gscale: float):
    """The grouped scan of the probed clusters and the merge: each query's
    best ``k`` (ids, dists) over the clusters of ``blocks`` it probes.
    int8 stores quantize each query by its own scale and report the raw
    -s32 scores as approximate f32 -IP (/ (query scale · ``gscale``))."""
    if store == "int8":
        amax = torch.clamp(torch.amax(torch.abs(q), dim=1), min=1e-30)
        # a true division: `127.0 / tensor` is reciprocal-then-multiply
        qs = torch.full_like(amax, 127.0) / amax
        q_i8 = torch.clamp(torch.round(q * qs[:, None]),
                           -127, 127).to(torch.int8)
        cand_ids, cand_d = _ivf_scan_grouped_i8(
            q_i8, qmap, blocks, block_ids, k=k, cap=cap, n_base=n_base)
        ids, vals = _ivf_merge(cand_ids, cand_d, slots, valid, k=k)
        return ids, vals / (qs[:, None] * gscale)
    cand_ids, cand_d = _ivf_scan_grouped(
        q, qmap, blocks, block_ids, k=k, metric=metric, cap=cap,
        n_base=n_base)
    return _ivf_merge(cand_ids, cand_d, slots, valid, k=k)


def _ivf_rerank(q, ids, vals, base_f32, k: int, metric: Metric, n_base: int):
    """Exact-f32 rerank of merged candidates: gather each candidate's f32
    row (K1) and recompute the true distance (invalid slots keep inf)."""
    B, R = ids.shape
    rows = gather_rows_any(base_f32, torch.clamp(ids, max=n_base - 1)
                           .reshape(-1)).reshape(B, R, -1)
    ip = torch.bmm(rows, q[:, :, None])[:, :, 0]
    if metric in (Metric.IP, Metric.COSINE):
        dist = -ip
    else:
        dist = (torch.sum(q * q, dim=1, keepdim=True) - 2.0 * ip
                + torch.sum(rows * rows, dim=2))
    dist = torch.where(torch.isfinite(vals), dist, _INF)
    v, pos = topk_smallest(dist, k)
    return ids.gather(1, pos), v


def _ivf_search(q, centroids, blocks, block_ids, k: int, nprobe: int,
                metric: Metric, n_base: int):
    """Ungrouped top-``nprobe`` cluster scan: one ``[B, cap, d]`` block
    gather (K1) per probe, merged into a running top-k."""
    B = q.shape[0]
    top_c = _ivf_topc(q, centroids, nprobe, metric)          # [B, p]
    best_d = torch.full((B, k), _INF, device=q.device)
    best_i = torch.full((B, k), n_base, dtype=_I32, device=q.device)
    for j in range(nprobe):
        cid = top_c[:, j].contiguous()                       # [B]
        block = gather_rows(blocks, cid)                     # [B, cap, d]
        bids = block_ids[cid.long()]                         # [B, cap]
        ip = torch.bmm(block, q[:, :, None])[:, :, 0]
        if metric in (Metric.IP, Metric.COSINE):
            dist = -ip
        else:
            dist = (torch.sum(q * q, dim=1, keepdim=True) - 2.0 * ip
                    + torch.sum(block * block, dim=2))
        dist = torch.where(bids < n_base, dist, _INF)
        cat_i = torch.cat([best_i, bids], dim=1)
        best_d, pos = topk_smallest(torch.cat([best_d, dist], dim=1), k)
        best_i = cat_i.gather(1, pos)
    return best_i, best_d


def _capacity_place(cand: np.ndarray, nc: int, cap: int):
    """Capacity-bounded greedy placement on the host.

    ``cand`` [N, kk] ranks each point's nearest clusters; points go to
    their best-ranked cluster with room (vectorized pass per rank),
    leftovers spill into any cluster with room (cap grows if ALL are
    full). Returns (slot_cluster [N], slot_pos [N], tight cap).
    """
    n, kk = cand.shape
    fill = np.zeros(nc, np.int64)
    slot_cluster = np.full(n, -1, np.int32)
    slot_pos = np.zeros(n, np.int64)
    unplaced = np.arange(n)
    for j in range(kk):  # vectorized greedy pass per candidate rank
        if unplaced.size == 0:
            break
        c = cand[unplaced, j].astype(np.int64)
        order = np.argsort(c, kind="stable")
        cs, us = c[order], unplaced[order]
        offs = np.zeros(nc + 1, np.int64)
        np.cumsum(np.bincount(cs, minlength=nc), out=offs[1:])
        rank = np.arange(cs.size) - offs[cs]
        accept = rank < (cap - fill[cs])
        slot_cluster[us[accept]] = cs[accept].astype(np.int32)
        slot_pos[us[accept]] = fill[cs[accept]] + rank[accept]
        np.add.at(fill, cs[accept], 1)
        unplaced = us[~accept]
    if unplaced.size:  # spill leftovers into clusters with room
        room = cap - fill
        free_cluster = np.repeat(np.arange(nc), room)
        if free_cluster.size < unplaced.size:  # grow cap as needed
            extra = unplaced.size - free_cluster.size
            grow = -(-extra // nc)
            cap += grow
            free_cluster = np.concatenate(
                [free_cluster, np.tile(np.arange(nc), grow)])
        take = free_cluster[: unplaced.size]
        order = np.argsort(take, kind="stable")
        ts, us = take[order], unplaced[order]
        offs = np.zeros(nc + 1, np.int64)
        np.cumsum(np.bincount(ts, minlength=nc), out=offs[1:])
        rank = np.arange(ts.size) - offs[ts]
        slot_cluster[us] = ts.astype(np.int32)
        slot_pos[us] = fill[ts] + rank
        np.add.at(fill, ts, 1)
    return slot_cluster, slot_pos, int(fill.max())


def _kmeans(x_dev: torch.Tensor, n_clusters: int, metric: Metric, iters: int,
            seed: int, chunk: int = 131072) -> np.ndarray:
    """Lloyd iterations on ``x_dev``'s device; returns f32 centroids
    [n_clusters, d] (host). Each chunk's segment sums are deterministic and
    added to the running sums, as the JAX package adds its chunks'."""
    n, d = x_dev.shape
    dev = x_dev.device
    rng = np.random.default_rng(seed)

    def rows(pick):
        return x_dev[torch.from_numpy(pick).to(dev)].cpu().numpy()

    centroids = rows(rng.choice(n, n_clusters, replace=False)).copy()
    for _ in range(iters):
        c_dev = torch.from_numpy(centroids).to(dev)
        sums = torch.zeros((n_clusters, d), device=dev)
        counts = torch.zeros((n_clusters,), device=dev)
        for s in range(0, n, chunk):
            x = x_dev[s: s + chunk]
            a = _assign(x, c_dev, metric)
            sums += segment_sum(x, a, n_clusters)
            counts += segment_sum(torch.ones(x.shape[0], device=dev), a,
                                  n_clusters)
        sums = sums.cpu().numpy().astype(np.float64)
        counts = counts.cpu().numpy().astype(np.float64)
        nonempty = counts > 0
        centroids[nonempty] = (sums[nonempty]
                               / counts[nonempty, None]).astype(np.float32)
        # respawn empty clusters on random points
        n_empty = int((~nonempty).sum())
        if n_empty:
            centroids[~nonempty] = rows(rng.choice(n, n_empty, replace=False))
    return centroids


def _quantize(rows: torch.Tensor, gscale: float) -> torch.Tensor:
    """Global-scale symmetric int8: clip(rint(rows · gscale), ±127)."""
    return torch.clamp(torch.round(rows * gscale), -127, 127).to(torch.int8)


def _to_device(x, dev: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev).contiguous()


@register_index("ivf")
class IVFIndex:
    """IVF over contiguous cluster blocks; optional int8 storage.

    ``store="int8"`` (IP/cosine only) quantizes cluster blocks to int8
    with ONE global symmetric scale; queries get per-row scales at search
    time, so the raw s8·s8 → s32 scores are order-preserving per query and
    ranking needs no dequantization (merged distances are rescaled once for
    reporting). This quarters the resident table. ``keep_f32=True`` retains
    the f32 rows for exact rerank of the merged top candidates
    (``search(..., rerank=R)``).

    Everything lives on ``device`` (default: ``base``'s device for a
    tensor, else the card; ``device="cpu"`` runs on the CPU).
    """

    def __init__(self, base, metric: Metric | str = Metric.IP,
                 n_clusters: int = 0, cap_factor: float = 1.6,
                 kmeans_iters: int = 10, seed: int = 0, verbose: bool = False,
                 store: str = "f32", keep_f32: bool = False,
                 device: torch.device | str | None = None):
        self.metric = Metric.parse(metric)
        if store not in ("f32", "int8"):
            raise ValueError(f"unknown store={store!r}")
        if store == "int8" and self.metric not in (Metric.IP, Metric.COSINE):
            raise ValueError("store='int8' supports IP/cosine only")
        base_dev = prepare_vectors(base, self.metric, device)
        dev = self.device = base_dev.device
        n, dim = base_dev.shape
        nc = n_clusters or max(16, int(np.sqrt(n) * 2))
        t0 = time.perf_counter()
        centroids = _kmeans(base_dev, nc, self.metric, kmeans_iters, seed)
        cap = int(np.ceil(n / nc * cap_factor))

        # capacity-bounded assignment: overflow moves to next-nearest
        # cluster with room (ranked device pass, resolved on host)
        kk = min(8, nc)
        cand = np.empty((n, kk), np.int32)
        c_dev = torch.from_numpy(centroids).to(dev)
        for s in range(0, n, 131072):
            _, ii = exact_knn_device(base_dev[s: s + 131072], c_dev, k=kk,
                                     metric=self.metric, tile=nc)
            cand[s: s + 131072] = ii.cpu().numpy()
        slot_cluster, slot_pos, cap = _capacity_place(cand, nc, cap)
        cap = -(-cap // 32) * 32  # round rows up as the JAX package does

        # the padded block table, scattered on the device (slots unique)
        slot = torch.from_numpy(slot_cluster.astype(np.int64) * cap
                                + slot_pos).to(dev)
        blocks = torch.zeros((nc * cap, dim), device=dev)
        blocks[slot] = base_dev
        ids = torch.full((nc * cap,), n, dtype=_I32, device=dev)
        ids[slot] = torch.arange(n, dtype=_I32, device=dev)

        self.n_base = n
        self.n_clusters = nc
        self.cap = cap
        self.centroids = c_dev
        self.store = store
        if store == "int8":
            amax = np.float32(torch.abs(blocks).max().item())
            self.gscale = float(127.0 / max(amax, 1e-30))
            blocks = _quantize(blocks, self.gscale)
        else:
            self.gscale = 1.0
        self.blocks = blocks.reshape(nc, cap, dim)
        self.block_ids = ids.reshape(nc, cap)
        self.base_f32 = base_dev if keep_f32 else None
        self.dim = dim
        if verbose:
            print(f"IVF: {nc} clusters cap {cap} "
                  f"(waste {nc * cap / n:.2f}x, store {store}) built in "
                  f"{time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)

    @classmethod
    def from_parts(cls, centroids, blocks, block_ids, n_base: int,
                   metric: Metric | str = Metric.IP, gscale: float = 1.0,
                   device: torch.device | str | None = None):
        """Assemble an index from its parts (numpy arrays or tensors).

        ``blocks`` is [nc, cap, dim] (int8 or f32), ``block_ids`` [nc, cap]
        with sentinel >= n_base in padding slots, ``gscale`` the global
        quantization scale (int8 blocks = gscale · f32 rows). The parts go
        to ``device`` (default: ``blocks``' device for a tensor, else the
        card).
        """
        self = cls.__new__(cls)
        self.metric = Metric.parse(metric)
        if device is not None:
            dev = torch.device(device)
        elif isinstance(blocks, torch.Tensor):
            dev = blocks.device
        else:
            dev = array_device(None)
        self.device = dev
        blocks = _to_device(blocks, dev)
        nc, cap, dim = blocks.shape
        if dim != centroids.shape[1]:
            raise ValueError(f"blocks dim {dim} != centroids dim "
                             f"{centroids.shape[1]}")
        self.n_base = int(n_base)
        self.n_clusters = nc
        self.cap = cap
        self.centroids = _to_device(centroids, dev).float()
        self.store = "int8" if blocks.dtype == torch.int8 else "f32"
        if self.store == "int8" and self.metric not in (Metric.IP,
                                                        Metric.COSINE):
            raise ValueError("store='int8' supports IP/cosine only")
        self.gscale = float(gscale)
        self.blocks = blocks
        self.block_ids = _to_device(block_ids, dev).to(_I32)
        self.base_f32 = None
        self.dim = dim
        return self

    def save(self, path: str) -> None:
        """Persist the index in the JAX package's container (uncompressed
        npz: centroids, blocks, block_ids, scalars — the same keys, so
        either package loads the other's file). ``keep_f32`` rerank rows
        are not persisted (they are the corpus itself — reattach via
        ``load(..., base=...)``)."""
        np.savez(path,
                 version=np.int32(1),
                 centroids=self.centroids.cpu().numpy(),
                 blocks=self.blocks.cpu().numpy(),
                 block_ids=self.block_ids.cpu().numpy(),
                 n_base=np.int64(self.n_base),
                 metric=np.bytes_(self.metric.name.encode()),
                 gscale=np.float64(self.gscale))

    @classmethod
    def load(cls, path: str, base=None,
             device: torch.device | str | None = None) -> "IVFIndex":
        """Load a saved index onto ``device`` (default: the card); an
        optional ``base`` re-enables exact-f32 rerank
        (``search(..., rerank=R)``)."""
        dev = array_device(device)
        with np.load(path) as z:
            if int(z["version"]) != 1:
                raise ValueError(f"unknown IVF index version {z['version']}")
            metric = Metric.parse(bytes(z["metric"]).decode().lower())
            self = cls.from_parts(z["centroids"], z["blocks"], z["block_ids"],
                                  n_base=int(z["n_base"]), metric=metric,
                                  gscale=float(z["gscale"]), device=dev)
        if base is not None:
            self.base_f32 = prepare_vectors(base, self.metric, dev)
        return self

    def _search_device(self, q, k: int, nprobe: int):
        return _ivf_search(q, self.centroids, self.blocks, self.block_ids,
                           k=k, nprobe=nprobe, metric=self.metric,
                           n_base=self.n_base)

    def _search_grouped(self, q, k: int, nprobe: int, rerank: int = 0,
                        slot_budget: int = 4):
        """Cluster-major (query-grouped) probe — the compute-shared path.

        The cluster→queries map (``qmap``, width bucketed to a power of
        two) is built on the device (`_ivf_group`). Probes beyond a
        cluster's slot budget are dropped (masked at the merge).
        ``slot_budget`` multiplies the average per-cluster load into the
        padded slot width: scan work is proportional to it, while the drop
        tail shrinks with it.
        """
        B = q.shape[0]
        avg_load = max(1, B * nprobe // self.n_clusters)
        qmax = 1 << int(np.ceil(np.log2(slot_budget * avg_load)))
        top_c = _ivf_topc(q, self.centroids, nprobe, self.metric)
        qmap, slots, valid = _ivf_group(top_c, self.n_clusters, qmax)
        kk = max(k, rerank)
        ids, vals = _ivf_probe_scan(
            q, qmap, slots, valid, self.blocks, self.block_ids, k=kk,
            store=self.store, metric=self.metric, cap=self.cap,
            n_base=self.n_base, gscale=self.gscale)
        if rerank:
            if self.base_f32 is None:
                raise ValueError("rerank needs keep_f32=True at build")
            ids, vals = _ivf_rerank(q, ids, vals, self.base_f32, k=k,
                                    metric=self.metric, n_base=self.n_base)
        elif kk != k:
            ids, vals = ids[:, :k], vals[:, :k]
        return ids, vals

    def search(self, queries, k: int, nprobe: int = 16,
               query_batch: int = 2048, grouped: bool = True,
               device_out: bool = False, rerank: int = 0) -> Tuple:
        """Returns (ids [Q, k] int32, dists [Q, k] f32) as numpy, or as
        tensors on the index's device with ``device_out=True``. Batches of
        ``query_batch`` are zero-padded to full size, as in the JAX package
        (the grouped path's slot budget depends on the batch size)."""
        if self.store == "int8" and not grouped:
            raise ValueError("store='int8' serves via the grouped path")
        q = prepare_vectors(queries, self.metric, self.device)
        nq, d = q.shape
        qb = min(query_batch, nq)
        pad = (-nq) % qb
        if pad:
            q = torch.cat([q, q.new_zeros((pad, d))])
        outs = []
        for s in range(0, nq + pad, qb):
            qs = q[s: s + qb]
            outs.append(self._search_grouped(qs, k, nprobe, rerank=rerank)
                        if grouped else self._search_device(qs, k, nprobe))
        ids = torch.cat([o[0] for o in outs])[:nq]
        dists = torch.cat([o[1] for o in outs])[:nq]
        if device_out:
            return ids, dists
        return ids.cpu().numpy().astype(np.int32), dists.cpu().numpy()

    def free(self):
        """Drop the device tensors (a caller building several large
        structures one after another gets their memory back)."""
        for name in ("blocks", "block_ids", "centroids", "base_f32"):
            setattr(self, name, None)

    def benchmark(self, queries, k: int, nprobe: int = 16,
                  query_batch: int = 2048, warmup: int = 1,
                  rerank: int = 0) -> dict:
        """Timed search over all ``queries``: they are on the device before
        the clock starts; on a CUDA device ``torch.cuda.synchronize()``
        closes the timed region on both sides, and results are copied to
        the host after it."""
        q = prepare_vectors(queries, self.metric, self.device)
        qb = min(query_batch, q.shape[0])
        on_cuda = q.device.type == "cuda"

        def sync():
            if on_cuda:
                torch.cuda.synchronize(q.device)

        for _ in range(warmup):
            self.search(q[:qb], k, nprobe=nprobe, query_batch=qb,
                        device_out=True, rerank=rerank)
        sync()
        t0 = time.perf_counter()
        ids, dists = self.search(q, k, nprobe=nprobe, query_batch=qb,
                                 device_out=True, rerank=rerank)
        sync()
        dt = time.perf_counter() - t0
        return {
            "qps": q.shape[0] / dt,
            "mean_latency_ms": 1000.0 * dt / max(1, -(-q.shape[0] // qb)),
            "avg_cmps": float(nprobe * self.cap + self.n_clusters),
            "avg_hops": float(nprobe),
            "nprobe": nprobe,
            "ids": ids.cpu().numpy().astype(np.int32),
            "dists": dists.cpu().numpy(),
        }


def build_ivf_streaming(tile_fn, n: int, dim: int, *,
                        metric: Metric | str = Metric.IP,
                        n_clusters: int = 0, cap_factor: float = 1.3,
                        kmeans_iters: int = 8,
                        kmeans_sample: int = 2_000_000,
                        tile: int = 1 << 20, seed: int = 0,
                        rows_fn=None, assign_cache: str | None = None,
                        verbose: bool = False) -> "IVFIndex":
    """Build an int8 IVF index WITHOUT a host or f32-resident corpus.

    ``tile_fn(start, size) -> f32 [size, dim] device rows`` is the only view
    of the data (any deterministic shard source); the index lives on the
    device of its tiles. The corpus is streamed three times (k-means
    sample, assignment, int8 fill); nothing bigger than one tile plus the
    int8 blocks lives on the device.

    Tiles are read with clamped full-width windows; ``tile_fn`` must be
    deterministic per (start, size) — overlapping rows are recomputed, and
    re-stored values must agree.

    ``rows_fn(ids int32 [T]) -> f32 [T, dim]`` (random access by id)
    selects the destination-ordered stripe fill: clusters are filled in
    contiguous stripes from their members' rows, instead of scattering
    each tile's rows to their slots. Both place the same bytes in every
    occupied slot.

    ``assign_cache`` (a path prefix) caches the centroids and placement
    under a key of every parameter they depend on; the file is the JAX
    package's, so either package reuses the other's.
    """
    metric = Metric.parse(metric)
    if metric not in (Metric.IP, Metric.COSINE):
        raise ValueError("build_ivf_streaming is int8-only (IP/cosine)")
    if metric == Metric.COSINE:
        # normalize at the stream boundary so k-means, assignment,
        # quantization and rerank all see unit rows — the streamed twin of
        # IVFIndex.__init__'s prepare_vectors(base)
        raw_tile_fn = tile_fn
        tile_fn = lambda s, w: prepare_vectors(raw_tile_fn(s, w), metric)  # noqa: E731
        if rows_fn is not None:
            raw_rows_fn = rows_fn
            rows_fn = lambda ids: prepare_vectors(raw_rows_fn(ids), metric)  # noqa: E731
    t0 = time.perf_counter()
    nc = n_clusters or max(16, int(np.sqrt(n) * 2))
    tile = min(tile, n)

    ck = None
    if assign_cache:
        # every parameter the cached placement/centroids depend on must be
        # in the key, or a changed build silently reuses stale state
        ck = (f"{assign_cache}.ivfassign_{n}_{dim}_{nc}_{kmeans_iters}_"
              f"{seed}_{metric.name.lower()}_{cap_factor:g}_"
              f"{min(kmeans_sample, n)}.npz")
    if ck and os.path.exists(ck):
        with np.load(ck) as z:
            centroids, slot_cluster, slot_pos, gmax = (
                z["centroids"], z["slot_cluster"], z["slot_pos"],
                float(z["gmax"]))
        cap = int(slot_pos.max()) + 1
        dev = tile_fn(0, 1).device
        if verbose:
            print(f"ivf-streaming: assignment cache hit ({ck})",
                  file=sys.stderr, flush=True)
    else:
        samp = tile_fn(0, min(kmeans_sample, n))  # rows i.i.d. by design
        dev = samp.device
        centroids = _kmeans(samp, nc, metric, kmeans_iters, seed)
        del samp
        if verbose:
            print(f"ivf-streaming: kmeans {nc} clusters in "
                  f"{time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)

        kk = min(8, nc)
        c_dev = torch.from_numpy(centroids).to(dev)
        cand = np.empty((n, kk), np.int32)
        gmax = 0.0
        # bound the [rows, nc] f32 distance block: sub-chunk the assignment
        # to a power-of-two row count of at most ~3 GB
        sub = 1 << max(13, int(np.log2(max(1, (3 << 30) // (4 * nc)))))
        sub = min(sub, tile)
        for s in range(0, n, tile):
            st = min(s, n - tile)
            rows = tile_fn(st, tile)
            for ss in range(0, tile, sub):
                _, ii = exact_knn_device(rows[ss: ss + sub], c_dev, k=kk,
                                         metric=metric, tile=nc)
                cand[st + ss: st + ss + ii.shape[0]] = ii.cpu().numpy()
            gmax = max(gmax, float(torch.abs(rows).max()))
        cap0 = int(np.ceil(n / nc * cap_factor))
        slot_cluster, slot_pos, cap = _capacity_place(cand, nc, cap0)
        del cand
        if ck:
            np.savez(ck, centroids=centroids, slot_cluster=slot_cluster,
                     slot_pos=slot_pos, gmax=gmax)
    cap = -(-cap // 32) * 32  # round rows up as the JAX package does
    gscale = 127.0 / max(gmax, 1e-30)
    if verbose:
        print(f"ivf-streaming: assigned, cap {cap} "
              f"(waste {nc * cap / n:.2f}x) at "
              f"{time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)

    slot_pos = slot_pos.astype(np.int64)
    tbl = torch.zeros((nc, cap, dim), dtype=torch.int8, device=dev)
    block_ids = np.full((nc, cap), n, np.int32)
    block_ids[slot_cluster, slot_pos] = np.arange(n, dtype=np.int32)
    if rows_fn is not None:
        # destination-ordered stripe fill: walk clusters in contiguous
        # stripes, generate each stripe's member rows BY ID, store them in
        # place. Sentinel (empty) slots get a clamped row — block_ids >= n
        # masks them at search.
        fill_ids = np.minimum(block_ids, n - 1).astype(np.int32)
        cs = min(nc, max(1, tile // cap))
        for c in range(0, nc, cs):
            c0 = min(c, nc - cs)                # one stripe shape
            ids_dev = torch.from_numpy(
                fill_ids[c0: c0 + cs].reshape(-1)).to(dev)
            tbl[c0: c0 + cs] = _quantize(rows_fn(ids_dev), gscale).reshape(
                cs, cap, dim)
    else:
        for s in range(0, n, tile):
            st = min(s, n - tile)
            rows = tile_fn(st, tile)
            cl = torch.from_numpy(slot_cluster[st: st + tile]).to(dev).long()
            pos = torch.from_numpy(slot_pos[st: st + tile]).to(dev)
            tbl[cl, pos] = _quantize(rows, gscale)
    idx = IVFIndex.from_parts(centroids, tbl, block_ids, n_base=n,
                              metric=metric, gscale=gscale, device=dev)
    if verbose:
        print(f"ivf-streaming: built in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
    return idx
