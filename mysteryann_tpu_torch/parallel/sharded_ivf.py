"""mp-sharded IVF: cluster blocks row-sharded over the mesh.

Port of ``mysteryann_tpu/parallel/sharded_ivf.py``. Past ~60M rows even
int8 cluster blocks outgrow one card. Sharding plan:

- CLUSTER axis over ``mp``: each rank owns nc/mp clusters' blocks and ids.
  Centroids are small and replicated, so every mp peer computes the SAME
  global top-``nprobe`` probe list; each keeps the probes it owns
  (off-shard probes map to the sentinel cluster and are dropped by
  ``ivf._ivf_group``), scans them with the single-device cluster-major scan
  (its block fetch is the row gather K1), and merges its local candidates.
- One all-gather of [B, k] ids and scores per batch over ``mp`` finishes
  the global top-k. Vectors never leave their rank.
- Queries shard over ``dp`` (throughput, no communication).

int8: per-query scales make raw s32 scores comparable ACROSS mp peers for
the same query (one global base scale), so the gathered merge needs no
rescaling — the invariant the single-device grouped scan relies on.
"""

from __future__ import annotations

import numpy as np
import torch

from mysteryann_tpu_torch.ivf import (IVFIndex, _ivf_group,
                                      _ivf_probe_scan, _ivf_topc)
from mysteryann_tpu_torch.ops.distances import prepare_vectors
from mysteryann_tpu_torch.ops.sort import topk_smallest
from mysteryann_tpu_torch.parallel.mesh import Mesh, all_gather, shard_sizes


class ShardedIVF:
    """Shard an `IVFIndex`'s cluster blocks over the mesh's ``mp`` axis.

    The cluster count is padded to a multiple of ``mp`` with empty clusters
    (zero blocks, sentinel ids; their centroids are never probed), so every
    shard has the same shape. The index may live on any device (the CPU
    too); each rank keeps only its clusters, on its own device.
    """

    def __init__(self, mesh: Mesh, idx: IVFIndex):
        self.mesh = mesh
        self.metric = idx.metric
        self.store = idx.store
        self.gscale = idx.gscale
        self.n_base = idx.n_base
        self.cap = idx.cap
        self.dim = idx.dim
        mp = mesh.shape["mp"]
        nc = idx.n_clusters
        self.nc_real = nc
        self.n_clusters = nc + (-nc) % mp
        self.nc_local = self.n_clusters // mp
        self.lo = mesh.coord("mp") * self.nc_local
        dev = mesh.device
        real = slice(min(self.lo, nc), min(self.lo + self.nc_local, nc))
        blocks = idx.blocks[real].to(dev)
        bids = idx.block_ids[real].to(dev)
        pad = self.nc_local - blocks.shape[0]
        if pad:
            blocks = torch.cat([blocks, blocks.new_zeros(
                (pad,) + blocks.shape[1:])])
            bids = torch.cat([bids, bids.new_full((pad, self.cap),
                                                  self.n_base)])
        self.blocks = blocks.contiguous()
        self.block_ids = bids.contiguous()
        self.centroids = idx.centroids.to(dev)

    def search(self, queries, k: int, nprobe: int,
               device_out: bool = False):
        """This rank's dp shard of the queries → (ids [B/dp, k] int32,
        dists [B/dp, k]) over all shards' clusters; numpy unless
        ``device_out``. Every rank of the mesh calls it."""
        if nprobe > self.nc_real:
            raise ValueError(f"nprobe {nprobe} > clusters {self.nc_real}")
        q = prepare_vectors(queries, self.metric, self.mesh.device)
        b_local = q.shape[0]
        rows = shard_sizes(self.mesh, b_local, "dp")
        if len(set(rows)) > 1:
            raise ValueError(f"B ({sum(rows)}) must divide dp "
                             f"({self.mesh.shape['dp']})")
        # every probe picks one of the GLOBAL clusters, so a local
        # cluster's expected load is b_local*nprobe/nc_pad, as in the JAX
        # package (the slot rule of ivf.IVFIndex._search_grouped)
        avg_load = max(1, b_local * nprobe // max(1, self.n_clusters))
        qmax = 1 << int(np.ceil(np.log2(4 * avg_load)))
        # identical on every mp peer: the global probe list over the real
        # clusters; probes another shard owns go to the sentinel cluster
        top_c = _ivf_topc(q, self.centroids, nprobe, self.metric)
        nl = self.nc_local
        mine = (top_c >= self.lo) & (top_c < self.lo + nl)
        qmap, slots, valid = _ivf_group(
            torch.where(mine, top_c - self.lo, nl), nl, qmax)
        ids, vals = _ivf_probe_scan(
            q, qmap, slots, valid, self.blocks, self.block_ids, k=k,
            store=self.store, metric=self.metric, cap=self.cap,
            n_base=self.n_base, gscale=self.gscale)
        # the cross-shard merge: [Bl, mp·k] ids and scores, shard-major
        gi = all_gather(ids, self.mesh, "mp", dim=1)
        gv = all_gather(vals, self.mesh, "mp", dim=1)
        vals, pos = topk_smallest(gv, k)
        ids = gi.gather(1, pos).to(torch.int32)
        if device_out:
            return ids, vals
        return ids.cpu().numpy(), vals.cpu().numpy()
