"""RoarGraph construction — batched, in PyTorch.

Port of ``mysteryann_tpu/graph/roargraph.py``, which reproduces the
reference build (`BuildRoarGraph`/`LinkProjection`, reference
src/index_bipartite.cpp:143-233, 1043-1277) with a dense batched design:

Phase A (projection, :1059-1097): each training query's kNN list (truncated
to ``M_sq``) is projected onto its top-1 base point; the remaining list
members, with distances measured *to that target*, pass the occlusion prune
and become the target's out-edges. Queries sharing a target race in the
reference (last writer wins, :1088-1091); here the lowest-index query wins,
deterministically.

Phase B (reverse edges, :1100-1104) + Phase C (degree repair, :1107-1136):
for every forward edge u→v, v collects u as a reverse candidate; a node
whose forward+reverse candidates exceed ``M_pjbp`` is re-pruned once over
its full candidate set.

Phase D (connectivity enhancement, :1183-1269): every base node greedy-
searches the supply graph from the medoid entry point with queue length
``L_pjpq``; the search history is pruned (no fill pass, the seed must not
already be a projection neighbour) into fresh supply out-edges; reverse
supply edges are capped at ``2*M_pjbp`` inserts and overflow-pruned back to
``M_pjbp``; finally up to ``2*M_pjbp`` novel supply edges are appended to
each projection list (:1251-1269). Final degree ≤ ``2*M_pjbp``.

Phase E: nodes unreachable from the entry point are attached to their
nearest reachable nodes.

Entry point: the medoid — argmin squared-L2 to the base centroid,
regardless of metric (CalculateProjectionep:2004-2041).

What the port takes: both phase-D engines — classic (the f32 lockstep
beam) and fused (quantized neighbour-block byte rows, search/fused.py) —
and persistence through the native host library (``native``, g++-built at
first use) with the numpy path as its plain version (byte-identical files
either way).

Memory: `_build_memory_plan` reckons, from the corpus shape and the total
memory of the device the base lives on, what a build holds at once, and
chooses two things by it — the phase-D engine that ``"auto"`` stands for,
and whether the build runs its bounded-memory paths: host reverse
aggregation in phase B+C, the fold in row slabs (`_fold_own_rows`,
`_fold_slab`, `_rev_rows_for_ids`), the projection kept on the host with
per-batch uploads, and a slabbed tail with the pass's result on the host.
Each of those is bit-identical to the path it replaces, so a graph never
depends on the plan; only memory and time do. On a CPU device the plan
keeps the JAX package's fixed thresholds.

Tensors are updated in place where the JAX package donated its buffers;
the supply graph is a fresh copy that never aliases the projection it
starts from. Every row of every batched step is independent of the other
rows, so batches are cut to whatever size fits and never padded.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import os
import struct
import sys
import time as _time
from typing import Optional

import numpy as np
import torch

from mysteryann_tpu_torch import native
from mysteryann_tpu_torch.graph.adjacency import (PaddedGraph, ragged_row_starts,
                                                  ragged_to_padded, ragged_words)
from mysteryann_tpu_torch.graph.prune import batched_occlusion_prune, dists_to_src
from mysteryann_tpu_torch.index import register_index
from mysteryann_tpu_torch.ops.distances import Metric, prepare_vectors
from mysteryann_tpu_torch.ops.gather import gather_rows_any
from mysteryann_tpu_torch.ops.sort import sort_multi
from mysteryann_tpu_torch.search.beam import beam_search
from mysteryann_tpu_torch.search.fused import (_fused_beam, _pack_chunk,
                                               _row_bytes,
                                               pack_neighbor_table)
from mysteryann_tpu_torch.search.seeding import make_seed_sample, seed_scan
from mysteryann_tpu_torch.utils.params import BuildConfig
from mysteryann_tpu_torch.utils.timers import Timer, device_sync
from mysteryann_tpu_torch.utils.trace import tracer

_I32 = torch.int32


# --------------------------------------------------------------------------
# index container + persistence
# --------------------------------------------------------------------------


@dataclasses.dataclass
@register_index("roargraph")
class RoarGraphIndex:
    graph: PaddedGraph
    metric: Metric
    dim: int

    def save(self, path: str) -> None:
        """Reference-compatible projection graph file + JSON sidecar.

        Binary layout identical to SaveProjectionGraph (reference
        src/index_bipartite.cpp:2606-2619): ``[ep u32][npts u32]`` then per
        node ``[deg u32][ids u32…]``. Byte-identical to the JAX package's.
        """
        save_projection_graph(path, self.graph)
        with open(path + ".meta.json", "w") as f:
            json.dump({"metric": self.metric.value, "dim": self.dim,
                       "max_degree": self.graph.max_degree}, f)

    @classmethod
    def load(cls, path: str, metric: Metric | str | None = None,
             dim: int = 0) -> "RoarGraphIndex":
        meta = {}
        if os.path.exists(path + ".meta.json"):
            with open(path + ".meta.json") as f:
                meta = json.load(f)
        g = load_projection_graph(path, m_pad=meta.get("max_degree"))
        m = Metric.parse(metric or meta.get("metric", "ip"))
        return cls(graph=g, metric=m, dim=int(meta.get("dim", dim)))

    @classmethod
    def from_numpy(cls, neighbors: np.ndarray, ep: int,
                   metric: Metric | str, dim: int) -> "RoarGraphIndex":
        """An index from the JAX package's ``PaddedGraph`` arrays
        (``neighbors`` int32 [N, M_pad], sentinel N; entry point ``ep``)."""
        nb = np.ascontiguousarray(neighbors, np.int32)
        return cls(graph=PaddedGraph(neighbors=nb, ep=int(ep)),
                   metric=Metric.parse(metric), dim=int(dim))


def save_projection_graph(path: str, g: PaddedGraph) -> None:
    """Write ``g`` in the reference's projection format, through the native
    library when it loads (``native.lib()``), else `save_projection_graph_ref`.
    Both write the same bytes."""
    L = native.lib()
    if L is None:
        save_projection_graph_ref(path, g)
        return
    nb = np.ascontiguousarray(g.neighbors, np.int32)
    rc = L.msann_save_projection(path.encode(), g.ep, g.n_nodes,
                                 native.ptr_i32(nb), nb.shape[1])
    if rc != 0:
        raise OSError(f"native save failed ({rc}) for {path}")
    native.note("native")


def save_projection_graph_ref(path: str, g: PaddedGraph) -> None:
    """The plain version: the ``[deg, ids…]`` word stream assembled in one
    numpy array instead of 2 Python calls per node."""
    with open(path, "wb") as f:
        f.write(struct.pack("<II", g.ep, g.n_nodes))
        ragged_words(g.neighbors, g.n_nodes).tofile(f)
    native.note("python")


def load_projection_graph(path: str, m_pad: Optional[int] = None) -> PaddedGraph:
    """Read a projection graph file (rows wider than ``m_pad`` truncated),
    through the native library when it loads, else
    `load_projection_graph_ref`. Trailing bytes raise ``ValueError``."""
    L = native.lib()
    if L is None:
        return load_projection_graph_ref(path, m_pad)
    ep, n, md = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32()
    words = ctypes.c_int64()
    rc = L.msann_scan_projection(path.encode(), ctypes.byref(ep),
                                 ctypes.byref(n), ctypes.byref(md),
                                 ctypes.byref(words))
    if rc == native.EINVAL:
        raise ValueError(f"{path}: trailing bytes in projection graph file")
    if rc != 0:
        raise OSError(f"native scan failed ({rc}) for {path}")
    nb = np.empty((n.value, m_pad or max(int(md.value), 1)), np.int32)
    rc = L.msann_load_projection(path.encode(), native.ptr_i32(nb), n.value,
                                 nb.shape[1])
    if rc != 0:
        raise OSError(f"native load failed ({rc}) for {path}")
    native.note("native")
    return PaddedGraph(neighbors=nb, ep=int(ep.value))


def load_projection_graph_ref(path: str,
                              m_pad: Optional[int] = None) -> PaddedGraph:
    """The plain version: a Python walk over the row starts, then the
    degree extraction and id placement vectorized."""
    with open(path, "rb") as f:
        ep, n = struct.unpack("<II", f.read(8))
        payload = np.fromfile(f, dtype=np.uint32)
    starts, off = ragged_row_starts(payload, n)
    if starts.size != n:
        raise ValueError(f"{path}: truncated projection graph file "
                         f"({starts.size} of {n} rows)")
    if off != payload.size:
        raise ValueError(f"{path}: trailing bytes in projection graph file")
    native.note("python")
    return PaddedGraph(neighbors=ragged_to_padded(payload, starts, n, m_pad),
                       ep=int(ep))


def load_nsg_graph(path: str, n_nodes: int = 0,
                   m_pad: Optional[int] = None) -> PaddedGraph:
    """Import an NSG-format graph: ``[width u32][ep u32]`` then per node
    ``[deg u32][ids…]`` (reference LoadNsgGraph,
    src/index_bipartite.cpp:2073-2095 — which hardcodes npts=1,000,000;
    here ``n_nodes=0`` means read until EOF)."""
    with open(path, "rb") as f:
        _width, ep = struct.unpack("<II", f.read(8))
        payload = np.fromfile(f, dtype=np.uint32)
    starts, _ = ragged_row_starts(payload, n_nodes or None)
    if n_nodes and starts.size != n_nodes:
        raise ValueError(f"{path}: expected {n_nodes} nodes, "
                         f"parsed {starts.size}")
    n = starts.size
    return PaddedGraph(neighbors=ragged_to_padded(payload, starts, n, m_pad),
                       ep=int(ep))


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------


class _BuildCheckpoint:
    """Phase-level build checkpointing (absent in the reference).

    ``fingerprint`` guards resume correctness: phase outputs depend on
    the build config and input shapes, so checkpoints written under a
    different fingerprint are discarded instead of silently resumed.
    """

    def __init__(self, directory: Optional[str],
                 fingerprint: Optional[dict] = None):
        self.dir = directory
        if directory:
            os.makedirs(directory, exist_ok=True)
            if fingerprint is not None:
                meta_path = os.path.join(directory, "build_meta.json")
                old = None
                if os.path.exists(meta_path):
                    try:
                        with open(meta_path) as f:
                            old = json.load(f)
                    except (OSError, ValueError):
                        old = None
                if old != fingerprint:
                    for f in os.listdir(directory):
                        if f.startswith("build_") and f.endswith(".npy"):
                            os.remove(os.path.join(directory, f))
                    with open(meta_path, "w") as f:
                        json.dump(fingerprint, f)

    def _path(self, phase: str) -> str:
        return os.path.join(self.dir, f"build_{phase}.npy")

    def load(self, phase: str) -> Optional[np.ndarray]:
        if not self.dir or not os.path.exists(self._path(phase)):
            return None
        return np.load(self._path(phase))

    def save(self, phase: str, arr) -> None:
        if not self.dir:
            return
        if isinstance(arr, torch.Tensor):
            arr = arr.cpu().numpy()
        tmp = self._path(phase) + ".tmp.npy"
        np.save(tmp, arr)
        os.replace(tmp, self._path(phase))

    def clean_prefix(self, prefix: str) -> None:
        if not self.dir:
            return
        for f in os.listdir(self.dir):
            if f.startswith(f"build_{prefix}") and f.endswith(".npy"):
                os.remove(os.path.join(self.dir, f))


def _to_dev(x, device: torch.device, dtype=_I32) -> torch.Tensor:
    """numpy or tensor → contiguous tensor of ``dtype`` on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x.to(device=device, dtype=dtype).contiguous()


def compute_medoid(base: torch.Tensor) -> int:
    """argmin_i ||base_i - centroid||² (reference CalculateProjectionep)."""
    c = torch.mean(base, dim=0, keepdim=True)
    d = (torch.sum(base * base, dim=1) - 2.0 * (base @ c[0])
         + torch.sum(c * c))
    return int(torch.argmin(d))


def _aggregate_reverse(e_src: np.ndarray, e_dst: np.ndarray,
                       e_dist: np.ndarray, n: int, r_max: int) -> np.ndarray:
    """Group reverse edges by destination, closest-first, into a
    sentinel(n)-padded int32 [n, r_max], on the host: the bounded-memory
    twin of `_aggregate_reverse_device` (np.lexsort is stable, as the
    device sort is, so the two agree bit for bit)."""
    order = np.lexsort((e_dist, e_dst))
    ds, ss = e_dst[order], e_src[order]
    counts = np.bincount(ds, minlength=n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    rank = np.arange(ds.size, dtype=np.int64) - offsets[ds]
    keep = rank < r_max
    out = np.full((n, r_max), n, np.int32)
    out[ds[keep], rank[keep]] = ss[keep]
    return out


def _aggregate_reverse_device(e_src, e_dst, e_dist, n: int, r_max: int):
    """Group reverse edges by destination, closest-first, into a
    sentinel(n)-padded int32 [n, r_max]: a (dst, dist)-stable sort, ranks
    within each destination's run, scatter of the first ``r_max``."""
    E = e_src.shape[0]
    ds, _, ss = sort_multi((e_dst.to(_I32), e_dist, e_src.to(_I32)),
                           num_keys=2)
    dev = ds.device
    arrival = torch.arange(E, dtype=_I32, device=dev)
    is_start = torch.ones(E, dtype=torch.bool, device=dev)
    is_start[1:] = ds[1:] != ds[:-1]
    seg_start = torch.cummax(torch.where(is_start, arrival, 0), dim=0).values
    rank = arrival - seg_start
    keep = (ds < n) & (rank < r_max)
    rev = torch.full((n + 1, r_max), n, dtype=_I32, device=dev)
    # rejected entries all land in the dropped row n
    rev[torch.where(keep, ds, n).long(), torch.where(keep, rank, 0).long()] = \
        torch.where(keep, ss, n)
    return rev[:n]


def _batched_prune_rows(
    base_dev: torch.Tensor,
    node_ids,                    # [K] rows to prune (numpy or tensor)
    cand,                        # [K, C] candidate ids (sentinel n)
    cap: int,
    metric: Metric,
    batch: int,
    fill: bool,
    not_seedable=None,           # [K, C] bool
    two_pass: bool = False,
    gather_fn=None,
    n_base: int = 0,
) -> torch.Tensor:
    """Run the occlusion prune over row batches; returns [K, cap] ids on
    ``base_dev``'s device. ``gather_fn`` (flat ids → vectors) and
    ``n_base`` stand in for a ``base_dev`` of None, as in
    `batched_occlusion_prune`; ``cand`` is then a tensor on the device."""
    dev = base_dev.device if base_dev is not None else cand.device
    gather = gather_fn or functools.partial(gather_rows_any, base_dev)
    node_ids = _to_dev(node_ids, dev)
    cand = _to_dev(cand, dev)
    if not_seedable is not None:
        not_seedable = _to_dev(not_seedable, dev, torch.bool)
    k_rows = node_ids.shape[0]
    if k_rows == 0:
        return torch.empty((0, min(cap, cand.shape[1])), dtype=_I32,
                           device=dev)
    batch = max(1, min(batch, k_rows))
    outs = []
    for s in range(0, k_rows, batch):
        ids_b = node_ids[s: s + batch]
        cand_b = cand[s: s + batch]
        ns_b = None if not_seedable is None else not_seedable[s: s + batch]
        src_vecs = gather(ids_b)
        # return_vecs: reuse the candidate rows in the prune instead of
        # gathering them a second time
        cd, cv = dists_to_src(src_vecs, cand_b, base_dev, metric,
                              return_vecs=True, gather_fn=gather_fn,
                              n_base=n_base)
        pruned, _ = batched_occlusion_prune(
            src_vecs, ids_b, cand_b, cd, base_dev, cap=cap, metric=metric,
            fill=fill, not_seedable=ns_b, two_pass=two_pass, cand_vecs=cv,
            gather_fn=gather_fn, n_base=n_base)
        outs.append(pruned)
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _budget_row_bytes(M: int, d: int, bits: int = 8) -> int:
    """The JAX package's fused table row size — this package's row padded
    to a multiple of 1 KB for the TPU's DMA tiling. Read only by the CPU
    branch of `_build_memory_plan`, so that on the CPU "auto" resolves as
    in the JAX package."""
    return -(-_row_bytes(M, d, bits) // 1024) * 1024


# share of a device's total memory that the build's resident tensors may
# take; the rest is the working set of a search / prune batch (the prune
# alone takes up to 1/8 of what is free), the packer's block temporaries
# and the allocator's fragmentation
_RESIDENT_SHARE = 0.8


@dataclasses.dataclass(frozen=True)
class BuildMemoryPlan:
    """What `_build_memory_plan` chose: ``engine`` is the phase-D engine
    ("auto" resolved), ``large`` says whether the bounded-memory paths run,
    ``slab_rows`` is the fold's slab height under ``large``, ``memory`` is
    the device memory reckoned against (None: the CPU's fixed thresholds)
    and ``bytes`` holds the terms of the sum."""
    engine: str
    large: bool
    slab_rows: int
    memory: Optional[int]
    bytes: dict

    @property
    def fold(self) -> str:
        return "slab" if self.large else "single"


def device_memory(device: torch.device) -> Optional[int]:
    """The memory a build on ``device`` is planned against: a CUDA device's
    total memory (not what is free at the moment: the same card then plans
    the same build), else None (a CPU device: the JAX package's
    thresholds)."""
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return None


def _build_memory_plan(cfg, n: int, d: int,
                       mem: Optional[int] = None) -> BuildMemoryPlan:
    """Choose the phase-D engine and the fold path for corpus (n, d) on a
    device with ``mem`` bytes in total — one shared rule, so the
    checkpoint tag and the pass itself cannot disagree.

    With M = cfg.M_pjbp, W = 2M (the supply width) and int32 ids, phase D
    on the single-fold path holds at once

        base          4·n·d
        supply        4·n·W
        projection    4·n·W      (it is [n, 2M] between passes)
        fold scratch  2·4·n·W    (the [n, W] reverse lists and as much
                                  again for the edge sort and the merge)
      and, fused engine only,
        table         (n + 1)·(w16·d·bits/8 + 8·w16),  w16 = ⌈W/16⌉·16
        snapshot      4·n·W      (the supply the table was packed from)

    against ``_RESIDENT_SHARE`` (0.8) of ``mem``. The bounded-memory
    paths keep the projection on the host and cut the fold scratch to
    2·4·slab_rows·W, with the slab scratch held to mem/32; ``large`` is
    set when the single-fold sum of the chosen engine does not fit.
    "auto" is fused when the dims sit on the byte-row boundary and the
    fused sum fits at least on the bounded-memory paths, else classic.
    At n = 4M, d = 128, M = 32, bits 4 the terms are 2.05 + 1.02 + 1.02 +
    2.05 GB and 18.43 + 1.02 GB: 25.6 GB, fused and single fold on an
    80 GB card, classic on a 16 GB one.

    ``mem=None`` (a CPU device) keeps the JAX package's fixed rule — fused
    when its 1 KB-padded table is within 10 GB, the bounded-memory paths
    from 4M rows — so that both packages choose alike where they are
    compared.
    """
    M = cfg.M_pjbp
    W = 2 * M
    bits = cfg.connectivity_bits
    w16 = -(-W // 16) * 16
    dims_ok = d % (8 if bits == 8 else 16) == 0
    b = {"base": 4 * n * d, "supply": 4 * n * W, "projection": 4 * n * W,
         "fold_scratch": 8 * n * W,
         "table": (n + 1) * _row_bytes(w16, d, bits),
         "table_snapshot": 4 * n * W}
    engine = cfg.connectivity_engine
    if mem is None:
        if engine == "auto":
            engine = ("fused" if dims_ok and (n + 1) * _budget_row_bytes(
                w16, d, bits) <= 10e9 else "classic")
        n_slabs = max(2, -(-b["fold_scratch"] // (26 * 10 ** 8)))
        return BuildMemoryPlan(engine, n >= 4_000_000, -(-n // n_slabs),
                               None, b)
    budget = int(_RESIDENT_SHARE * mem)
    n_slabs = max(2, -(-b["fold_scratch"] // max(1, mem // 32)))
    slab_rows = min(n, max(1024, -(-n // n_slabs)))
    b["slab_scratch"] = 8 * slab_rows * W
    single = {"classic": b["base"] + b["supply"] + b["projection"]
              + b["fold_scratch"]}
    single["fused"] = single["classic"] + b["table"] + b["table_snapshot"]
    bounded = {e: v - b["projection"] - b["fold_scratch"] + b["slab_scratch"]
               for e, v in single.items()}
    if engine == "auto":
        engine = ("fused" if dims_ok and bounded["fused"] <= budget
                  else "classic")
    b["resident_single"] = single[engine]
    b["resident_bounded"] = bounded[engine]
    b["budget"] = budget
    return BuildMemoryPlan(engine, single[engine] > budget, slab_rows,
                           int(mem), b)


def _resolve_engine(cfg, n: int, d: int, mem: Optional[int] = None) -> str:
    """``cfg.connectivity_engine`` with "auto" resolved for corpus (n, d)
    on a device of ``mem`` bytes (`_build_memory_plan`)."""
    return _build_memory_plan(cfg, n, d, mem).engine


def _rounds_for_pass(cfg, pass_i: int) -> int:
    """Connectivity rounds for phase-D pass ``pass_i`` (0-based): pass 1
    runs the full incremental schedule; later passes search an already
    converged graph and default to a quarter of the rounds (min 2)."""
    r0 = cfg.connectivity_iters or 16
    if pass_i == 0:
        return r0
    return cfg.connectivity_iters_later or max(2, r0 // 4)


def _phase_d_knob_tag(cfg, n: int, d: int,
                      mem: Optional[int] = None) -> str:
    """Phase-D checkpoint tag suffix: every knob that changes phase-D
    outputs (the knobs are fingerprint-neutral so phases A-C survive a
    knob change; see build_roargraph)."""
    engine = _resolve_engine(cfg, n, d, mem)
    t = (f"{engine}_e{cfg.connectivity_expand}"
         f"i{cfg.connectivity_iters}j{_rounds_for_pass(cfg, 1)}"
         f"h{cfg.history_mult}")
    if engine == "fused":
        t += f"b{cfg.connectivity_bits}"
        if cfg.connectivity_seeds:
            t += f"s{cfg.connectivity_seeds}r{cfg.connectivity_seed_sample}"
    return t


def _merge_fr_block(own_b: torch.Tensor, rev_b: torch.Tensor, n: int,
                    cap: int):
    """One row block of the forward∪reverse merge.

    Reverse entries already present in the own list are dropped; valid
    entries compact left in own-then-reverse, position-stable order (the
    reference's push_back-without-prune insertion). Returns
    (merged [bs, cap], total [bs] = valid count after dedup)."""
    A = own_b.shape[1]
    R = rev_b.shape[1]
    C = A + R
    dev = own_b.device
    dup = (rev_b[:, :, None] == own_b[:, None, :]).any(dim=2)
    posA = torch.arange(A, dtype=_I32, device=dev)
    posR = torch.arange(R, dtype=_I32, device=dev)
    own_key = torch.where(own_b < n, posA, 2 * C + posA)
    rev_key = torch.where((rev_b < n) & ~dup, A + posR, 3 * C + posR)
    k_s, v_s = sort_multi((torch.cat([own_key, rev_key], dim=1),
                           torch.cat([own_b, rev_b], dim=1)), num_keys=1)
    merged = torch.where(k_s[:, :cap] < 2 * C, v_s[:, :cap], n)
    total = (torch.sum(own_b < n, dim=1, dtype=_I32)
             + torch.sum((rev_b < n) & ~dup, dim=1, dtype=_I32))
    return merged, total


def _block_rows(n: int, per_row_bytes: int, budget: int = 1 << 29) -> int:
    """Rows per block so that a block's broadcast temporaries stay near
    ``budget`` bytes."""
    return max(1024, min(n, budget // max(1, per_row_bytes)))


def _merge_forward_reverse(
    base_dev: torch.Tensor,
    own: torch.Tensor,      # [N, A] current lists (sentinel-padded)
    rev: torch.Tensor,      # [N, R] reverse candidates (sentinel-padded)
    cap: int,
    metric: Metric,
    batch: int,
    fill: bool,
    prune_rows=None,
) -> torch.Tensor:
    """Per node: own ∪ reverse; prune to ``cap`` when above it.

    Nodes at or under ``cap`` keep own-then-reverse order (reference
    push_back without prune); overfull nodes go through the batched
    occlusion prune over their full dedup'd candidate list.
    ``prune_rows``: `_batched_prune_rows` past its ``base_dev`` argument
    (the default, over ``base_dev``) or the sharded build's
    ``sharded_prune_rows`` past its mesh and base shard."""
    prune_rows = prune_rows or functools.partial(_batched_prune_rows, base_dev)
    n, A = own.shape
    R = rev.shape[1]
    bs = _block_rows(n, R * A)
    merged = torch.empty((n, cap), dtype=_I32, device=own.device)
    total = torch.empty(n, dtype=_I32, device=own.device)
    for s in range(0, n, bs):
        merged[s: s + bs], total[s: s + bs] = _merge_fr_block(
            own[s: s + bs], rev[s: s + bs], n=n, cap=cap)
    hard = torch.nonzero(total > cap)[:, 0].to(_I32)
    OB = 1 << 15
    for s in range(0, hard.shape[0], OB):
        ids = hard[s: s + OB]
        own_r = gather_rows_any(own, ids)
        rev_r = gather_rows_any(rev, ids)
        dup = (rev_r[:, :, None] == own_r[:, None, :]).any(dim=2)
        cand_b = torch.cat([own_r, torch.where(dup, n, rev_r)], dim=1)
        merged[ids.long()] = prune_rows(ids, cand_b, cap, metric, batch,
                                        fill)
    return merged


# --------------------------------------------------------------------------
# the build
# --------------------------------------------------------------------------


def _digest(a) -> str:
    """Cheap content digest for the checkpoint fingerprint: 64 probe rows
    and row 0, summed in numpy, so host and device inputs agree."""
    step = max(1, a.shape[0] // 64)
    idx = np.arange(0, a.shape[0], step, dtype=np.int64)[:64]
    if isinstance(a, torch.Tensor):
        probe = a[torch.from_numpy(idx).to(a.device)].cpu().numpy()
        row0 = a[0].cpu().numpy()
    else:
        probe = np.asarray(a[idx])
        row0 = np.asarray(a[0])
    return f"{float(np.sum(probe)):.6e}/{float(np.sum(np.abs(row0))):.6e}"


def build_roargraph(
    base,
    train_queries: np.ndarray,
    learn_base_knn: np.ndarray,
    cfg: BuildConfig = BuildConfig(),
    verbose: bool = True,
    checkpoint_dir: str | None = None,
    device: torch.device | str | None = None,
) -> RoarGraphIndex:
    """Build the RoarGraph projection index on ``device`` (default:
    ``base``'s device for a tensor, else the card; ``device="cpu"`` runs on
    the CPU).

    The build is planned from the device's memory (`_build_memory_plan`:
    what "auto" stands for, single or slab fold). The graph does not depend
    on the fold path; it does depend on the engine.

    `learn_base_knn` is the exact train-query→base kNN ([Nq, K] ids,
    K ≥ cfg.M_sq) — produce it with `ops.knn.exact_knn`.

    `checkpoint_dir`: phase outputs are saved there and a rerun resumes
    from the last completed phase (the reference's build has no resume).
    """
    t_build0 = _time.perf_counter()
    metric = Metric.parse(cfg.metric)
    M = cfg.M_pjbp
    n = base.shape[0]
    nq = train_queries.shape[0]
    # progress goes to stderr: stdout belongs to callers
    log = (functools.partial(print, file=sys.stderr, flush=True)
           if verbose else (lambda *a, **k: None))

    base_dev = prepare_vectors(base, metric, device)  # normalized if cosine
    dev = base_dev.device
    plan = _build_memory_plan(cfg, n, base.shape[1], device_memory(dev))
    knobs = _phase_d_knob_tag(cfg, n, base.shape[1], plan.memory)
    log(f"memory plan: engine {plan.engine}, {plan.fold} fold"
        + (f" ({plan.slab_rows} rows a slab)" if plan.large else "")
        + (f", single-fold sum {plan.bytes['resident_single'] / 1e9:.2f} GB "
           f"against {plan.bytes['budget'] / 1e9:.2f} GB"
           if plan.memory is not None else ", fixed thresholds"))
    knn = np.asarray(learn_base_knn[:, : cfg.M_sq], np.int64)

    # fingerprint-NEUTRAL knobs: connectivity_passes (pass p's checkpoint
    # is identical whatever the total pass count), the batching sizes
    # (they change how work is chunked, never the per-row results) and
    # the phase-D-only knobs, which go into the phase-D checkpoint TAG
    cfg_fp = dataclasses.asdict(cfg)
    for neutral in ("connectivity_passes", "query_batch", "search_batch",
                    "connectivity_engine", "connectivity_expand",
                    "connectivity_bits", "connectivity_seeds",
                    "connectivity_seed_sample", "connectivity_iters",
                    "connectivity_iters_later", "history_mult"):
        cfg_fp.pop(neutral, None)
    ckpt = _BuildCheckpoint(checkpoint_dir, fingerprint={
        "cfg": cfg_fp, "n": int(n), "nq": int(nq),
        "dim": int(base.shape[1]),
        "base": _digest(base), "queries": _digest(train_queries),
        "knn": _digest(learn_base_knn)})
    log(f"setup (staging + fingerprint): "
        f"{_time.perf_counter() - t_build0:.1f}s")

    # each phase ends with the device's queued work done, so its time is
    # the work it bounds
    dev_sync = device_sync(dev)
    with Timer("medoid", sync=dev_sync) as t_med:
        ep_st = ckpt.load("medoid")
        if ep_st is not None:
            ep = int(ep_st[0])
        else:
            ep = compute_medoid(base_dev)
            ckpt.save("medoid", np.asarray([ep], np.int64))
    log(f"projection ep: {ep} ({t_med.elapsed:.2f}s)")

    # ---- Phase A: projection ------------------------------------------------
    # Every training query's list is pruned against its top-1 target. The
    # first query's list is kept as the target's forward list; reverse
    # candidates come from every query's pruned list (:1088-1092).
    with Timer("phaseA", sync=dev_sync) as t_a:
        st = ckpt.load("phaseA")
        if st is not None:
            pruned_all = st
        else:
            tgt_all32 = knn[:, 0].astype(np.int32)
            cand = knn.astype(np.int32)                         # [Nq, M_sq]
            cand = np.where(cand == tgt_all32[:, None], n, cand)
            pruned_all = _batched_prune_rows(
                base_dev, tgt_all32, cand, M, metric,
                cfg.query_batch, fill=True).cpu().numpy()       # [Nq, M]
            ckpt.save("phaseA", pruned_all)
        tgt_all = knn[:, 0]
        winners_tgt, first_idx = np.unique(tgt_all, return_index=True)
        forward = np.full((n, M), n, np.int32)
        forward[winners_tgt] = pruned_all[first_idx]
    log(f"phase A: {winners_tgt.size}/{nq} unique targets "
        f"({t_a.elapsed:.2f}s)")

    # ---- Phase B+C: reverse edges + degree repair ---------------------------
    with Timer("phaseBC", sync=dev_sync) as t_bc:
        proj_np = ckpt.load("phaseBC")
        if proj_np is None:
            pv = pruned_all < n
            e_src = np.repeat(tgt_all, M)[pv.ravel()]           # u = target
            e_dst = pruned_all.ravel().astype(np.int64)[pv.ravel()]
            # dedupe (v→u) pairs across queries sharing a target
            key = e_dst * np.int64(n) + e_src
            _, uniq = np.unique(key, return_index=True)
            e_src, e_dst = e_src[uniq], e_dst[uniq]
            e_dist = _edge_dists(base_dev, e_src, e_dst, metric)
            if plan.large:
                # the sort runs on the host; only the [n, 3M] result
                # goes to the device
                rev = _to_dev(_aggregate_reverse(
                    e_src, e_dst, e_dist.cpu().numpy(), n, r_max=3 * M), dev)
            else:
                rev = _aggregate_reverse_device(
                    _to_dev(e_src, dev), _to_dev(e_dst, dev), e_dist, n=n,
                    r_max=3 * M)
            del e_dist
            _t0 = _time.perf_counter()
            projection = _merge_forward_reverse(
                base_dev, _to_dev(forward, dev), rev, cap=M, metric=metric,
                batch=cfg.query_batch, fill=True)
            del rev
            log(f"phase B/C merge: {_time.perf_counter() - _t0:.1f}s")
            proj_np = projection.cpu().numpy()
            ckpt.save("phaseBC", proj_np)
        else:
            projection = _to_dev(proj_np, dev)
        del forward, pruned_all
    st = PaddedGraph(neighbors=proj_np, ep=ep).degree_stats()
    log(f"phase B/C: degree avg {st['avg']:.1f} max {st['max']} "
        f"zero {st['zero']} ({t_bc.elapsed:.2f}s)")

    # ---- Phase D: connectivity enhancement ----------------------------------
    with Timer("phaseD", sync=dev_sync) as t_d:
        final = projection
        for p_i in range(max(1, cfg.connectivity_passes)):
            tag = f"phaseD{'' if p_i == 0 else p_i + 1}_{knobs}"
            saved = ckpt.load(tag)
            if saved is not None:
                supply = _to_dev(saved, dev)
            else:
                if plan.large:
                    # the pass reads the projection from the host
                    final = final.cpu()
                supply = _connectivity_pass(base_dev, final, ep, cfg,
                                            metric, log, ckpt=ckpt, tag=tag,
                                            pass_i=p_i, plan=plan)
                ckpt.save(tag, supply)
                ckpt.clean_prefix(f"{tag}_r")  # round files superseded
                final, supply = final.to(dev), supply.to(dev)
            # merge novel supply edges into projection (reference
            # :1251-1269); later passes stay under the same 2M bound
            _t0 = _time.perf_counter()
            final = _append_novel(final, supply, cap_add=2 * M, n=n)
            if final.shape[1] > 2 * M:
                final = _cap_degree(final, base_dev, 2 * M, metric,
                                    cfg.query_batch, n)
            log(f"phase D pass {p_i + 1} merge+cap: "
                f"{_time.perf_counter() - _t0:.1f}s")
        # phase E: reachability repair (reference's dead CollectPoints)
        final = _ensure_reachability(final.cpu().numpy(), ep, base_dev,
                                     metric, log)
    g = PaddedGraph(neighbors=final, ep=ep)
    st = g.degree_stats()
    log(f"phase D: final degree avg {st['avg']:.1f} max {st['max']} "
        f"zero {st['zero']} ({t_d.elapsed:.2f}s)")

    t_other = (_time.perf_counter() - t_build0 - t_med.elapsed
               - t_a.elapsed - t_bc.elapsed - t_d.elapsed)
    log(f"build split: medoid {t_med.elapsed:.1f}s A {t_a.elapsed:.1f}s "
        f"BC {t_bc.elapsed:.1f}s D {t_d.elapsed:.1f}s other {t_other:.1f}s")

    tr = tracer()
    tr.record("build.medoid", t_med.elapsed)
    tr.record("build.phaseA", t_a.elapsed, queries=int(nq))
    tr.record("build.phaseBC", t_bc.elapsed)
    tr.record("build.phaseD", t_d.elapsed, nodes=int(n))

    return RoarGraphIndex(graph=g, metric=metric, dim=base.shape[1])


def _edge_dists(base_dev, e_src, e_dst, metric, chunk: int = 1 << 20,
                take=None) -> torch.Tensor:
    """Distances for an edge list, chunked through the device. ``take``
    (global ids → vectors) stands in for gathering from ``base_dev``, which
    then only names the device."""
    dev = base_dev.device
    take = take or functools.partial(gather_rows_any, base_dev)
    parts = []
    for s in range(0, e_src.size, chunk):
        a = take(_to_dev(e_src[s: s + chunk], dev))
        b = take(_to_dev(e_dst[s: s + chunk], dev))
        if metric in (Metric.IP, Metric.COSINE):
            parts.append(-torch.sum(a * b, dim=-1))
        else:
            parts.append(torch.sum((a - b) ** 2, dim=-1))
    if not parts:
        return torch.empty(0, dtype=torch.float32, device=dev)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _own_overwrite(supply: torch.Tensor, chunk_lists: torch.Tensor,
                   r0: int, lo: int = 0, n: int | None = None) -> None:
    """Own-row overwrite of one chunk, in place (reference :1213): rows
    [r0, r0+c) ∩ [0, n) take the fresh pruned lists, sentinel-padded.
    ``supply`` holds rows [lo, lo + len(supply)) of the n-row graph (all
    of it by default; the sharded build's mp shard)."""
    n = supply.shape[0] if n is None else n
    Mc = chunk_lists.shape[1]
    a = max(r0, lo)
    b = min(r0 + chunk_lists.shape[0], n, lo + supply.shape[0])
    if b > a:
        supply[a - lo: b - lo, :Mc] = chunk_lists[a - r0: b - r0]
        supply[a - lo: b - lo, Mc:] = n


def _round_edges(chunk_lists: torch.Tensor, r0: int, n: int):
    """Arrival-ordered reverse edge streams for one chunk: (ds, ss, rank),
    sorted by (destination, arrival)."""
    c, Mc = chunk_lists.shape
    dev = chunk_lists.device
    row_ids = r0 + torch.arange(c, dtype=_I32, device=dev)
    ok_row = row_ids < n
    chunk_lists = torch.where(ok_row[:, None], chunk_lists, n)
    src = torch.repeat_interleave(row_ids, Mc)
    dst = chunk_lists.reshape(-1)
    dstk = torch.where(dst < n, dst, n)
    # (destination, arrival) order = a stable sort by destination
    ds, perm = torch.sort(dstk, stable=True)
    ss = src[perm]
    arrival = torch.arange(c * Mc, dtype=_I32, device=dev)
    is_start = torch.ones(c * Mc, dtype=torch.bool, device=dev)
    is_start[1:] = ds[1:] != ds[:-1]
    seg_start = torch.cummax(torch.where(is_start, arrival, 0), dim=0).values
    return ds, ss, arrival - seg_start


def _merge_rev_rows(own: torch.Tensor, rev: torch.Tensor, fit: torch.Tensor,
                    n: int) -> None:
    """Append rev edges into own rows' free slots, in place, for rows that
    fit, dropping entries already present; blocked so the [bs, W, W]
    membership broadcast stays bounded."""
    rows, W = own.shape
    dev = own.device
    posw = torch.arange(W, dtype=_I32, device=dev)
    bs = _block_rows(rows, W * W)
    for s in range(0, rows, bs):
        own_b, rev_b = own[s: s + bs], rev[s: s + bs]
        dup = (rev_b[:, :, None] == own_b[:, None, :]).any(dim=2)
        own_key = torch.where(own_b < n, posw, 3 * W + posw)
        rev_key = torch.where((rev_b < n) & ~dup, W + posw, 4 * W + posw)
        k_s, v_s = sort_multi((torch.cat([own_key, rev_key], dim=1),
                               torch.cat([own_b, rev_b], dim=1)), num_keys=1)
        packed = torch.where(k_s[:, :W] < 2 * W, v_s[:, :W], n)
        own[s: s + bs] = torch.where(fit[s: s + bs, None], packed, own_b)


def _fold_own_rows(supply: torch.Tensor, chunk_lists: torch.Tensor,
                   r0: int) -> torch.Tensor:
    """Own-row overwrite of one chunk, in place (the slab fold's
    prologue; `_fold_round_device` makes the same call)."""
    _own_overwrite(supply, chunk_lists, r0)
    return supply


def _fold_slab(supply: torch.Tensor, chunk_lists: torch.Tensor, r0: int,
               lo: int, sn: int, edges=None):
    """One row slab of the fold: reverse-aggregate and merge rows
    [lo, lo+sn), updating ``supply`` in place; returns (supply, fit [sn]).

    Bounded-memory twin of `_fold_round_device` for corpora whose [n, W]
    reverse scratch cannot sit next to base + supply + table: the scratch
    here is [sn, W]. Same edges, same ranks, same merge, so the outputs
    are bit-identical to the single fold's. ``edges``: the chunk's
    `_round_edges`, when the caller folds several slabs of one chunk."""
    n = supply.shape[0]
    edges = edges if edges is not None else _round_edges(chunk_lists, r0, n)
    return supply, _fold_rows(supply[lo: lo + sn], edges, lo, n)


def _fold_rows(own: torch.Tensor, edges, lo: int, n: int) -> torch.Tensor:
    """Fold a chunk's reverse edges into rows [lo, lo + len(own)) of the
    n-row supply graph, held in ``own``, in place: their arrival-order
    reverse lists (``edges``: the chunk's `_round_edges`), merged into the
    rows that fit. Returns fit [len(own)]. A slab of the slab fold, or the
    sharded build's mp shard."""
    rows, W = own.shape
    ds, ss, rank = edges
    keep = (ds >= lo) & (ds < lo + rows) & (rank < W)
    rev = torch.full((rows + 1, W), n, dtype=_I32, device=own.device)
    rev[torch.where(keep, ds - lo, rows).long(),
        torch.where(keep, rank, 0).long()] = torch.where(keep, ss, n)
    rev = rev[:rows]
    deg_own = torch.sum(own < n, dim=1, dtype=_I32)
    deg_rev = torch.sum(rev < n, dim=1, dtype=_I32)
    fit = (deg_own + deg_rev) <= W
    _merge_rev_rows(own, rev, fit, n)
    return fit


def _rev_rows_for_ids(chunk_lists: torch.Tensor, r0: int,
                      ids_sorted: torch.Tensor, n: int, W: int,
                      edges=None) -> torch.Tensor:
    """The arrival-order reverse lists of a sorted id set, [K, W]
    sentinel-padded — the overflow rows' candidates without a dense
    [n, W] scratch. Ids ≥ n get an empty list."""
    K = ids_sorted.shape[0]
    ds, ss, rank = edges if edges is not None else _round_edges(
        chunk_lists, r0, n)
    ids_sorted = ids_sorted.to(_I32)
    pos_c = torch.clamp(torch.searchsorted(ids_sorted, ds), max=K - 1)
    hit = (ids_sorted[pos_c] == ds) & (ds < n) & (rank < W)
    rev = torch.full((K + 1, W), n, dtype=_I32, device=chunk_lists.device)
    rev[torch.where(hit, pos_c, K), torch.where(hit, rank, 0).long()] = \
        torch.where(hit, ss, n)
    return rev[:K]


def _fold_round_device(supply: torch.Tensor, chunk_lists: torch.Tensor,
                       r0: int):
    """Fold one connectivity chunk into the live supply graph, in place:
    own-row overwrite + arrival-order reverse aggregation + dedup'd
    free-slot merge for rows that fit. Returns (supply, rev [n, W],
    fit [n]) — rows that do NOT fit keep only their own lists; the caller
    routes them through the overflow prune + refill."""
    n, W = supply.shape
    _own_overwrite(supply, chunk_lists, r0)
    # arrival-order reverse aggregation, budget W per destination
    # (reference SupplyAddReverse push_back order)
    ds, ss, rank = _round_edges(chunk_lists, r0, n)
    keep = (ds < n) & (rank < W)
    rev = torch.full((n + 1, W), n, dtype=_I32, device=supply.device)
    rev[torch.where(keep, ds, n).long(), torch.where(keep, rank, 0).long()] = \
        torch.where(keep, ss, n)
    rev = rev[:n]
    deg_own = torch.sum(supply < n, dim=1, dtype=_I32)
    deg_rev = torch.sum(rev < n, dim=1, dtype=_I32)
    fit = (deg_own + deg_rev) <= W
    _merge_rev_rows(supply, rev, fit, n)
    return supply, rev, fit


def _refill_rows_device(pruned: torch.Tensor, cand: torch.Tensor,
                        n: int) -> torch.Tensor:
    """Overflow-row refill: start from the pruned list, append candidates
    not already kept — in candidate (arrival) order, duplicates dropped —
    into free slots up to W = cand_width / 2."""
    K, M = pruned.shape
    C = cand.shape[1]
    W = C // 2
    dev = pruned.device
    merged0 = torch.cat(
        [pruned, torch.full((K, W - M), n, dtype=_I32, device=dev)], dim=1)
    dup = (cand[:, :, None] == merged0[:, None, :]).any(dim=2)
    posw = torch.arange(W, dtype=_I32, device=dev)
    posc = torch.arange(C, dtype=_I32, device=dev)
    own_key = torch.where(merged0 < n, posw, 3 * C + posw)
    cand_key = torch.where((cand < n) & ~dup, W + posc, 4 * C + posc)
    k_s, v_s = sort_multi((torch.cat([own_key, cand_key], dim=1),
                           torch.cat([merged0, cand], dim=1)), num_keys=1)
    return torch.where(k_s[:, :W] < 2 * C, v_s[:, :W], n)


def _compact_truncate_device(rows: torch.Tensor, cap: int,
                             n: int) -> torch.Tensor:
    """Left-compact valid (< n) entries, truncate to cap, sentinel n."""
    W = rows.shape[1]
    pos = torch.arange(W, dtype=_I32, device=rows.device)
    key = torch.where(rows < n, pos, W + pos)
    k_s, v_s = sort_multi((key, rows), num_keys=1)
    return torch.where(k_s[:, :cap] < W, v_s[:, :cap], n).contiguous()


def _fold_and_overflow(base_dev, supply, chunk_lists, r0, n, M, metric,
                       prune_batch, slab_rows: int = 0):
    """Fold one round's pruned chunk lists into the live supply graph.

    Reverse edges: the reference appends while a destination is under 2M
    and occlusion-prunes back to M on overflow (SupplyAddReverse →
    PruneProjectionInternalReverseCandidates) — arrival-order insertion
    with prune-then-refill windows. Deterministic given (supply, chunk),
    which is what makes round-checkpoint replay sound. The N*W reverse
    scratch lives only inside this call; with ``slab_rows`` the fold runs
    in row slabs of that height (`_fold_slab`, bit-identical) and the
    scratch never reaches full height."""
    W = supply.shape[1]
    if slab_rows:
        _fold_own_rows(supply, chunk_lists, r0)
        edges = _round_edges(chunk_lists, r0, n)
        fits = [_fold_slab(supply, chunk_lists, r0, lo, slab_rows, edges)[1]
                for lo in range(0, n, slab_rows)]
        fit = fits[0] if len(fits) == 1 else torch.cat(fits)
        rev = None
    else:
        supply, rev, fit = _fold_round_device(supply, chunk_lists, r0)
    over = torch.nonzero(~fit)[:, 0].to(_I32)
    if over.shape[0]:
        rev_rows = (_rev_rows_for_ids(chunk_lists, r0, over, n, W, edges)
                    if slab_rows else gather_rows_any(rev, over))
        cand = torch.cat([gather_rows_any(supply, over), rev_rows], dim=1)
        del rev, rev_rows
        pruned = _batched_prune_rows(base_dev, over, cand, M, metric,
                                     prune_batch, fill=False)
        # refill free slots with arrival-order leftovers not kept
        supply[over.long()] = _refill_rows_device(pruned, cand, n)
    return supply, fit


def _prune_batch(cfg, dev: torch.device, large: bool = False) -> int:
    """Rows per phase-D prune batch: bounds the [B, H, H] f32 occlusion
    tile (H = history length) to ~1/8 of the free device memory — half of
    that on the bounded-memory paths — at most one search batch. Rows are
    independent, so the batch size never shows in the result."""
    H = cfg.history_mult * cfg.L_pjpq
    if dev.type == "cuda":
        budget = torch.cuda.mem_get_info(dev)[0] // 8
    else:
        budget = 1 << 28
    if large:
        budget //= 2
    return max(8, min(cfg.search_batch, budget // (4 * H * (H + 8))))


def _scatter_pack_rows(table: torch.Tensor, base: torch.Tensor,
                       ids: torch.Tensor, supply: torch.Tensor, *,
                       n_base: int, M: int, d: int, bits: int) -> None:
    """Repack ONLY the given supply rows into the fused table, in place.

    Byte-identical to a full ``pack_neighbor_table`` for those rows:
    ``_pack_chunk`` is a pure per-row function of (base, row)."""
    rows = gather_rows_any(supply, ids)
    table[ids.long()] = _pack_chunk(base, rows, n_base=n_base, M=M, d=d,
                                    bits=bits)


def _repack_changed(table, base_dev, supply_dev, ids, n, M, d, bits,
                    blk: int = 32768):
    """Scatter-repack the changed rows ``ids`` (numpy or tensor, each in
    [0, n)) in blocks of ``blk``; returns the table, updated in place."""
    ids = _to_dev(ids, table.device)
    for s in range(0, ids.shape[0], blk):
        _scatter_pack_rows(table, base_dev, ids[s: s + blk], supply_dev,
                           n_base=n, M=M, d=d, bits=bits)
    return table


def _connectivity_pass(base_dev, projection, ep, cfg, metric, log,
                       ckpt=None, tag="phaseD", pass_i=0, plan=None):
    """Phase D: per-node search + prune + reverse supply edges.

    The reference runs this incrementally — every node's search sees the
    supply edges added by nodes processed before it
    (src/index_bipartite.cpp:1192-1220). That is reproduced in rounds: the
    node set is processed in ``connectivity_iters`` chunks, and after each
    chunk its pruned lists plus arrival-order reverse edges are folded
    into the supply graph the next chunk searches.

    Search engine per ``cfg.connectivity_engine``: "fused" repacks the live
    supply graph into quantized neighbour-block byte rows each round and
    traverses with one row gather per expansion (search/fused.py) — the
    prune recomputes exact f32 distances over the collected history, so
    the quantization affects traversal order only; "classic" is the f32
    lockstep beam (no table memory).

    ``plan`` (`_build_memory_plan`; default: planned here for the base's
    device) names the engine and, with ``plan.large``, the bounded-memory
    paths: the projection stays on the host (it may be handed in there)
    and feeds the not-seedable masks by per-batch [sb, M] uploads, the
    fold runs in slabs, and the pass's tail hoists the overflow rows to
    the host, frees the supply before the prune and returns its [n, M]
    result on the host. The result's values are the same either way.
    """
    dev = base_dev.device
    n, M = projection.shape[0], cfg.M_pjbp
    d = base_dev.shape[1]
    if plan is None:
        plan = _build_memory_plan(cfg, n, d, device_memory(dev))
    large = plan.large
    slab_rows = plan.slab_rows if large else 0
    L = cfg.L_pjpq
    sb = max(8, min(cfg.search_batch, n))
    eps = torch.tensor([ep], dtype=_I32, device=dev)
    prune_batch = _prune_batch(cfg, dev, large)
    t_walk = t_pack = t_fold = t_ckpt = 0.0

    rounds = _rounds_for_pass(cfg, pass_i)
    chunk = -(-n // rounds)
    # live supply graph, width 2M (insertion budget); a fresh tensor — the
    # fold updates it in place, and it must never alias `projection`
    W = 2 * M
    pw = projection.shape[1]
    supply = torch.full((n, W), n, dtype=_I32, device=dev)
    SLAB = min(n, 1 << 20)
    for s in range(0, n, SLAB):  # a host projection goes up slab by slab
        supply[s: s + SLAB, : min(pw, W)] = \
            projection[s: s + SLAB, :W].to(dev)
    # projection rows feed only the not-seedable masks
    projection = projection.cpu() if large else projection.to(dev)

    def proj_rows(ids=None, s=0, e=0):
        """Projection rows [s, e), or of a device id vector, on the device."""
        if ids is None:
            return projection[s:e].to(dev)
        if large:
            return projection[ids.cpu().long()].to(dev)
        return gather_rows_any(projection, ids)

    engine = plan.engine
    bits = cfg.connectivity_bits
    dim_mult = 8 if bits == 8 else 16
    if engine == "fused" and d % dim_mult:
        raise ValueError(f"connectivity_engine='fused' needs dim % "
                         f"{dim_mult} == 0 at connectivity_bits={bits} "
                         f"(got d={d}); pad the vectors or use 'classic'")
    # entry-point seeding: the node's own vector is the query, so one bf16
    # sample-scan matmul per batch replaces the medoid navigation prefix
    seeds = cfg.connectivity_seeds if engine == "fused" else 0
    samp = (make_seed_sample(base_dev, cfg.connectivity_seed_sample)
            if seeds else None)
    log(f"phase D engine: {engine} (expand={cfg.connectivity_expand}"
        + (f", bits={bits}"
           + (f", seeds={seeds}/1-in-{cfg.connectivity_seed_sample}"
              if seeds else "")
           if engine == "fused" else "") + ")")

    table = None
    packed_supply = None  # the supply snapshot the current table reflects
    Mt = None
    H = cfg.history_mult * L  # history ≈ reference full_retset size
    chunk_lists = None
    r0 = 0
    for round_i in range(rounds):
        r1 = min(r0 + chunk, n)
        # round-level resume: replay the deterministic fold of saved rounds
        saved = ckpt.load(f"{tag}_r{round_i}") if ckpt is not None else None
        if saved is not None:
            supply, _ = _fold_and_overflow(
                base_dev, supply, _to_dev(saved, dev), r0, n, M, metric,
                prune_batch, slab_rows)
            log(f"\rreplayed connectivity round {min(r1, n)}/{n}", end="")
            r0 = r1
            continue
        if engine == "fused":
            _t0 = _time.perf_counter()
            # incremental repack: scatter-repack only the rows that changed
            # since the snapshot the table was packed from (byte-identical,
            # _pack_chunk is pure per row); a full repack on the first
            # round, when more than 40% changed, or when the supply width
            # is not the table's
            ids = None
            if table is not None and W % 16 == 0:
                ids = torch.nonzero(
                    torch.any(packed_supply != supply, dim=1))[:, 0]
            if ids is None or ids.shape[0] > (2 * n) // 5:
                table, Mt = pack_neighbor_table(base_dev, supply, into=table,
                                                bits=bits)
            else:
                _repack_changed(table, base_dev, supply, ids, n, Mt, d, bits)
            # a copy: the fold updates supply in place
            packed_supply = supply.clone()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_pack += _time.perf_counter() - _t0
        chunk_lists = torch.full((chunk, M), n, dtype=_I32, device=dev)
        _t0 = _time.perf_counter()
        for s in range(r0, r1, sb):
            e = min(s + sb, r1)
            if engine == "fused":
                seed_ids = seed_d = None
                if seeds:
                    seed_ids, seed_d = seed_scan(*samp, base_dev[s:e],
                                                 n_seeds=seeds, metric=metric)
                r = _fused_beam(table, base_dev, eps, base_dev[s:e], k=1, L=L,
                                metric=metric, max_hops=4 * L + 32, n_base=n,
                                M=Mt, d=d, collect_expanded=H,
                                expand=cfg.connectivity_expand, bits=bits,
                                seed_ids=seed_ids, seed_d=seed_d)
                pool = r[4]
                if s == r0 == 0:  # once per pass: history-cap pressure
                    hops_r = r[3].float()
                    log(f"\rround@{r0}: search hops mean "
                        f"{float(hops_r.mean()):.0f} max "
                        f"{int(hops_r.max())} (H={H})", end="")
            else:
                # expand>1 amortizes pool maintenance over several pops per
                # lockstep step
                r = beam_search(base_dev, supply, eps, base_dev[s:e],
                                k=1, L=L, metric=metric,
                                expand=cfg.connectivity_expand,
                                visited_mode="pool", collect_expanded=H)
                pool = r.hist_ids
            # prune over the FULL expanded set (reference full_retset,
            # :1318) — includes expanded-then-dropped far nodes, whose
            # long-range edges the occlusion rule keeps for navigability.
            # The seed must not be an existing projection neighbour
            # (:1861-1864); two_pass stays off, as in the JAX package
            ns = _membership(pool, proj_rows(s=s, e=e), n)
            chunk_lists[s - r0: e - r0] = _batched_prune_rows(
                base_dev, torch.arange(s, e, dtype=_I32, device=dev), pool,
                M, metric, prune_batch, fill=False, not_seedable=ns)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_walk += _time.perf_counter() - _t0
        if ckpt is not None and ckpt.dir:
            _t0 = _time.perf_counter()
            ckpt.save(f"{tag}_r{round_i}", chunk_lists)
            t_ckpt += _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        supply, _ = _fold_and_overflow(base_dev, supply, chunk_lists, r0, n,
                                       M, metric, prune_batch, slab_rows)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_fold += _time.perf_counter() - _t0
        log(f"\rround {round_i}: cumulative walk {t_walk:.0f}s "
            f"pack {t_pack:.0f}s fold {t_fold:.0f}s "
            f"ckpt {t_ckpt:.0f}s", end="")
        r0 = r1
    log("")
    del table, packed_supply
    log(f"phase D split: walk (search+prune) {t_walk:.1f}s "
        f"pack {t_pack:.1f}s fold {t_fold:.1f}s ckpt {t_ckpt:.1f}s")
    tr = tracer()
    tr.record("build.phaseD.walk", t_walk)
    tr.record("build.phaseD.pack", t_pack)
    tr.record("build.phaseD.fold", t_fold)

    # overflow re-prune: any row > M goes back through the occlusion prune
    # (reference :1224-1248, no fill); projection members can't seed.
    # In order: the degree scan and the compact-truncate run in row slabs
    # (their sort scratch stays a slab's), the overflow rows are set aside
    # — on the host under ``large`` — while the supply is alive, the
    # supply is freed, and only then does the prune run.
    del chunk_lists
    OB = 1 << 16  # bounds the [OB, W, M] membership broadcast
    deg = torch.empty(n, dtype=_I32, device=dev)
    for s in range(0, n, SLAB):
        deg[s: s + SLAB] = torch.sum(supply[s: s + SLAB] < n, dim=1,
                                     dtype=_I32)
    over = torch.nonzero(deg > M)[:, 0].to(_I32)
    del deg
    cand_over = [gather_rows_any(supply, over[s: s + OB])
                 for s in range(0, over.shape[0], OB)]
    if large:
        cand_over = [c.cpu() for c in cand_over]
    final = torch.empty((n, M), dtype=_I32, device=dev)
    for s in range(0, n, SLAB):
        final[s: s + SLAB] = _compact_truncate_device(
            supply[s: s + SLAB], cap=M, n=n)
    del supply
    for i, cand in enumerate(cand_over):
        ids = over[i * OB: (i + 1) * OB]
        cand = cand.to(dev)
        ns = _membership(cand, proj_rows(ids), n)
        final[ids.long()] = _batched_prune_rows(
            base_dev, ids, cand, M, metric, prune_batch, fill=False,
            not_seedable=ns)
    # under ``large`` the result leaves the device with the pass
    return final.cpu() if large else final


def _ensure_reachability(final: np.ndarray, ep: int, base_dev, metric,
                         log, knn=None) -> np.ndarray:
    """Phase E: make every node reachable from the entry point.

    The reference carries this as dead code (findroot/dfs/CollectPoints,
    src/index_bipartite.cpp:2521-2604, its call commented out at :211):
    BFS from ep, then each unreachable node is appended to the lists of
    its nearest reachable nodes (first free slot, else the last), until
    the graph is fully reachable.

    ``knn(ids)``: the 32 nearest base ids of base rows ``ids`` (numpy
    [B] → [B, 32]), each block at most 8,192 rows; by default an exact
    scan of ``base_dev`` (the sharded build passes the sharded scan).
    """
    from mysteryann_tpu_torch.ops.knn import exact_knn_device

    if not final.flags.writeable:
        final = final.copy()
    n, width = final.shape
    kk = 32

    def scan(blk):
        q = gather_rows_any(base_dev, _to_dev(blk, base_dev.device))
        _, c = exact_knn_device(q, base_dev, k=kk, metric=metric,
                                tile=min(131072, n))
        return c.cpu().numpy()

    knn = knn or scan
    for it in range(8):
        # BFS from ep (vectorized frontier waves)
        reachable = np.zeros(n, bool)
        reachable[ep] = True
        frontier = np.array([ep], np.int64)
        while frontier.size:
            nxt = final[frontier]
            nxt = np.unique(nxt[nxt < n])
            nxt = nxt[~reachable[nxt]]
            reachable[nxt] = True
            frontier = nxt
        stranded = np.nonzero(~reachable)[0]
        if stranded.size == 0:
            if it:
                log(f"phase E: reachability repaired in {it} rounds")
            return final
        log(f"phase E round {it}: {stranded.size} unreachable nodes")
        # nearest reachable neighbour for each stranded node, in query
        # blocks (exact_knn_device holds a [B, tile] distance block)
        qb = 8192
        cand = np.empty((stranded.size, kk), np.int32)
        for s in range(0, int(stranded.size), qb):
            cand[s: s + qb] = knn(stranded[s: s + qb])
        # attach to the A nearest reachable anchors (a single thin edge
        # leaves repaired nodes hard to find)
        A = 3
        n_found = np.zeros(stranded.size, np.int64)
        attach_src, attach_dst = [], []
        for j in range(kk):
            c = cand[:, j].astype(np.int64)
            good = (n_found < A) & reachable[c] & (c != stranded)
            attach_src.append(stranded[good])
            attach_dst.append(c[good])
            n_found += good
        u_all = np.concatenate(attach_src)
        v_all = np.concatenate(attach_dst)
        none_found = n_found == 0
        if none_found.any():  # fall back to the entry point itself
            u_all = np.concatenate([u_all, stranded[none_found]])
            v_all = np.concatenate(
                [v_all, np.full(none_found.sum(), ep, np.int64)])
        # append u into v's list; collisions get successive free slots
        order = np.argsort(v_all, kind="stable")
        at_s, u_s = v_all[order], u_all[order]
        counts = np.bincount(at_s, minlength=n)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        rank = np.arange(at_s.size) - offs[at_s]
        free0 = (final[at_s] < n).sum(axis=1)
        slot = np.minimum(free0 + rank, width - 1)
        final[at_s, slot] = u_s.astype(np.int32)
    log("phase E: WARNING — repair did not converge in 8 rounds")
    return final


def _membership(pool: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """pool[b, l] ∈ rows[b, :] — bool [B, L]."""
    return (pool[:, :, None] == rows[:, None, :]).any(dim=2) & (pool < n)


def _cap_degree(rows: torch.Tensor, base_dev, cap: int, metric, batch: int,
                n: int, prune_rows=None) -> torch.Tensor:
    """Bound every row to ``cap`` edges: rows over the cap go through the
    occlusion prune (fill pass keeps them full); rows within it are
    copied (they are left-compacted, so truncating the width is lossless).
    Pruning every row instead would not be the same: the keep-scan can
    reorder or drop edges of rows under the cap too. Used by multi-pass
    phase D to hold the reference's 2*M degree bound. ``prune_rows``: as
    in `_merge_forward_reverse`."""
    prune_rows = prune_rows or functools.partial(_batched_prune_rows, base_dev)
    deg = torch.sum(rows < n, dim=1, dtype=_I32)
    over = torch.nonzero(deg > cap)[:, 0].to(_I32)
    out = rows[:, :cap].contiguous()
    OB = 1 << 15
    for s in range(0, over.shape[0], OB):
        ids = over[s: s + OB]
        out[ids.long()] = prune_rows(ids, gather_rows_any(rows, ids), cap,
                                     metric, batch, fill=True)
    return out


def _append_novel_block(proj_b: torch.Tensor, sup_b: torch.Tensor, n: int,
                        w_add: int) -> torch.Tensor:
    """One row block of the novel-supply append: projection entries, then
    supply entries not already present, compacted left by a key sort."""
    Mp = proj_b.shape[1]
    nov_b = sup_b[:, :w_add]
    C = Mp + w_add
    dev = proj_b.device
    dup = (nov_b[:, :, None] == proj_b[:, None, :]).any(dim=2)
    posP = torch.arange(Mp, dtype=_I32, device=dev)
    posN = torch.arange(w_add, dtype=_I32, device=dev)
    p_key = torch.where(proj_b < n, posP, 2 * C + posP)
    n_key = torch.where((nov_b < n) & ~dup, Mp + posN, 3 * C + posN)
    k_s, v_s = sort_multi((torch.cat([p_key, n_key], dim=1),
                           torch.cat([proj_b, nov_b], dim=1)), num_keys=1)
    return torch.where(k_s < 2 * C, v_s, n)


def _append_novel(projection: torch.Tensor, supply: torch.Tensor,
                  cap_add: int, n: int) -> torch.Tensor:
    """Append up to cap_add supply edges not already in projection.
    Projection rows are left-compacted, so each row's novel entries land
    right after its own degree."""
    N, Mp = projection.shape
    w_add = min(cap_add, supply.shape[1])
    out = torch.empty((N, Mp + w_add), dtype=_I32, device=projection.device)
    bs = _block_rows(N, supply.shape[1] * Mp)
    for s in range(0, N, bs):
        out[s: s + bs] = _append_novel_block(
            projection[s: s + bs], supply[s: s + bs], n=n, w_add=w_add)
    return out
