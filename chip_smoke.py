"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): build, check and
time the hand-written kernels (the row gather K1, the binned scan K2, the
k-selection K3 and the bf16 score product fused with it, K3f),
drive the RoarGraph build-then-search path once at full width, then the
flat serving path in four precisions, the fused engine (the bench's build
recipe and its seeded serving sweep), native persistence, the bipartite
index, the IVF index, parallel/ (sharded kNN, distributed and
query-parallel beam search, sharded IVF, in 4 ranks sharing the card) and
seven CLIs on the same world, with bench_torch.py's rows and the
serving-variance probe on the fused graph; then the worlds
larger than 1M: the build's slab paths at 4M rows, a 4M x 128 build and
seeded fused serving, and the index-keyed device corpus at 10M rows.

    python3 chip_smoke.py     # 1M, 4M and 10M x 128 worlds, one card

Phases, one line each before the last:
  1. device: the card's name and power limit (there is no CPU fallback);
  2. build_kernel: nvcc compiles csrc/gather.cu, csrc/scan.cu,
     csrc/select.cu and csrc/score_select.cu, in parallel, into
     mysteryann_tpu_torch/build/; ptxas registers / spills;
  3. kernel: the gather kernel against torch.index_select on the card, bit
     for bit, at the path's shapes and a few odd ones; the out-of-range flag;
     median times of both; then kernel_fused_rows: the same at the fused
     engine's byte rows (uint8 [1M+1, 6528] serving, [1M+1, 4608] build);
  4. kernel_scan: the scan kernel against binned_scan_ref on the card —
     bit for bit on dyadic data at 8,192 queries x 1M x 128 and at
     8,192 x 100k x 256, within scan.KERNEL_RTOL relative on Gaussian data
     (the measured error printed), bit for bit at odd corpus sizes; median
     times of the kernel, its plain version and a tiled bf16 torch.matmul
     of the same operands (the product alone, a yardstick); its bound and
     share;
  4b. k3_select: the k-selection kernel against topk_smallest_ref on the
     card, bit for bit in value bits and indices, at the paths' shapes
     (the seed scan's tile and all 500,000 sample columns at 8,192
     queries, flat f32 over 1M columns, an IVF step of 8,192 rows of 800
     and 131,072 such rows, the kNN merge, K2's bin top-k, the IVF probe
     choice, and on the wide route the probe choice at nprobe 300 and the
     IVF exactness gates' k = n = 2,000, 6,324 and 14,142, and k = 14,142
     of 20,000) and on
     adversarial rows (the int8 scans' s32 scores as f32, heavy
     ties, mixed +-0.0, rows of +inf, NaNs, strided and copied views, a
     few very long rows, rows shorter than a warp, n == k) at k = 1, 10,
     32, 40, 64, 128, 256 (the warp queue) and 257, 600, 2,000, 8,192,
     8,193, 14,142 (the wide route); int32 scores raise; times of the
     kernel, its plain version and torch.topk, with the bound and share;
  4c. k3f_select: the fused score kernel against score_topk_ref on the
     card under score_select.check_tolerance, at the paths' shapes (the
     seed scan, 8,192 x 500,000 x 128, k 48; flat bf16, 8,192 x 1M x 128,
     k 20; a fused-build batch, 8,192 x 250,000 x 128, k 16; a batch of
     256; one query; the T2I flat cell's call at a tenth of its rows,
     8,192 x 1M x 200, k 20), ip and l2, and bit for bit on dyadic
     operands (d = 200 on short and long shares, tables of 1, 50 and 127
     rows among them); times of the kernel, its
     plain version, the unfused route (the tiled f32 matmul + K3) and the
     fastest library composite (a bf16 torch.matmul, then torch.topk: no
     single PyTorch call computes the function), with the bound
     (operations) and share;
  5. main path on the bench's synthetic T2I world: exact kNN (train kNN and
     ground truth), build_roargraph (classic engine), save/load,
     Searcher.search at L = 64, 100, 200; checks on the graph, on recall and
     that the path went through the gather kernel;
  6. flat: FlatIndex in f32, bf16, int8 and scan precision on the same base,
     eval queries and ground truth; recall floors, and that bf16 / int8 /
     scan went through K1 and scan through K2; a torch.profiler split of
     one scan batch (K2, bin top-k, rerank);
  7. fused_build: build_roargraph with the bench's recipe (2 phase-D
     passes, expand 4, int4 rows, engine "auto", which resolves to fused);
     the same graph checks, the phase-D split (walk, pack, fold), peak GiB;
  8. fused_serve: FusedSearcher(max_degree=48, seed_sample=2, bits=8) over
     the bench's ten (expand, seeds, L) rows, then the classic Searcher on
     the same graph at L=100 (the bench's parity row); one row must reach
     recall@10 >= 0.95;
  7b. fused_build_seeded: the fused build recipe with phase-D seeds (16
     from a 1-in-4 sample, as scripts/torch_probe_build_1m.py's
     --build_seeds runs it) on the first 200,000 base rows and 40,000 train
     queries, one pass: the graph checks and K3f's launches;
  8a. seed_scan_k3f: the fused serving path's own seed scan at (4, 40, 48)
     (8,192 eval queries over the 1-in-2 sample of the 1M base) through
     K3f against its plain version under the tolerance, with both times;
     the same bits for a query alone and in the batch, and on a second
     run; a profiler split of one seeded batch;
  8b. bench_twin: bench_torch.py's own row functions (those its main
     calls) on the same base, eval queries and ground truth and on the
     phase-7 graph, one discarded trial and one timed (no build): flat f32
     in two windows, pooled; int8 flat; the ten seeded fused rows, each
     recall@10 equal to the fused_serve row of the same (expand, seeds,
     L); the classic parity row; the twin's headline JSON; its K1
     launches; bench_torch.contention_sentinel (a fixed bf16 8,192 x 1M
     product and min, five timed calls) before and after the rows;
  8c. probe_variance: scripts/torch_probe_variance.py's phases A
     (back-to-back trials, each batch timed by CUDA events), B (after
     allocating and freeing 4 x 1 GiB) and C (after empty_cache and a warm
     call), PROBE_TRIALS trials each, on the smoke's eval queries and the
     phase-7 graph with FusedSearcher(max_degree=48, seed_sample=2, bits=8);
     every trial's recall@10 must equal fused_serve's (4, 40, 56) row; its
     K1 launches; K1's error flag;
  9. native: the fused index saved through the native host library and
     through the numpy plain version — byte-identical files, equal loads,
     both times; fails unless the library loaded;
 10. bipartite: scripts/bench_bipartite.py's recipe (M_pjbp=32,
     base_row_cap=64) and two-hop BipartiteSearcher at L = 50, 100, 200,
     400 over one 4,096-query batch of the eval queries (reduced to
     L = 50, 200 to make room for the larger worlds); recall must not fall
     as L rises and must reach 0.5 at the last L; the time per hop and a
     profiler split of a batch's first 8 hops;
 11. ivf: IVFIndex with its defaults (2,000 clusters at 1M), f32 then int8
     + keep_f32; grouped search at nprobe 16 / 64 / 128 (int8 with rerank
     20); an exactness gate at nprobe = n_clusters; grouped against
     ungrouped; build_ivf_streaming against the in-memory int8 index; K1
     at the IVF block shapes against index_select (host-timed and in a
     CUDA graph, 20 different index sets per run), with its bound; a
     profiler split of one batch;
 12. parallel: parallel/ on the same world — 4 ranks (dp=2 x mp=2) spawned
     by parallel.launch share the card over gloo and run sharded_exact_knn,
     distributed_beam_search (L = 100, pool mode, expand 2),
     query_parallel_search and ShardedIVF over the phase-11 f32 and int8
     indexes (nprobe 64), each against the port's single-device call on the
     card (kNN: ids >= 0.999, dists within 1e-4; beams: equal hops and cmps,
     ids >= 0.999; IVF f32: dists within 1e-5, ids >= 0.99; IVF int8:
     recall within 0.02); K1 launched in every rank and equal to
     gather_rows_ref on the rank's base and neighbour shards; then a 1x1
     mesh over NCCL in one rank, bit for bit against single-device on 1,024
     queries. Ranks sharing one card: a correctness run, not a scaling
     figure. Then the second slice of parallel/ in 4 more ranks: (a)
     ShardedFusedSearcher on the phase-7 graph over all eval queries —
     the Fused cell's serving (max_degree 48, bits 8; (expand, seeds, L) =
     (4, 40, 48), (4, 40, 112)) and torch_bench_10m.py's (max_degree 32,
     bits 4; (4, 40, 64)) — each against FusedSearcher on the card at the
     ranks' batch (ids, dists, cmps, hops equal); (b) sharded_build_roargraph on
     the first 100,000 base rows and 20,000 train queries with the Classic
     recipe, against build_roargraph on the card at the ranks' batches (the
     same graph); K1 equal to gather_rows_ref on each rank's byte-row,
     rerank-base and build shards; the NCCL rank adds one sharded fused row
     on 1,024 queries, bit for bit;
 13. cli: the port's compute_gt, search_flat (int8) and search_roargraph
     (--engine fused, seeded) CLIs through their main() on the same world
     written as .fbin files; then export_fbin, build_bipartite →
     search_bipartite and build_ivf → search_ivf on a 200k-row slice;
 14. large_fold: at n = 4M, W = 64, M = 32, a seeded ragged supply and one
     round's chunk lists: the single fold against _fold_own_rows +
     _fold_slab + _rev_rows_for_ids, and the device reverse aggregation
     against the host one, bit for bit, with both times and peak memory;
 15. large_build: scripts/torch_bench_4m_fused.py's world and recipe at
     4M x 128 through build_roargraph with engine "auto" (one phase-D pass
     instead of the script's two and 200k of its 400k train queries, for
     time): the memory plan's choices and bytes, the per-phase split, peak
     memory, degrees, reachability, K1 launches; then seeded FusedSearcher
     rows (int4, max_degree 32) over 8,192 eval queries against exact
     ground truth, one row >= 0.90; large_k1: K1 against index_select, bit
     for bit, on the 4M base, on tables of the supply's ([4M, 64] i32) and
     the phase-D byte rows' ([4M+1, 4608] u8) shapes and on the serving
     table itself, with both times;
 16. device_world: CrossModalDeviceSpec on the card — the same indices in
     two batch shapes and against the CPU, the generation rate — then
     scripts/torch_bench_50m.py's pipeline at 10M rows: streamed exact
     ground truth for 4,096 queries, build_ivf_streaming (int8) from
     generated tiles, K1 against index_select on that index's int8 blocks
     (C = 4 and 64), grouped search at two nprobes reranked from
     regenerated rows, an exactness gate at nprobe = n_clusters.
K3's launches are counted over the main path's phases (the exact kNN of
phases 5 and 15, flat serving, the fused build and serving, the IVF
sweeps), each of which must launch it; K3f's over flat bf16, the seeded
fused build and fused serving, each of which must launch it. Then a JSON line with the kernels'
records, and last a JSON line with the device. Any failed check exits
non-zero before the last line is printed.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# the bench's T2I world (bench.py: WORLD, N_BASE, N_TRAIN, DIM, METRIC, K,
# M_SQ / M_PJBP / L_PJPQ) with the reference's single phase-D pass on the
# classic engine
WORLD = dict(n_concepts=20_000, intrinsic_dim=48, noise=0.85)
DIM, METRIC, K = 128, "ip", 10
SEARCH_LS = (64, 100, 200)
RECALL_FLOOR = 0.90     # recall@10 at L_pq=200
KERNEL_SOURCE = "mysteryann_tpu_torch/csrc/gather.cu"
KERNEL_REPLACES = "mysteryann_tpu/ops/gather.py:52"
SCAN_SOURCE = "mysteryann_tpu_torch/csrc/scan.cu"
SCAN_REPLACES = "mysteryann_tpu/ops/scan.py:68"
# H100 SXM peaks (NVIDIA's data sheet, 700 W) for the kernels' bounds
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
# recall@10 floors of FlatIndex per precision: f32 is exact; bf16 and int8
# rerank a k·2 head; scan loses bin collisions (the JAX package's own
# test floor for it, tests/test_scan.py)
FLAT_FLOORS = {"f32": 0.999, "bf16": 0.99, "int8": 0.99, "scan": 0.97}
# bench.py's graph recipe (M_SQ / M_PJBP / L_PJPQ, BUILD_EXPAND / BUILD_BITS,
# connectivity_passes=2, engine "auto") and seeded serving (SEED_SAMPLE,
# SEED_MAX_DEGREE, SEEDED_L_SWEEP, TARGET_RECALL)
FUSED_BUILD = dict(M_sq=64, M_pjbp=32, L_pjpq=128, metric=METRIC,
                   query_batch=8192, search_batch=8192, connectivity_passes=2,
                   connectivity_expand=4, connectivity_bits=4)
SEED_SAMPLE, SEED_MAX_DEGREE = 2, 48
SEEDED_L_SWEEP = ((4, 40, 40), (4, 40, 44), (4, 40, 48), (4, 40, 56),
                  (4, 40, 64), (4, 40, 80), (4, 40, 112),
                  (3, 48, 144), (3, 48, 176), (2, 48, 224))
TARGET_RECALL = 0.95
# bench_torch.py's rows in the smoke: one discarded trial, one timed
BENCH_TWIN_REPS = dict(repeats=1, ramp=1)
PROBE_TRIALS = 2          # trials a phase of the variance probe (script: 10)
# scripts/bench_bipartite.py's 1M recipe and sweep
BIPARTITE_CFG = dict(M_sq=64, M_pjbp=32, metric=METRIC)
# the script sweeps L = 50, 100, 200, 400; here two of them, for time
BIPARTITE_CAP, BIPARTITE_LS, BIPARTITE_QB = 64, (50, 200), 4096
BIPARTITE_REDUCED = "L = 50, 200 of the script's 50, 100, 200, 400"
# the two-hop loop is host-bound (~1.9 ms per hop-2 chunk merge): the sweep
# serves one 4,096-query batch per L, and the CLI slice 2,048 queries
BIPARTITE_QUERIES, CLI_BIPARTITE_QUERIES = 4096, 2048
BIPARTITE_FLOOR = 0.5     # recall@10 at the last L: against a broken search
IVF_NPROBES = (16, 64, 128)
IVF_RERANK = 20
# recall@10 at nprobe = n_clusters (every cluster scanned): f32 is exact;
# int8 reranks a 20-row head in f32
IVF_EXACT_FLOORS = {"f32": 0.999, "int8": 0.99}
CLI_SLICE = 200_000
# the larger worlds: the 4M fold and build, the 10M device corpus
LARGE_N, LARGE_TRAIN, LARGE_EVAL = 4_000_000, 200_000, 8192
LARGE_PASSES = 1
LARGE_REDUCED = ("1 phase-D pass of the script's 2; 200,000 of its 400,000 "
                 "train queries (their exact kNN is half the set-up); 8,192 "
                 "of its 32,768 eval queries; one timed batch per row")
# (seeds, L) rows of the 4M sweep at max_degree 32, int4, a 1-in-2 sample
LARGE_SWEEP = ((40, 56), (40, 112), (48, 112), (48, 144), (48, 224))
LARGE_RECALL_FLOOR = 0.90   # one row must reach it: against a broken search
WORLD_N, WORLD_EVAL, WORLD_TILE = 10_000_000, 4096, 1 << 20
WORLD_NPROBES, WORLD_RERANK, WORLD_GATE_QUERIES = (32, 128), 100, 256
WORLD_REDUCED = ("10M of the script's 50M rows; 4,096 of its 16,384 queries; "
                 "nprobe 32, 128 of its 32, 64, 128, 256; no flat-int8 table")
WORLD_ROW_ATOL = 2e-6     # rows across batch shapes / devices (unit norm)
SELECT_SOURCE = "mysteryann_tpu_torch/csrc/select.cu"
SELECT_REPLACES = "mysteryann_tpu/search/seeding.py:54"
SCORE_SOURCE = "mysteryann_tpu_torch/csrc/score_select.cu"
SCORE_REPLACES = "mysteryann_tpu/search/seeding.py:45"
# (name, rows, n, k, reps, trials) of K3's timed shapes: the seed scan's
# tile (n as _tiled_topk cuts it) and all 500,000 sample columns of the 1M
# world at 8,192 queries, flat f32 over the 1M base, an IVF step of the
# grouped scan ([C·qmax, cap] = [8,192, 800]: C = 8,192 // qmax) and 16
# steps' rows in one call, the kNN's [B, k + k] merge, K2's bin top-k, the
# IVF probe choice over 2,000 centroids; on the wide route (k > 256) the
# probe choice at nprobe 300 and the exactness gates' selection of every
# cluster (k = n = 2,000 at 1M, 1,024 queries; 6,324 at 10M, 256 queries;
# 14,142 at 50M, 64 queries) and k = 14,142 of 20,000
K3_SHAPES = (("seed_scan_tile", 8192, None, 48, 5, 5),
             ("seed_scan_full", 8192, 500_000, 48, 3, 3),
             ("flat_f32_full", 8192, 1_000_000, 20, 3, 3),
             ("ivf_step", 8192, 800, 20, 20, 7),
             ("ivf_rows_131072", 131072, 800, 20, 20, 7),
             ("knn_merge", 8192, 128, 64, 20, 7),
             ("scan_bins", 8192, 4096, 20, 20, 7),
             ("ivf_topc", 8192, 2000, 64, 20, 7),
             ("wide_topc_300", 8192, 2000, 300, 10, 5),
             ("wide_gate_1m", 1024, 2000, 2000, 10, 5),
             ("wide_gate_10m", 256, 6324, 6324, 10, 5),
             ("wide_gate_50m", 64, 14142, 14142, 10, 5),
             ("wide_k14142", 64, 20_000, 14142, 10, 5))
K3_LONG_ROW = 1_000_000     # the few-rows case: a block of warps a row
# every queue width and its edges, the warp's, and the wide route's sorts
# in shared memory and through global scratch
K3_KS = (1, 10, 32, 40, 64, 128, 256, 257, 600, 2000, 8192, 8193, 14142)
# K3's launches in the paths' own runs, by phase: the builds' exact kNN
# (main_path, large_knn), flat serving, the fused build and serving, IVF
K3_LAUNCHES: dict = {}
# (name, queries, table rows, d, k, reps, trials) of K3f's shapes: the seed
# scan of an 8,192-query batch over the 1M world's 1-in-2 sample, flat bf16
# over the 1M base (k = 10 x oversample 2), a fused-build phase-D batch of
# 8,192 nodes seeding 16 from a 1-in-4 sample, a small batch of 256, one
# query
K3F_SHAPES = (("seed_scan", 8192, 500_000, DIM, 48, 3, 3),
              ("flat_bf16", 8192, 1_000_000, DIM, 20, 3, 3),
              ("build_batch", 8192, 250_000, DIM, 16, 3, 3),
              ("small_batch", 256, 250_000, DIM, 16, 10, 5),
              ("one_query", 1, 500_000, DIM, 48, 20, 7),
              # the T2I flat cell's call at a tenth of its rows: the
              # pre-filter, a 16-column last box, 24-key buffers
              ("flat_t2i", 8192, 1_000_000, 200, 20, 3, 3))
# K3f's launches by phase: flat bf16, the seeded fused build, fused serving;
# and the calls of those phases that took score_topk's unfused route
K3F_LAUNCHES: dict = {}
K3F_UNFUSED: dict = {}
# the seeded fused build: the bench recipe with phase-D seeds, on a slice
SEEDED_BUILD = dict(FUSED_BUILD, connectivity_passes=1, connectivity_seeds=16,
                    connectivity_seed_sample=4)
SEEDED_BUILD_N, SEEDED_BUILD_TRAIN = 200_000, 40_000


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


T_START = time.perf_counter()


def phase(tag: str, **fields) -> None:
    """One line per phase; ``at_s`` is the script's clock when it printed."""
    fields["at_s"] = round(time.perf_counter() - T_START, 1)
    print(f"[{tag}] " + json.dumps(fields), flush=True)


def import_port():
    """The port from this checkout (never an installed copy)."""
    sys.path.insert(0, HERE)
    try:
        import mysteryann_tpu_torch as port
    except ModuleNotFoundError as e:
        fail(f"the port package is not beside this script: {e}")
    pkg_dir = os.path.dirname(os.path.abspath(port.__file__))
    check(pkg_dir == os.path.join(HERE, "mysteryann_tpu_torch"),
          f"imported the port from {pkg_dir}, not from this checkout")
    check("jax" not in sys.modules, "the port imported jax")
    return port


def time_ms(fn, reps: int = 20, trials: int = 7) -> float:
    """Median over `trials` of the mean time of `reps` back-to-back calls,
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return float(np.median(out))


def time_ms_graph(fn, reps: int = 20, trials: int = 7) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed (median over ``trials``), so host launch overhead does
    not count."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    del graph
    return float(np.median(out))


def enqueue_us(fn, calls: int = 1000, chunk: int = 100) -> float:
    """Host time per call of ``fn`` in microseconds, with no
    synchronisation: ``calls`` calls by time.perf_counter, in chunks of
    ``chunk`` with the card drained between chunks (off the clock), so a
    full launch queue never holds the host back; the median chunk's, since
    the host's clock jumps when the shared host is busy."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(calls // chunk):
        t0 = time.perf_counter()
        for _ in range(chunk):
            fn()
        per_call.append((time.perf_counter() - t0) / chunk)
        torch.cuda.synchronize()
    return float(np.median(per_call)) * 1e6


def rotating(fn, table: torch.Tensor, idxs: list):
    """``fn(table, idx)`` over the index sets ``idxs`` in turn, one set per
    call, so a run of calls reads rows from HBM rather than from the L2."""
    it = itertools.cycle(idxs)
    return lambda: fn(table, next(it))


def index_sets(table: torch.Tensor, n_idx: int, seed: int,
               sets: int = 20) -> list:
    """``sets`` seeded int32 index sets of ``n_idx`` rows of ``table``; the
    first holds row 0 first and the last row last."""
    g = torch.Generator(device=table.device)
    g.manual_seed(seed)
    idxs = [torch.randint(0, table.shape[0], (n_idx,), generator=g,
                          device=table.device, dtype=torch.int32)
            for _ in range(sets)]
    if n_idx:
        idxs[0][0], idxs[0][-1] = 0, table.shape[0] - 1
    return idxs


def k1_check(gather, table: torch.Tensor, idxs: list, tag: str) -> None:
    """K1 against index_select, bit for bit, on the first two index sets,
    each as int32 and as int64; fails with the max abs error otherwise."""
    for idx in idxs[:2]:
        for ix in (idx, idx.long()):
            got = gather.gather_rows(table, ix)
            want = gather.gather_rows_ref(table, ix)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"K1 {tag}: shape/dtype {got.shape} {got.dtype}")
            if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
                err = float((got.float() - want.float()).abs().max())
                fail(f"K1 differs from index_select on {tag} "
                     f"{list(table.shape)} {table.dtype} ({ix.dtype}), "
                     f"max abs err {err}")


def plan_text(plan) -> str:
    """K1's launch plan in a few words: path, word, whether segmented."""
    return (f"{plan.path}, {plan.word} B words"
            + (", segments" if plan.seg_bytes else ""))


def k1_timings(gather, table: torch.Tensor, idxs: list) -> dict:
    """K1 and index_select on ``table`` over the rotating index sets
    ``idxs``: graph-timed ms (20 calls replayed from one CUDA graph, the
    host out), host-launched ms, host enqueue us per call, the bound (rows
    read and written once, indices read once, at HBM_BYTES_S), the graph
    share and the plan's path."""
    n_idx = idxs[0].shape[0]
    row_bytes = table.stride(0) * table.element_size()
    kernel = rotating(gather.gather_rows, table, idxs)
    library = rotating(lambda t, i: torch.index_select(t, 0, i), table, idxs)
    t = {"rows": n_idx, "row_bytes": row_bytes,
         "plan": plan_text(gather.plan_for(table, n_idx)),
         "kernel_graph_ms": time_ms_graph(kernel),
         "index_select_graph_ms": time_ms_graph(library),
         "kernel_ms": time_ms(kernel), "index_select_ms": time_ms(library),
         "kernel_enqueue_us": enqueue_us(kernel),
         "index_select_enqueue_us": enqueue_us(library),
         "bound_ms": (2 * n_idx * row_bytes + 4 * n_idx) / HBM_BYTES_S * 1e3}
    t["share_graph"] = t["bound_ms"] / t["kernel_graph_ms"]
    return t


def is_k1_kernel(name: str) -> bool:
    """Whether a profiler kernel name is one of K1's (csrc/gather.cu keeps
    every kernel in namespace msann_k1)."""
    return "msann_k1" in name


def is_k3_kernel(name: str) -> bool:
    """Whether a profiler kernel name is one of K3's (csrc/select.cu keeps
    every kernel in namespace msann_k3)."""
    return "msann_k3::" in name


def is_k3f_kernel(name: str) -> bool:
    """Whether a profiler kernel name is K3f's (csrc/score_select.cu keeps
    its kernels in namespace msann_k3f)."""
    return "msann_k3f::" in name


def device_split(fn, top: int = 8) -> dict:
    """Device time of one call of ``fn`` from a torch.profiler trace: the
    wall time (profiled), the kernels' summed time, their busy share of
    the first-to-last kernel span, K1's, K3's and K3f's ms, and the ``top``
    kernels by time. ``fn`` runs twice in the trace and only the second
    call's kernels count (those that start after its host range does): a
    profiler started again in one process can miss the first kernels of
    its window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function("device_split.measured"):
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    start = min(e.time_range.start for e in events
                if e.name == "device_split.measured")
    # the range shows on the device's timeline too: not a kernel
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.start >= start
               and e.name != "device_split.measured"]
    out = {"wall_ms_profiled": wall * 1e3, "kernels_seen": len(kernels)}
    if not kernels:
        return out                # the profiler recorded no device activity
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    k1 = sum(v for k, v in by_name.items() if is_k1_kernel(k))
    k3 = sum(v for k, v in by_name.items() if is_k3_kernel(k))
    k3f = sum(v for k, v in by_name.items() if is_k3f_kernel(k))
    out.update(device_ms=busy / 1e3, busy_share=busy / max(1, span),
               k1_ms=k1 / 1e3, k3_ms=k3 / 1e3, k3f_ms=k3f / 1e3,
               top=[[k[:60], v / 1e3] for k, v in sorted(
                   by_name.items(), key=lambda kv: -kv[1])[:top]])
    return out


def kernel_checks(gather, dev) -> dict:
    """Phase 3: the kernel against index_select at the narrow-row shapes,
    int32 and int64 indices, and on a table view off 16 bytes (the register
    path); each shape timed over 20 rotating index sets; the out-of-range
    flag on each path (narrow; register rows, segments, 4-byte words)."""
    cases = [
        ("f32", (1_000_000, 128), torch.float32, 65536),
        ("i32", (1_000_000, 64), torch.int32, 65536),
        ("i8_odd_width", (4096, 48), torch.int8, 65536),
        ("bf16", (10_000, 96), torch.bfloat16, 65536),
        ("u8_view_off4", (100_000, 516), torch.uint8, 65536),
        ("empty", (1000, 128), torch.float32, 0),
    ]
    timings = {}
    for seed, (name, shape, dt, n_idx) in enumerate(cases):
        if name == "u8_view_off4":
            table = random_bytes((shape[0] * shape[1] + 4, 1), dev, seed)
            table = table.view(-1)[4:].view(shape)
        else:       # raw bits, compared as bytes (NaN patterns too)
            table = random_bytes(shape, dev, seed, dt)
        idxs = index_sets(table, n_idx, seed)
        k1_check(gather, table, idxs, name)
        if n_idx:
            timings[name] = k1_timings(gather, table, idxs)
            if name == "f32":
                timings[name]["plain_graph_ms"] = time_ms_graph(
                    rotating(gather.gather_rows_ref, table, idxs))
        del table, idxs
    phase("kernel", bit_identical=True, cases=[c[0] for c in cases],
          timings=timings)

    # an index of N (or -1) must not be read: its row comes back zero and
    # the device flag is set, on every path; then the flag is cleared
    paths = {}
    for rows, width, off in ((1000, 512, 0), (200, 6528, 0), (64, 131072, 0),
                             (1000, 512, 4)):
        table = random_bytes((rows * width + off, 1), dev, 9).view(-1)
        table = table[off:].view(rows, width)
        for dt in (torch.int32, torch.int64):
            idx = torch.tensor([5, rows, -1, rows - 1], device=dev, dtype=dt)
            out = gather.gather_rows(table, idx)
            torch.cuda.synchronize()
            check(gather.error_flag_value() == 1,
                  f"out-of-range index set no flag ({width} B rows)")
            check(bool((out[1:3] == 0).all())
                  and torch.equal(out[[0, 3]], table[[5, rows - 1]]),
                  f"out-of-range row not zeroed ({width} B rows)")
            gather.reset_error_flag()
            check(gather.error_flag_value() == 0, "error flag did not reset")
        paths[f"{width}B_off{off}"] = plan_text(gather.plan_for(table, 4))
    check(len(set(paths.values())) == 4,
          f"the out-of-range checks missed a path: {paths}")
    phase("kernel_flag", out_of_range_flagged=True, reset=True, paths=paths)
    f32 = timings["f32"]
    # every case was bit for bit, or the run failed above
    return {"max_abs_err": 0.0, "ms": f32["kernel_graph_ms"],
            "plain_ms": f32["plain_graph_ms"],
            "library_ms": f32["index_select_graph_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": "bytes"}


def kernel_fused_rows(gather, dev, n_rows: int = 1_000_001,
                      n_idx: int = 32768) -> dict:
    """Phase 3b: the gather kernel on the fused engine's byte-row tables —
    serving (bits 8, M 48: 6,528 B) and build (bits 4, W 64: 4,608 B) — bit
    for bit against index_select (int32 and int64 indices), timed over 20
    rotating index sets (~11 GB of tables, freed after each case)."""
    timings = {}
    for seed, (name, row_bytes) in enumerate(
            (("serve_u8_6528", 6528), ("build_u8_4608", 4608))):
        table = random_bytes((n_rows, row_bytes), dev, 2 + seed)
        idxs = index_sets(table, n_idx, 2 + seed)
        k1_check(gather, table, idxs, name)
        timings[name] = {**k1_timings(gather, table, idxs),
                         "table_rows": n_rows}
        del table, idxs
        torch.cuda.empty_cache()
    check(gather.error_flag_value() == 0,
          "the gather kernel met an out-of-range index (byte rows)")
    phase("kernel_fused_rows", bit_identical=True, timings=timings)
    return timings


def k1_on_table(gather, table: torch.Tensor, tag: str, n_idx: int = 32768,
                seed: int = 21) -> dict:
    """K1 against its plain version on a table a larger-world path holds
    (or one of its shape): 20 rotating sets of ``n_idx`` seeded indices,
    the first with row 0 and the last row, bit for bit (int32 and int64);
    the timings of ``k1_timings``."""
    idxs = index_sets(table, n_idx, seed)
    k1_check(gather, table, idxs, tag)
    return {"table": list(table.shape),
            "dtype": str(table.dtype).split(".")[-1], "bit_identical": True,
            **k1_timings(gather, table, idxs)}


def random_bytes(shape, dev, seed: int,
                 dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """A seeded table of random bytes (as ``dtype``), filled in slabs of
    under 2^31 bytes."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    width = shape[1] * torch.empty((), dtype=dtype).element_size()
    table = torch.empty((shape[0], width), dtype=torch.uint8, device=dev)
    for slab in table.split(max(1, (1 << 30) // width)):
        slab.random_(0, 256, generator=g)
    return table.view(dtype)


def reachable_all(neighbors: np.ndarray, ep: int) -> bool:
    n = neighbors.shape[0]
    seen = np.zeros(n, bool)
    seen[ep] = True
    frontier = np.array([ep])
    while frontier.size:
        nxt = neighbors[frontier]
        nxt = np.unique(nxt[nxt < n])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return bool(seen.all())


def main_path(port, gather, dev, n_base: int, n_train: int, n_eval: int,
              query_batch: int = 8192) -> dict:
    """Phase 4: data → exact kNN → build → save/load → search → recall."""
    from mysteryann_tpu_torch.ops import select
    from mysteryann_tpu_torch.utils.trace import tracer

    t0 = time.perf_counter()
    base, train_q = port.make_cross_modal(n_base, n_train, DIM,
                                          metric=METRIC, seed=7, **WORLD)
    _, eval_q = port.make_cross_modal(1, n_eval, DIM, metric=METRIC, seed=7,
                                      query_seed=8, **WORLD)
    phase("data", n_base=n_base, n_train=n_train, n_eval=n_eval, dim=DIM,
          seconds=time.perf_counter() - t0)

    gather.reset_launches()
    select.reset_launches()
    base_dev = port.prepare_vectors(base, METRIC, dev)
    t0 = time.perf_counter()
    _, knn = port.exact_knn(train_q, base_dev, k=64, metric=METRIC,
                            query_batch=query_batch)
    t_knn = time.perf_counter() - t0
    t0 = time.perf_counter()
    gt_d, gt_i = port.exact_knn(eval_q, base_dev, k=K, metric=METRIC,
                                query_batch=query_batch, precision="highest")
    t_gt = time.perf_counter() - t0
    # the ground truth against a float64 numpy scan on a few queries
    probe = eval_q[:64].astype(np.float64)
    ref = np.argpartition(-(probe @ base.T.astype(np.float64)), K,
                          axis=1)[:, :K]
    gt_agree = port.compute_recall(gt_i[:64], ref, K)
    check(gt_agree >= 0.99, f"ground truth disagrees with float64: "
                            f"{gt_agree}")
    check(np.isfinite(gt_d).all() and gt_i.shape == (n_eval, K),
          "ground truth not finite / wrong shape")
    k3_knn = select.launches
    phase("knn", train_knn_s=t_knn, gt_s=t_gt, gt_vs_float64=gt_agree,
          k3_launches=k3_knn, k3_wide_launches=select.wide_launches)
    check(k3_knn > 0, "the exact kNN launched K3 0 times")

    cfg = port.BuildConfig(M_sq=64, M_pjbp=32, L_pjpq=128, metric=METRIC,
                           query_batch=8192, search_batch=8192,
                           connectivity_passes=1,
                           connectivity_engine="classic",
                           connectivity_expand=4)
    tr = tracer()
    tr.reset()
    before = gather.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = port.build_roargraph(base_dev, train_q, knn, cfg, verbose=True)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build_launches = gather.launches - before
    spans = tr.summary()["spans"]
    st = index.graph.degree_stats()
    reach = reachable_all(index.graph.neighbors, index.graph.ep)
    phase("build", seconds=t_build,
          phases_s={k: v["total_s"] for k, v in spans.items()},
          degree=st, all_reachable=reach, k1_launches=build_launches)
    check(build_launches > 0, "the build launched the gather kernel 0 times")
    check(st["zero"] == 0, f"{st['zero']} zero-degree nodes")
    check(st["max"] <= 2 * cfg.M_pjbp, f"max degree {st['max']} > 64")
    check(reach, "not every node is reachable from the entry point")
    index.graph.validate()

    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        path = os.path.join(tmp, "proj.index")
        t0 = time.perf_counter()
        index.save(path)
        loaded = port.RoarGraphIndex.load(path)
        t_io = time.perf_counter() - t0
    check(loaded.graph.ep == index.graph.ep and np.array_equal(
        loaded.graph.neighbors, index.graph.neighbors),
        "save/load changed the graph")
    phase("persist", seconds=t_io, bytes_ok=True)

    searcher = port.Searcher(loaded, base_dev)
    before = gather.launches
    rows = []
    for L in SEARCH_LS:
        r = searcher.benchmark(eval_q, k=K, L=L, query_batch=query_batch,
                               visited_mode="pool", expand=2, warmup=1)
        check(np.isfinite(r["dists"]).all() and r["ids"].shape == (n_eval, K),
              f"L={L}: results not finite / wrong shape")
        row = {"L_pq": L, "qps": r["qps"],
               "recall@10": port.compute_recall(r["ids"], gt_i, K),
               "rderr": port.compute_rderr(r["dists"], gt_d, K, METRIC),
               "avg_cmps": r["avg_cmps"], "avg_hops": r["avg_hops"]}
        rows.append(row)
        phase("search", **row)
    search_launches = gather.launches - before
    check(search_launches > 0, "the search launched the gather kernel 0 times")
    check(rows[-1]["recall@10"] >= RECALL_FLOOR,
          f"recall@10 at L={SEARCH_LS[-1]} is {rows[-1]['recall@10']:.4f} "
          f"< {RECALL_FLOOR}")
    launches = gather.launches
    flag = gather.error_flag_value()
    K3_LAUNCHES["main_path"] = select.launches
    phase("main_path", k1_launches_build=build_launches,
          k1_launches_search=search_launches, k1_launches_total=launches,
          k3_launches_knn=k3_knn, k3_launches_total=select.launches,
          error_flag=flag)
    check(flag == 0, "the gather kernel met an out-of-range index")
    return {"launches": launches, "base": base, "base_dev": base_dev,
            "eval_q": eval_q, "gt_d": gt_d, "gt_i": gt_i,
            "train_q": train_q, "knn": knn,
            "neighbors": loaded.graph.neighbors, "ep": loaded.graph.ep}


def kernel_scan(scan, dev, n: int = 1_000_000, n_q: int = 8192,
                n_wide: int = 100_000) -> dict:
    """Phase 4: the scan kernel against its plain version on the card."""
    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def dyadic(shape):
        return torch.randint(-8, 9, shape, generator=g, device=dev) / 8

    def run_both(q, tbl, nn):
        got = scan.binned_scan(q, tbl, nn)
        want = scan.binned_scan_ref(q, tbl, nn)
        torch.cuda.synchronize()
        return got, want

    # (a) dyadic at the path's shape: every bf16 value and f32 sum is exact
    q = dyadic((n_q, DIM)).to(torch.bfloat16)
    tbl = scan.make_scan_table(dyadic((n, DIM)))
    (kd, kj), (rd, rj) = run_both(q, tbl, n)
    check(kd.shape == (n_q, scan.BINS) and kj.dtype == torch.int16,
          f"scan kernel: shape/dtype {tuple(kd.shape)} {kj.dtype}")
    check(torch.equal(kd, rd) and torch.equal(kj, rj),
          "scan kernel (dyadic, path shape) differs from binned_scan_ref")
    del kd, kj, rd, rj
    # (d) times at (a)'s shape; the plain version runs 512-query blocks;
    # the yardstick is the bf16 product alone, 65,536 table rows per call
    # into one reused bf16 output (no fold)
    t_kernel = time_ms(lambda: scan.binned_scan(q, tbl, n), reps=3, trials=5)
    t_plain = time_ms(lambda: scan.binned_scan_ref(q, tbl, n), reps=1,
                      trials=5)
    tile = 65536
    prod = torch.empty(n_q * tile, dtype=torch.bfloat16, device=dev)

    def product():
        for s in range(0, tbl.shape[0], tile):
            t = tbl[s:s + tile]
            torch.matmul(q, t.T, out=prod[:n_q * t.shape[0]].view(
                n_q, t.shape[0]))

    t_library = time_ms(product, reps=3, trials=5)
    del tbl, prod
    # the least time for the same work: the products of the n real rows on
    # the tensor cores, or q, the table and both outputs through HBM once
    flops = 2.0 * n_q * n * DIM
    moved = 2 * n_q * DIM + 2 * n * DIM + 6 * n_q * scan.BINS
    bound_ms = max(flops / BF16_FLOP_S, moved / HBM_BYTES_S) * 1e3
    bound_by = ("operations" if flops / BF16_FLOP_S >= moved / HBM_BYTES_S
                else "bytes")

    # (b) Gaussian at the path's shape
    qg = torch.randn((n_q, DIM), generator=g, device=dev)
    tg = scan.make_scan_table(torch.randn((n, DIM), generator=g, device=dev))
    (kd, kj), (rd, rj) = run_both(qg, tg, n)
    err = (kd - rd).abs()
    rel = float((err / rd.abs()).max())
    j_diff = float((kj != rj).float().mean())
    check(rel <= scan.KERNEL_RTOL, f"scan kernel (Gaussian): max relative "
                                   f"error {rel} > {scan.KERNEL_RTOL}")
    max_err = float(err.max())
    del qg, tg, kd, kj, rd, rj, err

    # (c) odd corpus sizes: n = BINS; tail masks and unwritten bins
    odd = [scan.BINS, 3 * 512 + 17, 9 * 512 + 5]
    for nn in odd:
        (kd, kj), (rd, rj) = run_both(q[:1024], scan.make_scan_table(
            dyadic((nn, DIM))), nn)
        check(torch.equal(kd, rd) and torch.equal(kj, rj),
              f"scan kernel differs from binned_scan_ref at n={nn}")
    # (e) d = 2·DIM: twice the resident query tile and table chunks
    qw = dyadic((n_q, 2 * DIM)).to(torch.bfloat16)
    (kd, kj), (rd, rj) = run_both(qw, scan.make_scan_table(
        dyadic((n_wide, 2 * DIM))), n_wide)
    check(torch.equal(kd, rd) and torch.equal(kj, rj),
          f"scan kernel (dyadic, {n_q} x {n_wide} x {2 * DIM}) differs "
          f"from binned_scan_ref")
    del qw, kd, kj, rd, rj
    torch.cuda.empty_cache()
    phase("kernel_scan", dyadic_bit_identical=True, shape=[n_q, n, DIM],
          wide_bit_identical=[n_q, n_wide, 2 * DIM],
          gaussian_max_rel_err=rel, gaussian_rtol=scan.KERNEL_RTOL,
          gaussian_max_abs_err=max_err, gaussian_j_differ_share=j_diff,
          odd_n_bit_identical=odd, kernel_ms=t_kernel, plain_ms=t_plain,
          library_ms=t_library, bound_ms=bound_ms, bound_by=bound_by,
          roofline_share=bound_ms / t_kernel,
          kernel_tflop_s=flops / t_kernel / 1e9)
    return {"max_abs_err": max_err, "ms": t_kernel, "plain_ms": t_plain,
            "library_ms": t_library, "bound_ms": bound_ms,
            "bound_by": bound_by}


def k3_plain(x: torch.Tensor, k: int, chunk_bytes: int = 2 << 30):
    """The plain version (``topk_smallest_ref``) over row blocks of at most
    ``chunk_bytes`` of input: its int64 key and torch.topk's scratch for a
    whole [8,192, 1M] block would not fit beside it. Rows are independent,
    so the blocks' results are the whole call's."""
    from mysteryann_tpu_torch.ops.sort import topk_smallest_ref

    step = max(1, chunk_bytes // max(1, x.shape[-1] * x.element_size()))
    if x.shape[0] <= step:
        return topk_smallest_ref(x, k)
    outs = [topk_smallest_ref(x[r:r + step], k)
            for r in range(0, x.shape[0], step)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def k3_same(select, x: torch.Tensor, k: int, tag: str) -> None:
    """K3 against its plain version, bit for bit in value bits and
    indices; fails with the count of differing entries otherwise."""
    from mysteryann_tpu_torch.ops.sort import topk_smallest

    before = select.launches
    got = topk_smallest(x, k)
    check(select.launches == before + 1,
          f"K3 {tag}: the call did not launch the kernel")
    want = k3_plain(x, k)
    torch.cuda.synchronize()
    same_i = torch.equal(got[1], want[1])
    same_v = torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    if not (same_i and same_v):
        bad = int((got[1] != want[1]).sum())
        fail(f"K3 differs from topk_smallest_ref on {tag} "
             f"{list(x.shape)} {x.dtype} k={k}: {bad} indices differ, "
             f"value bits equal: {same_v}")


def k3_bound_ms(rows: int, n: int, k: int, elem: int = 4) -> float:
    """The least time of a selection: every element read once, k values
    and int64 indices written a row, at HBM_BYTES_S."""
    return (rows * n * elem + rows * k * (elem + 8)) / HBM_BYTES_S * 1e3


def k3_timings(select, x: torch.Tensor, k: int, reps: int,
               trials: int) -> dict:
    """K3, its plain version and torch.topk (the one PyTorch call for the
    function, tie order aside) on ``x``: ms by CUDA events, the bound and
    the share, the plan."""
    from mysteryann_tpu_torch.ops.sort import topk_smallest

    rows, n = x.shape[0], x.shape[-1]
    big = reps < 20
    t = {"rows": rows, "n": n, "k": k,
         "plan": select.plan_for(x, k)._asdict(),
         "kernel_ms": time_ms(lambda: topk_smallest(x, k), reps, trials),
         "plain_ms": time_ms(lambda: k3_plain(x, k), 1 if big else reps,
                             min(trials, 3) if big else trials),
         "library_ms": time_ms(lambda: torch.topk(x, k, dim=-1,
                                                  largest=False),
                               reps, trials),
         "bound_ms": k3_bound_ms(rows, n, k, x.element_size())}
    t["share"] = t["bound_ms"] / t["kernel_ms"]
    return t


def kernel_select(select, dev) -> dict:
    """Phase 4b: K3 against its plain version, bit for bit, at the shapes
    the paths give it and on adversarial rows; times at the path shapes.
    The launches made here are outside every path's count."""
    from mysteryann_tpu_torch.ops import knn
    from mysteryann_tpu_torch.ops.sort import topk_smallest

    g = torch.Generator(device=dev)
    g.manual_seed(3)
    timings = {}
    for name, rows, n, k, reps, trials in K3_SHAPES:
        if n is None:
            # the seed scan's tile, as _tiled_topk cuts the 1-in-2 sample of
            # the 1M world with the card this empty
            n = knn._tile_rows(rows, K3_SHAPES[1][2], dev)
        x = torch.randn((rows, n), generator=g, device=dev)
        k3_same(select, x, k, name)
        timings[name] = k3_timings(select, x, k, reps, trials)
        del x
        torch.cuda.empty_cache()

    # adversarial rows, bit for bit at every k
    def ties(rows, n, lim=3, dtype=torch.float32):
        return torch.randint(-lim, lim + 1, (rows, n), generator=g,
                             device=dev).to(dtype)

    zeros = torch.where(torch.rand((512, 3000), generator=g, device=dev)
                        < 0.5, 0.0, -0.0)
    zeros[torch.rand(zeros.shape, generator=g, device=dev) < 0.2] = 1.0
    infs = torch.full((600, 800), float("inf"), device=dev)
    infs[1::3] = torch.randn((200, 800), generator=g, device=dev)
    infs[2::3, :400] = torch.randn((200, 400), generator=g, device=dev)
    nans = torch.randn((256, 2000), generator=g, device=dev)
    nans[torch.rand(nans.shape, generator=g, device=dev) < 0.05] = float("nan")
    nans[::2, :50] = -float("nan")
    # the int8 scans' raw scores: -(s8 . s8) products, ties everywhere
    q8 = torch.randint(-127, 128, (4096, DIM), generator=g, device=dev,
                       dtype=torch.int8)
    b8 = torch.randint(-3, 4, (20000, DIM), generator=g, device=dev,
                       dtype=torch.int8)
    s32 = -torch._int_mm(q8, b8.t())
    wide = torch.randn((1536, 1100), generator=g, device=dev)
    adversarial = {
        "s32_scores_f32": s32.float(),
        "small_int_ties": ties(2048, 5000),
        "signed_zeros": zeros,
        "inf_rows": infs,
        "nan_rows": nans,
        "col_slice": wide[:, 50:1050],
        "chunk_view": wide.view(16, 96, 1100)[:, :, :800],
        "col_step": wide[:, ::2],
        "few_long_rows": torch.randn((3, K3_LONG_ROW), generator=g,
                                     device=dev),
        "forty_long_rows": ties(40, K3_LONG_ROW // 5, lim=20),
        "short_rows": ties(4096, 17),
    }
    cases = 0
    for name, x in adversarial.items():
        for k in K3_KS:
            if k <= x.shape[-1]:
                k3_same(select, x, k, name)
                cases += 1
    for k in K3_KS:                         # n == k
        k3_same(select, ties(1000, k, lim=2), k, f"n_equals_k_{k}")
        cases += 1
    # what the kernel does not take raises: int32 scores
    try:
        topk_smallest(s32, 10)
    except TypeError:
        cases += 1
    else:
        fail("K3 took int32 scores instead of raising TypeError")
    del adversarial, zeros, infs, nans, q8, b8, s32, wide
    torch.cuda.empty_cache()
    phase("k3_select", bit_identical=True, adversarial_cases=cases,
          timings=timings)
    t = timings["seed_scan_tile"]
    return {"max_abs_err": 0.0, "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "timings": timings}


def k3f_bound(B: int, n: int, d: int, k: int) -> tuple:
    """(bound ms, "operations" or "bytes") of K3f: 2·B·n·d flops at
    BF16_FLOP_S against the bf16 operands read once and k f32 values and
    int64 ids written a query at HBM_BYTES_S."""
    ops = 2.0 * B * n * d / BF16_FLOP_S * 1e3
    io = ((B + n) * d * 2 + B * k * 12) / HBM_BYTES_S * 1e3
    return (ops, "operations") if ops >= io else (io, "bytes")


def k3f_library(q: torch.Tensor, t: torch.Tensor, k: int):
    """The fastest two-call library composite of K3f's function (ip): a
    bf16 torch.matmul (bf16 scores), then torch.topk of the largest."""
    return torch.topk(q @ t.t(), k, dim=-1)


def k3f_check(score_select, q, t, k, metric, q_sq, t_sq, tag) -> dict:
    """K3f against its plain version under check_tolerance; fails with the
    helper's reason. Returns the helper's report."""
    before = score_select.launches
    got = score_select.score_topk(q, t, k, metric, q_sq, t_sq)
    check(score_select.launches == before + 1,
          f"K3f {tag}: the call did not launch the kernel")
    want = score_select.score_topk_ref(q, t, k, metric, q_sq, t_sq)
    torch.cuda.synchronize()
    r = score_select.check_tolerance(q, t, metric, got, want, q_sq, t_sq)
    check(r["ok"], f"K3f outside its tolerance on {tag} "
                   f"{list(q.shape)} x {list(t.shape)} k={k} {metric}: {r}")
    return r


def kernel_score_select(score_select, dev) -> dict:
    """Phase 4c: K3f against its plain version on the card under the
    tolerance at the paths' shapes (ip; the seed scan's also l2), bit for
    bit on dyadic operands, and timed beside its plain version, the
    library composite and the unfused route (the tiled f32 matmul selected
    by K3, what those paths ran before K3f). The launches made here are
    outside every path's count."""
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    timings, errs = {}, []
    for name, B, n, d, k, reps, trials in K3F_SHAPES:
        q = torch.randn((B, d), generator=g, device=dev).to(torch.bfloat16)
        t = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
        r = k3f_check(score_select, q, t, k, "ip", None, None, name)
        errs.append(r["max_abs_err"])
        if name == "seed_scan":
            qf, tf = q.float(), t.float()
            r2 = k3f_check(score_select, q, t, k, "l2", (qf * qf).sum(1),
                           (tf * tf).sum(1), name + "_l2")
            errs.append(r2["max_abs_err"])
            del qf, tf
        bound, by = k3f_bound(B, n, d, k)
        tm = {"B": B, "n": n, "d": d, "k": k,
              "plan": score_select.plan_for(q, t, k)._asdict(),
              "ids_differ": r["ids_differ"],
              "max_err_over_eps": r["max_err_over_eps"],
              "kernel_ms": time_ms(lambda: score_select.score_topk(
                  q, t, k, "ip"), reps, trials),
              "plain_ms": time_ms(lambda: score_select.score_topk_ref(
                  q, t, k, "ip"), 1, 3),
              "library_ms": time_ms(lambda: k3f_library(q, t, k), reps,
                                    trials),
              "unfused_ms": time_ms(lambda: score_select._tiled(
                  q, t, k, score_select.Metric.IP, None, None, None,
                  score_select.topk_smallest), reps, trials),
              "bound_ms": bound, "bound_by": by}
        tm["share"] = bound / tm["kernel_ms"]
        timings[name] = tm
        del q, t
        torch.cuda.empty_cache()
    # dyadic operands: every sum exact, so the kernel's bits are the plain
    # version's, ties included; d = 200 on a short share (the base loop)
    # and on long ones (the pre-filter, a 16-column last box); the last
    # four: tables under a step (128 rows), batches under a tile, d under a
    # box
    dyadic = 0
    for B, n, d, k, metric in ((8192, 100_003, 128, 48, "ip"),
                               (1000, 30_011, 100, 20, "l2"),
                               (1024, 100_003, 200, 20, "ip"),
                               (8192, 600_011, 200, 20, "ip"),
                               (8192, 600_011, 200, 48, "l2"),
                               (40, 5000, 32, 256, "cosine"),
                               (1, 20_000, 128, 48, "ip"),
                               (3, 1, 128, 1, "ip"), (40, 50, 32, 48, "l2"),
                               (1, 127, 100, 100, "cosine"),
                               (130, 127, 16, 127, "ip")):
        q = (torch.randint(-8, 9, (B, d), generator=g, device=dev) / 8)
        t = (torch.randint(-8, 9, (n, d), generator=g, device=dev) / 8)
        q_sq = t_sq = None
        if metric == "l2":
            q_sq, t_sq = (q * q).sum(1), (t * t).sum(1)
        qb, tb = q.to(torch.bfloat16), t.to(torch.bfloat16)
        got = score_select.score_topk(qb, tb, k, metric, q_sq, t_sq)
        want = score_select.score_topk_ref(qb, tb, k, metric, q_sq, t_sq)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"K3f differs from its plain version on dyadic {B} x {n} x "
              f"{d} k={k} {metric}")
        dyadic += 1
    del q, t, qb, tb
    torch.cuda.empty_cache()
    phase("k3f_select", within_tolerance=True, dyadic_bit_identical=dyadic,
          timings=timings)
    t = timings["seed_scan"]
    return {"max_abs_err": max(errs), "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "timings": timings}


def seed_scan_k3f(port, score_select, world: dict, index,
                  query_batch: int = 8192) -> dict:
    """Phase 8a: the fused serving path's own seed scan (the 1-in-2 sample
    of the 1M base, 8,192 eval queries, 40 seeds as the (4, 40, 48) row
    takes them) through K3f against its plain version under the
    tolerance, with both times; the same bits for a query alone and in the
    batch, and on a second run; then a profiler split of one seeded batch
    at (4, 40, 48). Outside every path's count."""
    fs = port.FusedSearcher(index, world["base_dev"],
                            max_degree=SEED_MAX_DEGREE,
                            seed_sample=SEED_SAMPLE, bits=8)
    samp, samp_sq, _ = fs._samp
    q = port.prepare_vectors(world["eval_q"][:query_batch], METRIC,
                             world["base_dev"].device)
    qb = q.to(torch.bfloat16)
    k = 40
    r = k3f_check(score_select, qb, samp, k, METRIC, None, None,
                  "the fused serving seed scan")
    first = score_select.score_topk(qb, samp, k, METRIC)
    again = score_select.score_topk(qb, samp, k, METRIC)
    same = bool(torch.equal(first[0], again[0])
                and torch.equal(first[1], again[1]))
    for row in (0, query_batch // 2 + 1, query_batch - 1):
        one = score_select.score_topk(qb[row:row + 1], samp, k, METRIC)
        same = same and bool(torch.equal(one[0], first[0][row:row + 1])
                             and torch.equal(one[1], first[1][row:row + 1]))
    check(same, "K3f's seed scan differs between runs, or between a query "
                "alone and in the batch")
    bound, by = k3f_bound(qb.shape[0], samp.shape[0], samp.shape[1], k)
    t = {"B": qb.shape[0], "n": samp.shape[0], "k": k,
         "ids_differ": r["ids_differ"], "max_abs_err": r["max_abs_err"],
         "kernel_ms": time_ms(lambda: score_select.score_topk(
             qb, samp, k, METRIC), 3, 3),
         "plain_ms": time_ms(lambda: score_select.score_topk_ref(
             qb, samp, k, METRIC), 1, 3),
         "bound_ms": bound, "bound_by": by}
    t["share"] = bound / t["kernel_ms"]
    del first, again
    split = device_split(lambda: fs.search(
        q, k=K, L=48, query_batch=query_batch, expand=4, seeds=40,
        device_out=True), top=12)
    del fs, samp, samp_sq
    torch.cuda.empty_cache()
    phase("seed_scan_k3f", within_tolerance=True, same_bits_alone_and_again=same,
          timings=t, seeded_batch_split=split, queries=query_batch,
          row=[4, 40, 48])
    return t


def scan_batch_split(idx, q: torch.Tensor) -> dict:
    """Device time of one scan-precision FlatIndex batch by stage, from a
    torch.profiler trace: K2, then the bin top-k and column decode (the
    kernels up to the first K1 launch), then the rerank (K1 on)."""
    from torch.profiler import ProfilerActivity, profile

    idx.search(q, K, query_batch=q.shape[0], device_out=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        idx.search(q, K, query_batch=q.shape[0], device_out=True)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    split = {"k2_ms": 0.0, "bin_topk_ms": 0.0, "rerank_ms": 0.0}
    stage = None
    for e in kernels:
        if "binned_scan" in e.name:
            stage = "k2_ms"
        elif is_k1_kernel(e.name):
            stage = "rerank_ms"
        elif stage == "k2_ms":
            stage = "bin_topk_ms"
        if stage is not None:
            split[stage] += e.time_range.elapsed_us() / 1e3
    split["kernels_seen"] = len(kernels)
    if not kernels:
        return split          # the profiler recorded no device activity
    first, last = kernels[0].time_range.start, kernels[-1].time_range.end
    split["busy_share"] = (sum(e.time_range.elapsed_us() for e in kernels)
                           / max(1, last - first))
    return split


def flat_path(port, gather, scan, world: dict, query_batch: int = 8192
              ) -> dict:
    """Phase 6: FlatIndex in four precisions on the main path's world."""
    from mysteryann_tpu_torch.ops import score_select, select

    base_dev, eval_q = world["base_dev"], world["eval_q"]
    n = base_dev.shape[0]
    k1 = k2 = k3 = k3f = k3f_unfused = 0
    for prec in ("f32", "bf16", "int8", "scan"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        idx = port.FlatIndex(base_dev, METRIC, tile=n, oversample=2,
                             precision=prec)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        gather.reset_launches()
        scan.reset_launches()
        select.reset_launches()
        score_select.reset_launches()
        r = idx.benchmark(eval_q, k=K, query_batch=query_batch)
        l1, l2, l3 = gather.launches, scan.launches, select.launches
        l3f = score_select.launches
        unfused = score_select.unfused_launches
        split = (scan_batch_split(idx, port.prepare_vectors(
            eval_q[:query_batch], METRIC, base_dev.device))
            if prec == "scan" else None)
        del idx
        torch.cuda.empty_cache()
        check(np.isfinite(r["dists"]).all()
              and r["ids"].shape == (eval_q.shape[0], K),
              f"flat {prec}: results not finite / wrong shape")
        row = {"precision": prec, "qps": r["qps"],
               "recall@10": port.compute_recall(r["ids"], world["gt_i"], K),
               "rderr": port.compute_rderr(r["dists"], world["gt_d"], K,
                                           METRIC),
               "build_s": t_build, "k1_launches": l1, "k2_launches": l2,
               "k3_launches": l3, "k3f_launches": l3f,
               "k3f_unfused_launches": unfused,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if split is not None:
            row["batch_split"] = split
        phase("flat", **row)
        check(row["recall@10"] >= FLAT_FLOORS[prec],
              f"flat {prec}: recall@10 {row['recall@10']:.4f} < "
              f"{FLAT_FLOORS[prec]}")
        if prec != "f32":
            check(l1 > 0, f"flat {prec} launched the gather kernel 0 times")
        if prec == "scan":
            check(l2 > 0, "flat scan launched the scan kernel 0 times")
        check(l3 > 0, f"flat {prec} launched K3 0 times")
        check((l3f > 0) == (prec == "bf16"),
              f"flat {prec} launched K3f {l3f} times")
        check(unfused == 0, f"flat {prec}: {unfused} bf16 calls took the "
                            f"unfused route")
        k1 += l1
        k2 += l2
        k3 += l3
        k3f += l3f
        k3f_unfused += unfused
    K3_LAUNCHES["flat"] = k3
    K3F_LAUNCHES["flat"] = k3f
    K3F_UNFUSED["flat"] = k3f_unfused
    flag = gather.error_flag_value()
    check(flag == 0, "the gather kernel met an out-of-range index (flat)")
    return {"k1_launches": k1, "k2_launches": k2}


def fused_path(port, gather, world: dict, query_batch: int = 8192) -> dict:
    """Phases 7-8: the bench's fused build recipe, then seeded FusedSearcher
    serving over the bench's sweep and the classic parity row."""
    from mysteryann_tpu_torch.graph.roargraph import _resolve_engine
    from mysteryann_tpu_torch.ops import score_select, select
    from mysteryann_tpu_torch.utils.trace import tracer

    base_dev, eval_q = world["base_dev"], world["eval_q"]
    n, d = base_dev.shape
    cfg = port.BuildConfig(**FUSED_BUILD)
    engine = _resolve_engine(cfg, n, d)
    check(engine == "fused", f"engine 'auto' resolved to {engine!r} at "
                             f"{n} x {d}, not 'fused'")
    tr = tracer()
    tr.reset()
    torch.cuda.reset_peak_memory_stats()
    gather.reset_launches()
    select.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = port.build_roargraph(base_dev, world["train_q"], world["knn"],
                                 cfg, verbose=True)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build_launches = gather.launches
    k3_build = select.launches
    spans = tr.summary()["spans"]
    st = index.graph.degree_stats()
    reach = reachable_all(index.graph.neighbors, index.graph.ep)
    flag = gather.error_flag_value()
    phase("fused_build", engine=engine, seconds=t_build,
          phases_s={k: v["total_s"] for k, v in spans.items()},
          degree=st, all_reachable=reach, k1_launches=build_launches,
          k3_launches=k3_build, error_flag=flag,
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    check(build_launches > 0, "the fused build launched K1 0 times")
    check(flag == 0, "the gather kernel met an out-of-range index (build)")
    check(st["zero"] == 0, f"fused build: {st['zero']} zero-degree nodes")
    check(st["max"] <= 2 * cfg.M_pjbp,
          f"fused build: max degree {st['max']} > {2 * cfg.M_pjbp}")
    check(reach, "fused build: not every node is reachable")
    index.graph.validate()

    torch.cuda.reset_peak_memory_stats()
    fs = port.FusedSearcher(index, base_dev, max_degree=SEED_MAX_DEGREE,
                            seed_sample=SEED_SAMPLE, bits=8)
    gather.reset_launches()
    select.reset_launches()
    score_select.reset_launches()
    rows = []
    for expand, seeds, L in SEEDED_L_SWEEP:
        r = fs.benchmark(eval_q, k=K, L=L, query_batch=query_batch,
                         expand=expand, seeds=min(seeds, L), warmup=1)
        check(np.isfinite(r["dists"]).all()
              and r["ids"].shape == (eval_q.shape[0], K),
              f"fused L={L}: results not finite / wrong shape")
        row = {"expand": expand, "seeds": seeds, "L_pq": L, "qps": r["qps"],
               "recall@10": port.compute_recall(r["ids"], world["gt_i"], K),
               "rderr": port.compute_rderr(r["dists"], world["gt_d"], K,
                                           METRIC),
               "avg_cmps": r["avg_cmps"], "avg_hops": r["avg_hops"]}
        rows.append(row)
        phase("fused_serve", **row)
    serve_launches = gather.launches
    k3_serve = select.launches
    k3f_serve = score_select.launches
    K3_LAUNCHES["fused"] = k3_build + k3_serve
    K3F_LAUNCHES["fused"] = k3f_serve
    K3F_UNFUSED["fused"] = score_select.unfused_launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    del fs
    torch.cuda.empty_cache()
    best = max(r["recall@10"] for r in rows)
    at_target = [r for r in rows if r["recall@10"] >= TARGET_RECALL]
    phase("fused_serve_summary", k1_launches=serve_launches,
          k3_launches=k3_serve, k3f_launches=k3f_serve,
          k3f_unfused_launches=K3F_UNFUSED["fused"], best_recall=best,
          peak_gib=peak,
          best_qps_at_target=max((r["qps"] for r in at_target),
                                 default=None))
    check(serve_launches > 0, "fused serving launched K1 0 times")
    # the seed selection is K3f's now; K3 merges its column shares
    check(k3f_serve > 0, "fused serving launched K3f 0 times")
    check(K3F_UNFUSED["fused"] == 0,
          "fused serving: a seed scan took the unfused route")
    check(bool(at_target), f"no fused row reached recall@10 >= "
                           f"{TARGET_RECALL} (best {best:.4f})")

    searcher = port.Searcher(index, base_dev)
    r = searcher.benchmark(eval_q, k=K, L=100, query_batch=query_batch,
                           visited_mode="pool", expand=2, warmup=1)
    phase("fused_graph_classic_row", L_pq=100, qps=r["qps"],
          **{"recall@10": port.compute_recall(r["ids"], world["gt_i"], K)},
          avg_cmps=r["avg_cmps"], avg_hops=r["avg_hops"])
    check(gather.error_flag_value() == 0,
          "the gather kernel met an out-of-range index (fused serving)")
    return {"index": index, "k1_launches": build_launches + serve_launches,
            "rows": rows, "build_s": t_build}


def seeded_build_path(port, gather, world: dict) -> dict:
    """Phase 7b: the fused build with phase-D seeds (SEEDED_BUILD: the
    bench recipe, one pass, 16 seeds from a 1-in-4 sample, as
    scripts/torch_probe_build_1m.py --build_seeds runs it) on the first
    SEEDED_BUILD_N base rows and SEEDED_BUILD_TRAIN train queries; their
    kNN by the port's exact kNN, outside the counts. The graph checks and
    K3f's launches in the build."""
    from mysteryann_tpu_torch.ops import score_select

    base = world["base_dev"][:SEEDED_BUILD_N]
    train = world["train_q"][:SEEDED_BUILD_TRAIN]
    _, knn = port.exact_knn(train, base, k=SEEDED_BUILD["M_sq"],
                            metric=METRIC, query_batch=8192)
    cfg = port.BuildConfig(**SEEDED_BUILD)
    gather.reset_launches()
    score_select.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = port.build_roargraph(base, train, knn, cfg, verbose=False)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    l3f = score_select.launches
    K3F_LAUNCHES["fused_build"] = l3f
    K3F_UNFUSED["fused_build"] = score_select.unfused_launches
    st = index.graph.degree_stats()
    reach = reachable_all(index.graph.neighbors, index.graph.ep)
    phase("fused_build_seeded", n=SEEDED_BUILD_N, n_train=SEEDED_BUILD_TRAIN,
          seeds=SEEDED_BUILD["connectivity_seeds"],
          seed_sample=SEEDED_BUILD["connectivity_seed_sample"],
          passes=SEEDED_BUILD["connectivity_passes"], seconds=t_build,
          degree=st, all_reachable=reach, k1_launches=gather.launches,
          k3f_launches=l3f,
          k3f_unfused_launches=K3F_UNFUSED["fused_build"])
    check(l3f > 0, "the seeded fused build launched K3f 0 times")
    check(K3F_UNFUSED["fused_build"] == 0,
          "the seeded fused build: a seed scan took the unfused route")
    check(st["zero"] == 0, f"seeded build: {st['zero']} zero-degree nodes")
    check(reach, "seeded build: not every node is reachable")
    index.graph.validate()
    return {"k1_launches": gather.launches}


def bench_twin_path(gather, world: dict, fused: dict) -> int:
    """Phase 8b: bench_torch.py's row functions, the ones its main calls,
    on this world and the phase-7 graph (BENCH_TWIN_REPS trials a row, no
    build). Returns the phase's K1 launches."""
    import bench_torch as bt

    base_dev, eval_q = world["base_dev"], world["eval_q"]
    gt_i, gt_d = world["gt_i"], world["gt_d"]
    index = fused["index"]
    sentinel_pre = bt.contention_sentinel(base_dev)
    gather.reset_launches()
    t0 = time.perf_counter()
    w1 = bt.flat_row(base_dev, eval_q, gt_i, gt_d, "f32", **BENCH_TWIN_REPS)
    flat8 = bt.flat_row(base_dev, eval_q, gt_i, gt_d, "int8",
                        **BENCH_TWIN_REPS)
    graph_rows = bt.graph_sweep(index, base_dev, eval_q, gt_i, gt_d,
                                **BENCH_TWIN_REPS)
    w2 = bt.flat_row(base_dev, eval_q, gt_i, gt_d, "f32", **BENCH_TWIN_REPS)
    flat = bt.pool_flat_windows(w1, w2)
    classic = bt.classic_row(index, base_dev, eval_q, gt_i, gt_d,
                             **BENCH_TWIN_REPS)
    seconds = time.perf_counter() - t0
    launches = gather.launches
    flag = gather.error_flag_value()
    sentinel = {"pre": sentinel_pre,
                "post": bt.contention_sentinel(base_dev)}
    head, detail = bt.summarize(flat, flat8, graph_rows, classic,
                                round(fused["build_s"], 1),
                                bt.read_baseline_qps(),
                                bt.card_info(base_dev.device), seconds,
                                sentinel)
    for name, row in (("flat_f32", flat), ("flat_int8", flat8)):
        phase("bench_twin_flat", mode=name, qps=row["qps"],
              qps_trials=row["qps_trials"], recall=row["recall"],
              rderr=row["rderr"])
    serve = {(r["expand"], r["seeds"], r["L_pq"]): r["recall@10"]
             for r in fused["rows"]}
    for r in graph_rows:
        phase("bench_twin_fused", expand=r["expand"], seeds=r["seeds"],
              L_pq=r["L_pq"], qps=r["qps"], recall=r["recall"],
              fused_serve_recall=serve[r["expand"], r["seeds"], r["L_pq"]])
    phase("bench_twin_classic", L_pq=classic["L_pq"], qps=classic["qps"],
          recall=classic["recall"])
    phase("bench_twin_headline", **head)
    phase("bench_twin_sentinel", unit="ms",
          **detail["contention_sentinel_ms"])
    phase("bench_twin", seconds=seconds, k1_launches=launches,
          error_flag=flag, n_eval=eval_q.shape[0], **BENCH_TWIN_REPS)
    for r in graph_rows:
        check(r["recall"] == serve[r["expand"], r["seeds"], r["L_pq"]],
              f"bench twin: fused row {r['expand'], r['seeds'], r['L_pq']} "
              f"recall {r['recall']} != fused_serve's")
    check(flat["recall"] >= FLAT_FLOORS["f32"],
          f"bench twin: flat f32 recall@10 {flat['recall']:.4f}")
    check(flat8["recall"] >= FLAT_FLOORS["int8"],
          f"bench twin: flat int8 recall@10 {flat8['recall']:.4f}")
    check(head["detail"]["mode"] in ("flat", "flat_int8", "roargraph")
          and head["value"] > 0, f"bench twin: headline {head}")
    check(launches > 0, "bench twin: K1 launched 0 times")
    check(flag == 0, "the gather kernel met an out-of-range index (twin)")
    for when, ts in sentinel.items():
        check(len(ts) == 5 and ts == sorted(ts) and ts[0] > 0,
              f"bench twin: sentinel {when} {ts}")
    return launches


def probe_variance_path(port, gather, world: dict, fused: dict) -> int:
    """Phase 8c: scripts/torch_probe_variance.py's phases A, B and C
    (PROBE_TRIALS trials each) on this world's eval queries and the phase-7
    graph. Returns the phase's K1 launches."""
    pv = _script("torch_probe_variance.py")
    base_dev = world["base_dev"]
    serve = {(r["expand"], r["seeds"], r["L_pq"]): r["recall@10"]
             for r in fused["rows"]}
    want = serve[pv.EXPAND, pv.SEEDS, pv.L]
    t0 = time.perf_counter()
    fs = port.FusedSearcher(fused["index"], base_dev,
                            max_degree=SEED_MAX_DEGREE,
                            seed_sample=SEED_SAMPLE)
    q = port.prepare_vectors(world["eval_q"], METRIC, base_dev.device)
    gather.reset_launches()
    pv._search(fs, q[:pv.QB])       # one warm call, as the script
    torch.cuda.synchronize()
    recs = pv.run_phases(fs, q, world["gt_i"], PROBE_TRIALS,
                         emit=lambda r: phase("probe_variance_phase", **r))
    launches = gather.launches
    flag = gather.error_flag_value()
    del fs
    torch.cuda.empty_cache()
    phase("probe_variance", seconds=time.perf_counter() - t0,
          k1_launches=launches, error_flag=flag, trials=PROBE_TRIALS,
          L_pq=pv.L, fused_serve_recall=want)
    for r in recs:
        check(r["recall"] == [want] * PROBE_TRIALS,
              f"probe_variance {r['label']}: recall@10 {r['recall']} != "
              f"fused_serve's {want}")
        check(len(r["per_batch_ms"]) == -(-q.shape[0] // pv.QB),
              f"probe_variance {r['label']}: {len(r['per_batch_ms'])} "
              f"batch times")
    check(launches > 0, "probe_variance: K1 launched 0 times")
    check(flag == 0, "the gather kernel met an out-of-range index (probe)")
    return launches


def native_path(fused_index, tmp_root: str = HERE) -> dict:
    """Phase 9: the fused 1M index through the native host library and
    through the numpy plain version: the same bytes, the same loads."""
    from mysteryann_tpu_torch import native
    from mysteryann_tpu_torch.graph import roargraph as rg

    check(native.lib() is not None,
          f"the native library did not load: {native.status()['error']}")
    g = fused_index.graph
    times = {}
    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        paths = {r: os.path.join(tmp, f"{r}.index")
                 for r in ("native", "python")}
        before = dict(native.calls)
        for route, save in (("native", rg.save_projection_graph),
                            ("python", rg.save_projection_graph_ref)):
            t0 = time.perf_counter()
            save(paths[route], g)
            times[f"save_{route}_s"] = time.perf_counter() - t0
        with open(paths["native"], "rb") as a, open(paths["python"], "rb") as b:
            same = a.read() == b.read()
        size = os.path.getsize(paths["native"])
        loads = {}
        for route, load in (("native", rg.load_projection_graph),
                            ("python", rg.load_projection_graph_ref)):
            t0 = time.perf_counter()
            loads[route] = load(paths["native"])
            times[f"load_{route}_s"] = time.perf_counter() - t0
    calls = {r: native.calls[r] - before[r] for r in ("native", "python")}
    equal = all(x.ep == g.ep and np.array_equal(x.neighbors, g.neighbors)
                for x in loads.values())
    st = native.status()
    phase("native", library=st["library"], loaded=st["loaded"],
          bytes_identical=same, loads_equal=equal, file_bytes=size,
          routes=calls, **times)
    check(same, "native and Python graph files differ")
    check(equal, "a graph load differs from the saved graph")
    check(calls == {"native": 2, "python": 2},
          f"the native / Python routes ran {calls}, not twice each")
    return times


def bipartite_path(port, gather, world: dict) -> int:
    """Phase 10: the bipartite index with scripts/bench_bipartite.py's
    recipe, two-hop search over the eval queries. Returns K1 launches."""
    from mysteryann_tpu_torch.search.beam import beam_search

    base_dev = world["base_dev"]
    eval_q = world["eval_q"][:BIPARTITE_QUERIES]
    gt_i, gt_d = (world["gt_i"][:BIPARTITE_QUERIES],
                  world["gt_d"][:BIPARTITE_QUERIES])
    t0 = time.perf_counter()
    index = port.build_bipartite(world["base"], world["train_q"],
                                 world["knn"],
                                 port.BuildConfig(**BIPARTITE_CFG),
                                 base_row_cap=BIPARTITE_CAP)
    t_build = time.perf_counter() - t0
    s = port.BipartiteSearcher(index, base_dev)
    chunk = s.auto_two_hop_chunk(BIPARTITE_QB, base_dev.shape[1])
    phase("bipartite_build", seconds=t_build,
          shape=list(index.neighbors.shape), two_hop_chunk=chunk,
          reduced=BIPARTITE_REDUCED)
    s.search(eval_q[:64], K, BIPARTITE_LS[0], device_out=True)   # warm-up
    rows = []
    # K1's count covers the L sweep through BipartiteSearcher and nothing
    # else: the warm-up and the profiled steps below stay outside it
    gather.reset_launches()
    for L in BIPARTITE_LS:
        r = s.benchmark(eval_q, k=K, L=L, query_batch=BIPARTITE_QB,
                        warmup=0)
        check(np.isfinite(r["dists"]).all()
              and r["ids"].shape == (eval_q.shape[0], K)
              and (r["ids"] < index.n_base).all(),
              f"bipartite L={L}: results not finite / wrong shape / ids")
        row = {"L_pq": L, "qps": r["qps"],
               "recall@10": port.compute_recall(r["ids"], gt_i, K),
               "rderr": port.compute_rderr(r["dists"], gt_d, K, METRIC),
               "avg_cmps": r["avg_cmps"], "avg_hops": r["avg_hops"],
               "batch_ms": r["mean_latency_ms"]}
        rows.append(row)
        phase("bipartite", **row)
    launches = gather.launches
    # where a hop's time goes: the first 8 steps of one batch at L=50, timed
    # alone and under the profiler (a whole batch is ~10^6 kernels)
    q = port.prepare_vectors(eval_q, METRIC, base_dev.device)

    def steps():
        beam_search(s.base, s.neighbors, s.eps, q, k=K, L=BIPARTITE_LS[0],
                    metric=s.metric, two_hop=True, two_hop_chunk=chunk,
                    max_hops=8)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    hop_ms = (time.perf_counter() - t0) * 1e3 / 8
    phase("bipartite_split", L_pq=BIPARTITE_LS[0], queries=q.shape[0],
          hops=8, ms_per_hop=hop_ms, **device_split(steps))
    recalls = [r["recall@10"] for r in rows]
    phase("bipartite_summary", k1_launches=launches, recalls=recalls,
          error_flag=gather.error_flag_value())
    check(launches > 0, "the bipartite search launched K1 0 times")
    check(all(b >= a for a, b in zip(recalls, recalls[1:])),
          f"bipartite recall falls as L rises: {recalls}")
    check(recalls[-1] >= BIPARTITE_FLOOR,
          f"bipartite recall@10 at L={BIPARTITE_LS[-1]} is "
          f"{recalls[-1]:.4f} < {BIPARTITE_FLOOR}")
    check(gather.error_flag_value() == 0,
          "the gather kernel met an out-of-range index (bipartite)")
    return launches


def ivf_k1_blocks(gather, index) -> dict:
    """K1 on the IVF index's own block table (f32 or int8) at C = 4 and 64
    rows per call: bit for bit against index_select (int32 and int64), and
    ``k1_timings`` over 20 index sets, so a run of calls reads 20·C
    different blocks (up to 524 MB) instead of re-reading one set from the
    50 MB L2."""
    blocks = index.blocks
    out = {}
    for C in (4, 64):
        idxs = index_sets(blocks, C, 5 + C)
        k1_check(gather, blocks, idxs, f"IVF blocks (C={C})")
        out[f"{str(blocks.dtype).split('.')[-1]}_C{C}"] = k1_timings(
            gather, blocks, idxs)
    return out


def ivf_path(port, gather, world: dict, query_batch: int = 8192,
             save_dir: str | None = None) -> dict:
    """Phase 11: IVFIndex f32 and int8 on the main world; grouped sweep,
    exactness gate, grouped vs ungrouped, streaming build, K1 at the block
    shapes. Returns K1 launches and K1's IVF-block timings. With
    ``save_dir`` each index is saved there as ``ivf_{store}.npz``."""
    from mysteryann_tpu_torch.ops import select

    base_dev, eval_q = world["base_dev"], world["eval_q"]
    gt_i = world["gt_i"]
    n, d = base_dev.shape
    exact_q = eval_q[:1024]
    launches, k1_blocks, rows, centroids = 0, {}, [], {}
    K3_LAUNCHES["ivf"] = 0
    for store in ("f32", "int8"):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = port.IVFIndex(base_dev, METRIC, store=store,
                            keep_f32=store == "int8")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        rerank = IVF_RERANK if store == "int8" else 0
        phase("ivf_build", store=store, seconds=t_build,
              n_clusters=idx.n_clusters, cap=idx.cap,
              blocks=list(idx.blocks.shape),
              peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        centroids[store] = idx.centroids.clone()
        # K1's count covers the grouped sweep and nothing else: the gate,
        # the ungrouped parity run and the profiled batch stay outside it
        gather.reset_launches()
        select.reset_launches()
        for nprobe in IVF_NPROBES:
            r = idx.benchmark(eval_q, k=K, nprobe=nprobe,
                              query_batch=query_batch, rerank=rerank)
            check(np.isfinite(r["dists"]).all()
                  and r["ids"].shape == (eval_q.shape[0], K),
                  f"ivf {store} nprobe={nprobe}: not finite / wrong shape")
            row = {"store": store, "nprobe": nprobe, "rerank": rerank,
                   "qps": r["qps"], "batch_ms": r["mean_latency_ms"],
                   "recall@10": port.compute_recall(r["ids"], gt_i, K),
                   "rderr": port.compute_rderr(r["dists"], world["gt_d"], K,
                                               METRIC)}
            rows.append(row)
            phase("ivf", **row)
        sweep_launches, k3_sweep = gather.launches, select.launches
        phase("ivf_sweep", store=store, k1_launches=sweep_launches,
              k3_launches=k3_sweep)
        check(sweep_launches > 0,
              f"the ivf {store} grouped sweep launched K1 0 times")
        check(k3_sweep > 0, f"the ivf {store} grouped sweep launched K3 0 "
                            f"times")
        K3_LAUNCHES["ivf"] += k3_sweep
        launches += sweep_launches
        wide0 = select.wide_launches
        ids, _ = idx.search(exact_q, K, nprobe=idx.n_clusters,
                            query_batch=exact_q.shape[0], rerank=rerank)
        exact = port.compute_recall(ids, gt_i[:1024], K)
        wide = select.wide_launches - wide0
        phase("ivf_exact", store=store, nprobe=idx.n_clusters,
              queries=exact_q.shape[0], **{"recall@10": exact},
              k3_wide_launches=wide)
        check(wide > 0, f"the ivf {store} gate (nprobe = n_clusters) did not "
                        f"select through K3's block queue")
        check(exact >= IVF_EXACT_FLOORS[store],
              f"ivf {store} at nprobe = n_clusters: recall@10 {exact:.4f} "
              f"< {IVF_EXACT_FLOORS[store]}")
        if store == "f32":
            # the ungrouped path as the grouped path's parity partner, on
            # 256 queries with a slot budget that drops no probe
            qs = port.prepare_vectors(eval_q[:256], METRIC, base_dev.device)
            ig, dg = idx._search_grouped(qs, K, 16, slot_budget=256)
            iu, du = idx._search_device(qs, K, 16)
            agree = float((ig == iu).float().mean())
            close = bool(torch.allclose(dg, du, rtol=1e-5, atol=1e-5))
            phase("ivf_grouped_vs_ungrouped", queries=256, nprobe=16,
                  ids_agree=agree, dists_close=close)
            check(close and agree >= 0.999,
                  f"grouped and ungrouped IVF differ (ids {agree})")
            split = device_split(lambda: idx.search(
                eval_q, K, nprobe=64, query_batch=query_batch,
                device_out=True))
            phase("ivf_split", store=store, nprobe=64,
                  queries=eval_q.shape[0], **split)
        k1_blocks.update(ivf_k1_blocks(gather, idx))
        if store == "int8":
            # the streamed index keeps no f32 rows: both without rerank
            ids, _ = idx.search(eval_q, K, nprobe=64, query_batch=query_batch)
            int8_recall = port.compute_recall(ids, gt_i, K)
            t0 = time.perf_counter()
            st = port.build_ivf_streaming(
                lambda s0, w: base_dev[s0: s0 + w], n, d, metric=METRIC,
                n_clusters=idx.n_clusters, cap_factor=1.6, kmeans_iters=10,
                tile=262144)
            torch.cuda.synchronize()
            t_st = time.perf_counter() - t0
            gather.reset_launches()
            ids, _ = st.search(eval_q, K, nprobe=64, query_batch=query_batch)
            st_launches = gather.launches
            launches += st_launches
            rec = port.compute_recall(ids, gt_i, K)
            phase("ivf_streaming", seconds=t_st, cap=st.cap,
                  k1_launches=st_launches,
                  **{"recall@10": rec, "in_memory_recall@10": int8_recall})
            check(st_launches > 0,
                  "the streamed IVF index's search launched K1 0 times")
            check(abs(rec - int8_recall) <= 0.005,
                  f"streamed int8 recall {rec:.4f} vs in-memory "
                  f"{int8_recall:.4f}")
            del st
        if save_dir is not None:
            idx.save(os.path.join(save_dir, f"ivf_{store}.npz"))
        del idx
        torch.cuda.empty_cache()
    phase("ivf_k1_blocks", bit_identical=True, timings=k1_blocks)
    # both builds run k-means on the same base with the same seed: sorted
    # segment sums make the centroids the same bits on every run
    same_centroids = torch.equal(centroids["f32"], centroids["int8"])
    phase("ivf_summary", k1_launches=launches,
          kmeans_bit_identical=same_centroids,
          error_flag=gather.error_flag_value())
    check(same_centroids, "the two IVF builds' k-means centroids differ")
    check(gather.error_flag_value() == 0,
          "the gather kernel met an out-of-range index (ivf)")
    return {"k1_launches": launches, "k1_blocks": k1_blocks}


PAR_DP, PAR_MP = 2, 2          # 4 ranks on cuda:0, over gloo
PAR_L, PAR_NPROBE = 100, 64
PAR_NCCL_QUERIES = 1024
PAR_TIMEOUT_S = 600
PAR_NOTE = "ranks sharing one card: a correctness run, not a scaling figure"
PAR_RESULT = ("ids", "dists", "cmps", "hops")
# ShardedFusedSearcher rows: (max_degree, seed_sample, bits, ((expand,
# seeds, L), ...)) — the Fused cell's serving, then torch_bench_10m.py's
SHF_CONFIGS = ((SEED_MAX_DEGREE, SEED_SAMPLE, 8, ((4, 40, 48), (4, 40, 112))),
               (32, 2, 4, ((4, 40, 64),)))
# the sharded build: the Classic recipe (main_path) on a slice of the world
SHB_N, SHB_TRAIN = 100_000, 20_000
SHB_CFG = dict(M_sq=64, M_pjbp=32, L_pjpq=128, metric=METRIC,
               query_batch=8192, search_batch=8192, connectivity_passes=1,
               connectivity_engine="classic", connectivity_expand=4)
SHB_REDUCED = (f"the first {SHB_N:,} base rows and {SHB_TRAIN:,} train "
               "queries of the 1M world")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev: torch.device):
    """(fn(), seconds), the device drained on both sides."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _k1_shard_check(gather, table: torch.Tensor, seed: int) -> bool:
    """K1 against gather_rows_ref on a rank's own shard table, bit for bit
    (65,536 seeded rows, int32 indices)."""
    idx = index_sets(table, 65536, seed, sets=1)[0]
    got = gather.gather_rows(table, idx)
    return torch.equal(got, gather.gather_rows_ref(table, idx))


def _par_inputs(work: str):
    """The phase's inputs as memory-mapped .npy files: each rank reads
    only its rows."""
    def load(name):
        return np.load(os.path.join(work, name + ".npy"), mmap_mode="r")
    return load("base"), load("neighbors"), load("eval_q")


def _rank_build(gather, dev: torch.device):
    """Load K1 in a rank: the parent built it, so this is a reuse (0 s)."""
    return gather.build() if dev.type == "cuda" else None


def parallel_rank(work: str, ep: int, device: str) -> dict:
    """One of the phase's 4 ranks (dp=2 x mp=2, all on cuda:0, gloo): the
    sharded kNN, distributed beam, query-parallel search and ShardedIVF
    (f32, int8) on the 1M world, K1's launches over them, then K1 against
    its plain version on the rank's base and neighbour shards."""
    from mysteryann_tpu_torch import IVFIndex, parallel as par
    from mysteryann_tpu_torch.ops import gather

    mesh = par.make_mesh_distributed(dp=PAR_DP, mp=PAR_MP, device=device)
    build_s = _rank_build(gather, mesh.device)
    base, nbrs, q_all = _par_inputs(work)
    b = par.shard_base(mesh, base, "mp")
    nb = par.shard_base(mesh, nbrs, "mp")
    q = par.shard_base(mesh, q_all, "dp")
    full_b, full_nb = par.replicate(mesh, base), par.replicate(mesh, nbrs)
    q_qp = par.shard_base(mesh, q_all, ("dp", "mp"))
    eps = torch.tensor([ep], dtype=torch.int32, device=mesh.device)
    ivfs = {s: par.ShardedIVF(mesh, IVFIndex.load(
        os.path.join(work, f"ivf_{s}.npz"), device="cpu"))
        for s in ("f32", "int8")}
    beam = dict(k=K, L=PAR_L, metric=METRIC, visited_mode="pool", expand=2)

    def dp_np(x):
        return par.gather_dp(mesh, x).cpu().numpy()

    gather.reset_launches()
    out, secs = {}, {}
    dev = mesh.device
    (d, i), secs["knn"] = _timed(
        lambda: par.sharded_exact_knn(mesh, q, b, K, METRIC), dev)
    out["knn"] = {"dists": dp_np(d), "ids": dp_np(i)}
    r, secs["beam"] = _timed(lambda: par.distributed_beam_search(
        mesh, b, nb, eps, q, **beam), dev)
    out["beam"] = {f: dp_np(getattr(r, f)) for f in PAR_RESULT}
    r, secs["query_parallel"] = _timed(lambda: par.query_parallel_search(
        mesh, full_b, full_nb, eps, q_qp, **beam), dev)
    out["query_parallel"] = {
        f: par.all_gather(getattr(r, f), mesh, ("dp", "mp")).cpu().numpy()
        for f in PAR_RESULT}
    for store, sidx in ivfs.items():
        (ids, d), secs[f"ivf_{store}"] = _timed(
            lambda: sidx.search(q, K, PAR_NPROBE, device_out=True), dev)
        out[f"ivf_{store}"] = {"ids": dp_np(ids), "dists": dp_np(d)}
    launches = gather.launches
    k1_same = {"base_shard": _k1_shard_check(gather, b, 31),
               "neighbor_shard": _k1_shard_check(gather, nb, 32)}
    return {"build_s": build_s, "launches": launches, "k1_same": k1_same,
            "secs": secs, "backend": mesh.backend,
            "device": str(mesh.device), "coord": (mesh.coord("dp"),
                                                  mesh.coord("mp")),
            "error_flag": gather.error_flag_value(), "out": out}


def parallel_nccl_rank(work: str, ep: int, fused_ep: int,
                       device: str) -> dict:
    """A 1x1 mesh over NCCL in one rank: each sharded function against its
    single-device counterpart on the same inputs, bit for bit."""
    from mysteryann_tpu_torch import FusedSearcher, IVFIndex, parallel as par
    from mysteryann_tpu_torch.ops import gather
    from mysteryann_tpu_torch.ops.knn import exact_knn_device
    from mysteryann_tpu_torch.search.beam import beam_search

    mesh = par.make_mesh_distributed(dp=1, mp=1, device=device)
    build_s = _rank_build(gather, mesh.device)
    base, nbrs, q_all = _par_inputs(work)
    b = par.shard_base(mesh, base, "mp")
    nb = par.shard_base(mesh, nbrs, "mp")
    q = par.replicate(mesh, q_all[:PAR_NCCL_QUERIES])
    eps = torch.tensor([ep], dtype=torch.int32, device=mesh.device)
    idxs = {s: IVFIndex.load(os.path.join(work, f"ivf_{s}.npz"),
                             device=mesh.device) for s in ("f32", "int8")}
    beam = dict(k=K, L=PAR_L, metric=METRIC, visited_mode="pool", expand=2)
    gather.reset_launches()
    d, i = par.sharded_exact_knn(mesh, q, b, K, METRIC)
    r = par.distributed_beam_search(mesh, b, nb, eps, q, **beam)
    ivf = {s: par.ShardedIVF(mesh, idx).search(q, K, PAR_NPROBE,
                                               device_out=True)
           for s, idx in idxs.items()}
    index = _fused_index(work, fused_ep)
    max_degree, sample, bits, rows = SHF_CONFIGS[0]
    expand, seeds, L = rows[0]
    fused = dict(expand=expand, seeds=min(seeds, L), device_out=True)
    sf = par.ShardedFusedSearcher(mesh, index, base, max_degree, sample,
                                  bits).search(q, K, L, **fused)
    _sync(mesh.device)
    launches = gather.launches
    d1, i1 = exact_knn_device(q, b, K, METRIC, tile=8192)
    r1 = beam_search(b, nb, eps, q, **beam)
    same = {"knn": torch.equal(d, d1) and torch.equal(i, i1),
            "beam": all(torch.equal(getattr(r, f), getattr(r1, f))
                        for f in PAR_RESULT)}
    for s, idx in idxs.items():
        i1, d1 = idx.search(q, K, nprobe=PAR_NPROBE,
                            query_batch=PAR_NCCL_QUERIES, device_out=True)
        same[f"ivf_{s}"] = (torch.equal(ivf[s][0], i1)
                            and torch.equal(ivf[s][1], d1))
    sf1 = FusedSearcher(index, b, max_degree=max_degree, seed_sample=sample,
                        bits=bits).search(q, K, L, query_batch=q.shape[0],
                                          visited_mode="merge", **fused)
    same[f"sharded_fused_bits{bits}_L{L}"] = all(
        torch.equal(x, y) for x, y in zip(sf, sf1))
    return {"build_s": build_s, "launches": launches, "same": same,
            "backend": mesh.backend, "device": str(mesh.device),
            "error_flag": gather.error_flag_value()}


def _agree(a: np.ndarray, b: np.ndarray) -> float:
    return float((a == b).mean())


def _agree_ties(a: np.ndarray, b: np.ndarray, da: np.ndarray,
                db: np.ndarray) -> float:
    """Share of equal ids, counting a swap inside a run of equal
    distances as equal (ids compared as sets where scores tie)."""
    same = a == b
    for i, j in zip(*np.nonzero(~same)):
        same[i, j] = (set(a[i][da[i] == da[i, j]])
                      == set(b[i][db[i] == db[i, j]]))
    return float(same.mean())


def _fused_index(work: str, ep: int):
    """The phase-7 graph as a RoarGraphIndex, its rows memory-mapped."""
    from mysteryann_tpu_torch.graph import PaddedGraph, RoarGraphIndex
    from mysteryann_tpu_torch.ops.distances import Metric
    nb = np.load(os.path.join(work, "fused_neighbors.npy"), mmap_mode="r")
    return RoarGraphIndex(graph=PaddedGraph(neighbors=nb, ep=ep),
                          metric=Metric.parse(METRIC), dim=DIM)


def sharded_rank(work: str, fused_ep: int, n_build: int,
                 device: str) -> dict:
    """One of 4 ranks (dp=2 x mp=2 on cuda:0, gloo) for parallel/'s second
    slice: (a) ShardedFusedSearcher over SHF_CONFIGS on the phase-7 graph;
    (b) sharded_build_roargraph with SHB_CFG on the world's slice; K1's
    launches over each, then K1 against its plain version on the rank's
    byte-row table, rerank base and build shards."""
    from mysteryann_tpu_torch import parallel as par
    from mysteryann_tpu_torch.ops import gather
    from mysteryann_tpu_torch.ops.distances import prepare_vectors
    from mysteryann_tpu_torch.utils.params import BuildConfig
    from mysteryann_tpu_torch.utils.trace import tracer

    mesh = par.make_mesh_distributed(dp=PAR_DP, mp=PAR_MP, device=device)
    build_s = _rank_build(gather, mesh.device)
    dev = mesh.device
    base, _, q_all = _par_inputs(work)
    q = par.shard_base(mesh, q_all, "dp")
    index = _fused_index(work, fused_ep)
    out, secs, k1_same = {}, {}, {}
    gather.reset_launches()
    for max_degree, sample, bits, rows in SHF_CONFIGS:
        sf, secs[f"init_bits{bits}"] = _timed(
            lambda: par.ShardedFusedSearcher(mesh, index, base, max_degree,
                                             sample, bits), dev)
        for expand, seeds, L in rows:
            r, secs[f"bits{bits}_L{L}"] = _timed(lambda: sf.search(
                q, K, L, expand=expand, seeds=min(seeds, L),
                device_out=True), dev)
            out[f"bits{bits}_L{L}"] = {
                f: par.gather_dp(mesh, x).cpu().numpy()
                for f, x in zip(PAR_RESULT, r)}
        n_fused = gather.launches
        k1_same[f"byte_rows_bits{bits}"] = _k1_shard_check(gather, sf.table,
                                                          33 + bits)
        k1_same[f"rerank_base_bits{bits}"] = _k1_shard_check(
            gather, sf.base_sh, 34 + bits)
        gather.launches = n_fused
        del sf
        torch.cuda.empty_cache()
    fused_launches = gather.launches

    train = np.load(os.path.join(work, "shb_train.npy"))
    knn = np.load(os.path.join(work, "shb_knn.npy"))
    tr = tracer()
    tr.reset()
    gather.reset_launches()
    idx, secs["build"] = _timed(lambda: par.sharded_build_roargraph(
        mesh, base[:n_build], train, knn, BuildConfig(**SHB_CFG)), dev)
    build_launches = gather.launches
    spans = {k: v["total_s"] for k, v in tr.summary()["spans"].items()}
    # the build's shards: its base rows and a table of the supply graph's
    # shard shape and dtype ([N/mp, 2M] int32: the built graph's rows)
    k1_same["build_base_shard"] = _k1_shard_check(gather, par.shard_base(
        mesh, prepare_vectors(base[:n_build], METRIC, dev), "mp"), 35)
    k1_same["build_supply_shard"] = _k1_shard_check(
        gather, par.shard_base(mesh, idx.graph.neighbors, "mp"), 36)
    return {"build_s": build_s, "fused_launches": fused_launches,
            "build_launches": build_launches, "k1_same": k1_same,
            "secs": secs, "spans": spans, "coord": (mesh.coord("dp"),
                                                    mesh.coord("mp")),
            "error_flag": gather.error_flag_value(), "out": out,
            "graph": (idx.graph.ep, idx.graph.neighbors)}


def sharded_path(port, world: dict, work: str, dev: torch.device) -> int:
    """Phase 12, second part: parallel/'s second slice in 4 ranks sharing
    the card (``sharded_rank``), each result against the port's
    single-device call on the card at the ranks' batch shapes. Returns
    K1's launches in all ranks."""
    from mysteryann_tpu_torch.ops.knn import exact_knn_device
    from mysteryann_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    train = world["train_q"][:SHB_TRAIN]
    _, knn = exact_knn_device(
        torch.from_numpy(train).to(dev), world["base_dev"][:SHB_N],
        k=SHB_CFG["M_sq"], metric=METRIC)
    np.save(os.path.join(work, "shb_train.npy"), train)
    np.save(os.path.join(work, "shb_knn.npy"), knn.cpu().numpy())
    t_knn = time.perf_counter() - t0
    ep, n_q = int(world["fused_ep"]), world["eval_q"].shape[0]
    world_size = PAR_DP * PAR_MP
    t0 = time.perf_counter()
    try:
        ranks = launch.run("chip_smoke:sharded_rank", world_size,
                           (work, ep, SHB_N, str(dev)),
                           timeout=PAR_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        fail(f"sharded ranks (gloo, {world_size} on one card): {e}")
    t_ranks = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        check(r["build_s"] == 0, f"rank {r['coord']} rebuilt K1")
        check(r["fused_launches"] > 0 and r["build_launches"] > 0,
              f"rank {r['coord']} launched K1 0 times: fused "
              f"{r['fused_launches']}, build {r['build_launches']}")
        check(all(r["k1_same"].values()),
              f"K1 differs from gather_rows_ref on rank {r['coord']}'s "
              f"shards: {r['k1_same']}")
        check(r["error_flag"] == 0, f"rank {r['coord']}: K1 met an "
                                    "out-of-range index")
        for key, res in r["out"].items():
            check(all(np.array_equal(v, r0["out"][key][f])
                      for f, v in res.items()),
                  f"ranks disagree on the gathered {key} results")
        check(r["graph"][0] == r0["graph"][0]
              and np.array_equal(r["graph"][1], r0["graph"][1]),
              f"rank {r['coord']} built another graph than rank 0")

    # (a) against FusedSearcher on the card at the ranks' batch
    index, gt_i = _fused_index(work, ep), world["gt_i"]
    rows = {}
    for max_degree, sample, bits, cfg_rows in SHF_CONFIGS:
        fs = port.FusedSearcher(index, world["base_dev"],
                                max_degree=max_degree, seed_sample=sample,
                                bits=bits)
        for expand, seeds, L in cfg_rows:
            name = f"bits{bits}_L{L}"
            want = fs.search(world["eval_q"], K, L, query_batch=n_q // PAR_DP,
                             visited_mode="merge", expand=expand,
                             seeds=min(seeds, L))
            got = r0["out"][name]
            same = {f: bool(np.array_equal(got[f], w))
                    for f, w in zip(PAR_RESULT, want)}
            rows[name] = {"max_degree": max_degree, "expand": expand,
                          "seeds": seeds, "L_pq": L, "equal": same,
                          "recall@10": port.compute_recall(got["ids"], gt_i,
                                                           K),
                          "single_recall@10": port.compute_recall(
                              want[0], gt_i, K),
                          "seconds": max(r["secs"][name] for r in ranks)}
            check(all(same.values()), f"ShardedFusedSearcher {name} vs "
                                      f"FusedSearcher: {same}")
        del fs
        torch.cuda.empty_cache()

    # (b) against build_roargraph on the card at the ranks' batches
    cfg = dict(SHB_CFG, query_batch=SHB_CFG["query_batch"] // PAR_DP,
               search_batch=SHB_CFG["search_batch"] // PAR_DP)
    t0 = time.perf_counter()
    want = port.build_roargraph(world["base_dev"][:SHB_N], train,
                                knn.cpu().numpy(), port.BuildConfig(**cfg),
                                verbose=False).graph
    t_single = time.perf_counter() - t0
    ep_g, nb_g = r0["graph"]
    diff = np.nonzero((nb_g != want.neighbors).any(axis=1))[0]
    st = port.PaddedGraph(neighbors=nb_g, ep=ep_g).degree_stats()
    build = {"n": SHB_N, "train": SHB_TRAIN, "reduced": SHB_REDUCED,
             "ep_equal": ep_g == want.ep, "rows_differing": int(diff.size),
             "first_differing_row": int(diff[0]) if diff.size else None,
             "degree": st, "single_device_s": t_single,
             "seconds": max(r["secs"]["build"] for r in ranks),
             "phases_s_rank0": r0["spans"]}
    check(ep_g == want.ep and diff.size == 0,
          f"sharded build vs build_roargraph: {build}")
    fused_l = [r["fused_launches"] for r in ranks]
    build_l = [r["build_launches"] for r in ranks]
    phase("parallel_sharded", ranks=world_size, mesh=f"{PAR_DP}x{PAR_MP}",
          note=PAR_NOTE, queries=n_q, fused=rows, build=build,
          seconds_per_call={k: max(r["secs"][k] for r in ranks)
                            for k in r0["secs"]},
          train_knn_s=t_knn, spawn_and_run_s=t_ranks,
          k1_launches_fused_per_rank=fused_l,
          k1_launches_build_per_rank=build_l,
          k1_shards_bit_identical=True)
    return sum(fused_l) + sum(build_l)


def parallel_path(port, world: dict, work: str, dev: torch.device) -> int:
    """Phase 12: parallel/ on the 1M world. 4 ranks (dp=2 x mp=2) share
    the card ``dev`` over gloo; each result against the port's
    single-device call on the card; then the second slice
    (`sharded_path`) and a 1x1 mesh over NCCL in one rank, bit for bit.
    Returns K1's launches in all ranks."""
    from mysteryann_tpu_torch.parallel import launch
    from mysteryann_tpu_torch.search.beam import search_batched

    t0 = time.perf_counter()
    np.save(os.path.join(work, "base.npy"), world["base"])
    np.save(os.path.join(work, "neighbors.npy"), world["neighbors"])
    np.save(os.path.join(work, "eval_q.npy"), world["eval_q"])
    np.save(os.path.join(work, "fused_neighbors.npy"),
            world["fused_neighbors"])
    t_write = time.perf_counter() - t0
    ep, n_q = int(world["ep"]), world["eval_q"].shape[0]
    world_size = PAR_DP * PAR_MP
    t0 = time.perf_counter()
    try:
        ranks = launch.run("chip_smoke:parallel_rank", world_size,
                           (work, ep, str(dev)), timeout=PAR_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        fail(f"parallel ranks (gloo, {world_size} on one card): {e}")
    t_ranks = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        check(r["build_s"] == 0, f"rank {r['coord']} rebuilt K1")
        check(r["launches"] > 0, f"rank {r['coord']} launched K1 0 times")
        check(all(r["k1_same"].values()),
              f"K1 differs from gather_rows_ref on rank {r['coord']}'s "
              f"shards: {r['k1_same']}")
        check(r["error_flag"] == 0, f"rank {r['coord']}: K1 met an "
                                    "out-of-range index")
        for key, res in r["out"].items():
            check(all(np.array_equal(v, r0["out"][key][f])
                      for f, v in res.items()),
                  f"ranks disagree on the gathered {key} results")
    out, gt_i, gt_d = r0["out"], world["gt_i"], world["gt_d"]

    # the single-device calls on the card, at the ranks' batch shapes
    nb_dev = torch.from_numpy(world["neighbors"]).to(dev)
    eps = torch.tensor([ep], dtype=torch.int32, device=dev)
    rows = {}
    knn_ids = _agree(out["knn"]["ids"], gt_i)
    knn_close = bool(np.allclose(out["knn"]["dists"], gt_d, rtol=1e-4,
                                 atol=1e-4))
    rows["knn"] = {"ids_agree": knn_ids, "dists_close": knn_close}
    check(knn_ids >= 0.999 and knn_close,
          f"sharded kNN vs single-device: ids {knn_ids}, dists close "
          f"{knn_close}")
    for name, qb in (("beam", n_q // PAR_DP),
                     ("query_parallel", n_q // world_size)):
        ids, dists, cmps, hops = search_batched(
            world["base_dev"], nb_dev, eps, world["eval_q"], K, PAR_L,
            METRIC, query_batch=qb, visited_mode="pool", expand=2)
        got = out[name]
        rows[name] = {"ids_agree": _agree(got["ids"], ids),
                      "hops_equal": bool(np.array_equal(got["hops"], hops)),
                      "cmps_equal": bool(np.array_equal(got["cmps"], cmps)),
                      "recall@10": port.compute_recall(got["ids"], gt_i, K),
                      "single_recall@10": port.compute_recall(ids, gt_i, K)}
        check(rows[name]["hops_equal"] and rows[name]["cmps_equal"]
              and rows[name]["ids_agree"] >= 0.999,
              f"{name} vs single-device beam_search: {rows[name]}")
    del nb_dev
    for store in ("f32", "int8"):
        idx = port.IVFIndex.load(os.path.join(work, f"ivf_{store}.npz"),
                                 device=dev)
        ids, dists = idx.search(world["eval_q"], K, nprobe=PAR_NPROBE,
                                query_batch=n_q // PAR_DP)
        del idx
        got = out[f"ivf_{store}"]
        rec = port.compute_recall(got["ids"], gt_i, K)
        rec1 = port.compute_recall(ids, gt_i, K)
        rows[f"ivf_{store}"] = {"ids_agree": _agree(got["ids"], ids),
                                "recall@10": rec, "single_recall@10": rec1}
        if store == "f32":
            close = bool(np.allclose(got["dists"], dists, rtol=1e-5,
                                     atol=1e-5))
            rows["ivf_f32"]["dists_close"] = close
            check(close and rows["ivf_f32"]["ids_agree"] >= 0.99,
                  f"ShardedIVF f32 vs single-device: {rows['ivf_f32']}")
        else:
            # raw s32 scores tie often: ids as sets within equal scores
            ties = _agree_ties(got["ids"], ids, got["dists"], dists)
            rows["ivf_int8"]["ids_agree_ties"] = ties
            check(abs(rec - rec1) <= 0.02 and ties >= 0.99,
                  f"ShardedIVF int8 vs single-device: recall {rec:.4f} vs "
                  f"{rec1:.4f}, ids within ties {ties:.5f}")
    torch.cuda.empty_cache()
    secs = {k: max(r["secs"][k] for r in ranks) for k in r0["secs"]}
    launches = [r["launches"] for r in ranks]
    phase("parallel", ranks=world_size, mesh=f"{PAR_DP}x{PAR_MP}",
          backend=r0["backend"], device=r0["device"], note=PAR_NOTE,
          queries=n_q, L=PAR_L, nprobe=PAR_NPROBE, seconds_per_call=secs,
          spawn_and_run_s=t_ranks, write_inputs_s=t_write,
          k1_launches_per_rank=launches, k1_shards_bit_identical=True,
          **rows)
    k1_sharded = sharded_path(port, world, work, dev)

    t0 = time.perf_counter()
    try:
        nccl = launch.run("chip_smoke:parallel_nccl_rank", 1,
                          (work, ep, int(world["fused_ep"]), str(dev)),
                          timeout=PAR_TIMEOUT_S)[0]
    except (RuntimeError, TimeoutError) as e:
        fail(f"parallel NCCL rank (1x1 mesh): {e}")
    phase("parallel_nccl", ranks=1, mesh="1x1", backend=nccl["backend"],
          device=nccl["device"], queries=PAR_NCCL_QUERIES,
          bit_identical=nccl["same"], k1_launches=nccl["launches"],
          seconds=time.perf_counter() - t0)
    check(nccl["backend"] == "nccl", f"the 1x1 run took {nccl['backend']}")
    check(nccl["build_s"] == 0, "the NCCL rank rebuilt K1")
    check(nccl["launches"] > 0, "the NCCL rank launched K1 0 times")
    check(nccl["error_flag"] == 0, "the NCCL rank: K1 met an out-of-range "
                                   "index")
    check(all(nccl["same"].values()),
          f"1x1 NCCL mesh vs single-device: {nccl['same']}")
    return sum(launches) + k1_sharded + nccl["launches"]


def cli_path(world: dict, gather, fused_index, tmp_root: str = HERE) -> int:
    """Phase 9: compute_gt, search_flat and search_roargraph (fused,
    seeded) through their main() on the world written as .fbin files.
    Returns the K1 launches of the fused search CLI."""
    from mysteryann_tpu_torch.cli import (compute_gt, search_flat,
                                          search_roargraph)
    from mysteryann_tpu_torch.io import write_fbin

    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        base_p = os.path.join(tmp, "base.fbin")
        q_p = os.path.join(tmp, "eval.fbin")
        gt_p = os.path.join(tmp, "gt.bin")
        idx_p = os.path.join(tmp, "fused.index")
        t0 = time.perf_counter()
        write_fbin(base_p, world["base"])
        write_fbin(q_p, world["eval_q"])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc_gt = compute_gt.main([
                "--base_data_path", base_p, "--query_path", q_p,
                "--k", str(K), "--dist", METRIC, "--format", "gt",
                "--out_path", gt_p])
        check(rc_gt == 0, f"compute_gt exited {rc_gt}")
        with contextlib.redirect_stdout(out):
            rc_flat = search_flat.main([
                "--base_data_path", base_p, "--query_path", q_p,
                "--gt_path", gt_p, "--k", str(K), "--dist", METRIC,
                "--query_batch", "8192", "--precision", "int8"])
        check(rc_flat == 0, f"search_flat exited {rc_flat}")
        lines = out.getvalue().strip().splitlines()
        recall = float(lines[-1].split()[4])
        phase("cli", compute_gt_rc=rc_gt, search_flat_rc=rc_flat,
              search_flat_row=lines[-1].split(), recall=recall,
              seconds=time.perf_counter() - t0)
        check(recall >= 0.99, f"search_flat (int8) recall {recall} < 0.99")

        fused_index.save(idx_p)
        t0 = time.perf_counter()
        out = io.StringIO()
        gather.reset_launches()
        with contextlib.redirect_stdout(out):
            rc = search_roargraph.main([
                "--base_data_path", base_p, "--projection_index_save_path",
                idx_p, "--query_path", q_p, "--gt_path", gt_p,
                "--k", str(K), "--engine", "fused", "--seeds", "40",
                "--seed_sample", "2", "--expand", "4", "--L_pq", "64",
                "--query_batch", "8192"])
        launches = gather.launches
        check(rc == 0, f"search_roargraph --engine fused exited {rc}")
        row = out.getvalue().strip().splitlines()[-1].split()
        recall = float(row[4])
        phase("cli_fused", search_roargraph_rc=rc, row=row, recall=recall,
              k1_launches=launches, seconds=time.perf_counter() - t0)
    check(launches > 0, "search_roargraph --engine fused launched K1 0 "
                        "times")
    check(recall >= TARGET_RECALL, f"search_roargraph --engine fused recall "
                                   f"{recall} < {TARGET_RECALL}")
    return launches + cli_slice_path(world, gather, tmp_root)


def _last_row(out: io.StringIO) -> list:
    return [ln.split() for ln in out.getvalue().splitlines()
            if ln.split()[:1] and ln.split()[0].isdigit()][-1]


def cli_slice_path(world: dict, gather, tmp_root: str = HERE) -> int:
    """Phase 12, second part: export_fbin writes a 200k-row slice of the
    base, the train queries and 2,048 eval queries from .npy; compute_gt, build_bipartite → search_bipartite and
    build_ivf → search_ivf run on it through main(). Returns their K1
    launches."""
    from mysteryann_tpu_torch.cli import (build_bipartite, build_ivf,
                                          compute_gt, export_fbin,
                                          search_bipartite, search_ivf)

    launches = 0
    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        p = {name: os.path.join(tmp, name) for name in (
            "base.npy", "train.npy", "eval.npy", "base.fbin", "train.fbin",
            "eval.fbin", "gt.bin", "bip.index", "ivf.npz")}
        t0 = time.perf_counter()
        np.save(p["base.npy"], world["base"][:CLI_SLICE])
        np.save(p["train.npy"], world["train_q"])
        np.save(p["eval.npy"], world["eval_q"][:CLI_BIPARTITE_QUERIES])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            for name in ("base", "train", "eval"):
                check(export_fbin.main(["--npy", p[f"{name}.npy"], "--out",
                                        p[f"{name}.fbin"]]) == 0,
                      f"export_fbin ({name}) failed")
            check(compute_gt.main([
                "--base_data_path", p["base.fbin"], "--query_path",
                p["eval.fbin"], "--k", str(K), "--dist", METRIC,
                "--format", "gt", "--out_path", p["gt.bin"]]) == 0,
                "compute_gt (slice) failed")
        gather.reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc_b = build_bipartite.main([
                "--base_data_path", p["base.fbin"],
                "--sampled_query_data_path", p["train.fbin"],
                "--bipartite_index_save_path", p["bip.index"],
                "--M_sq", "64", "--M_pjbp", "32", "--base_row_cap",
                str(BIPARTITE_CAP), "--dist", METRIC, "--query_batch",
                "8192"])
            rc_s = search_bipartite.main([
                "--base_data_path", p["base.fbin"], "--query_path",
                p["eval.fbin"], "--gt_path", p["gt.bin"],
                "--bipartite_index_save_path", p["bip.index"], "--k", str(K),
                "--L_pq", "100", "--query_batch",
                str(CLI_BIPARTITE_QUERIES)])
        l_bip = gather.launches
        check(rc_b == 0 and rc_s == 0,
              f"build_bipartite / search_bipartite exited {rc_b} / {rc_s}")
        row_b = _last_row(out)
        gather.reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc_bi = build_ivf.main([
                "--base_data_path", p["base.fbin"], "--index_save_path",
                p["ivf.npz"], "--store", "int8", "--dist", METRIC])
            rc_si = search_ivf.main([
                "--index_path", p["ivf.npz"], "--base_data_path",
                p["base.fbin"], "--query_path", p["eval.fbin"], "--gt_path",
                p["gt.bin"], "--k", str(K), "--nprobe", "16", "64",
                "--rerank", str(IVF_RERANK), "--query_batch", "8192"])
        l_ivf = gather.launches
        check(rc_bi == 0 and rc_si == 0,
              f"build_ivf / search_ivf exited {rc_bi} / {rc_si}")
        row_i = _last_row(out)
        phase("cli_slice", rows=CLI_SLICE, search_bipartite_row=row_b,
              search_ivf_row=row_i, k1_launches_bipartite=l_bip,
              k1_launches_ivf=l_ivf, seconds=time.perf_counter() - t0)
    check(l_bip > 0 and l_ivf > 0,
          f"the bipartite / IVF CLIs launched K1 {l_bip} / {l_ivf} times")
    check(float(row_b[4]) >= BIPARTITE_FLOOR,
          f"search_bipartite recall {row_b[4]} < {BIPARTITE_FLOOR}")
    # floors against a broken search (1M world, in-process: .860 at nprobe
    # 64; the 200k slice's 894 clusters: .891 — measured on one H100)
    check(float(row_i[4]) >= 0.8,
          f"search_ivf (int8, rerank, nprobe 64) recall {row_i[4]} < 0.8")
    return l_bip + l_ivf


def _script(name: str):
    """A benchmark script under scripts/, imported by path."""
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(name)[0], os.path.join(HERE, "scripts", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def large_fold(dev, n: int = LARGE_N, W: int = 64, M: int = 32,
               rounds: int = 16, n_edges: int = 12_800_000) -> dict:
    """Phase 13: the bounded-memory fold and the host reverse aggregation
    against the single-fold / device paths, bit for bit, at 4M rows."""
    from mysteryann_tpu_torch.graph import roargraph as rg

    g = torch.Generator(device=dev)
    g.manual_seed(13)
    chunk = -(-n // rounds)
    r0 = 5 * chunk
    supply = torch.randint(0, n, (n, W), generator=g, device=dev,
                           dtype=torch.int32)
    deg = torch.randint(0, W, (n, 1), generator=g, device=dev)
    supply = torch.where(torch.arange(W, device=dev)[None, :] < deg, supply,
                         n).contiguous()
    del deg
    # ~1% sentinel entries, as a pruned list that came up short has
    lists = torch.randint(0, n + n // 100, (chunk, M), generator=g,
                          device=dev, dtype=torch.int32)

    def timed(fn):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_gib = torch.cuda.memory_allocated() / 2**30
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, (
            torch.cuda.max_memory_allocated() / 2**30 - base_gib)

    (a_supply, a_rev, a_fit), t_single, peak_single = timed(
        lambda: rg._fold_round_device(supply.clone(), lists, r0))
    over = torch.nonzero(~a_fit)[:, 0].to(torch.int32)
    want_rev = a_rev[over.long()]
    del a_rev
    slab_rows = 1 << 20

    def slab_fold():
        b = rg._fold_own_rows(supply.clone(), lists, r0)
        fits = []
        for lo in range(0, n, slab_rows):
            b, fit = rg._fold_slab(b, lists, r0, lo, slab_rows)
            fits.append(fit)
        fit = torch.cat(fits)
        ids = torch.nonzero(~fit)[:, 0].to(torch.int32)
        return b, fit, rg._rev_rows_for_ids(lists, r0, ids, n, W)

    (b_supply, b_fit, b_rev), t_slab, peak_slab = timed(slab_fold)
    same = {"supply": torch.equal(a_supply, b_supply),
            "fit": torch.equal(a_fit, b_fit),
            "overflow_rev_rows": torch.equal(want_rev, b_rev)}
    n_over = int(over.shape[0])
    del a_supply, b_supply, a_fit, b_fit, want_rev, b_rev, supply, lists

    # reverse aggregation: phase B+C's edge count at 4M rows and 400k train
    # queries, distances quantized so that ties are common
    e_src = torch.randint(0, n, (n_edges,), generator=g, device=dev)
    e_dst = torch.randint(0, n, (n_edges,), generator=g, device=dev)
    e_dist = (torch.randint(0, 4096, (n_edges,), generator=g, device=dev)
              .float() / 64)
    r_max = 3 * M
    dev_rev, t_dev, peak_dev = timed(lambda: rg._aggregate_reverse_device(
        e_src.to(torch.int32), e_dst.to(torch.int32), e_dist, n=n,
        r_max=r_max))
    t0 = time.perf_counter()
    host_rev = rg._aggregate_reverse(e_src.cpu().numpy(), e_dst.cpu().numpy(),
                                     e_dist.cpu().numpy(), n, r_max)
    t_host = time.perf_counter() - t0
    same["reverse_aggregation"] = torch.equal(
        dev_rev, torch.from_numpy(host_rev).to(dev))
    del dev_rev, host_rev, e_src, e_dst, e_dist
    torch.cuda.empty_cache()
    phase("large_fold", n=n, W=W, M=M, chunk_rows=chunk, overflow_rows=n_over,
          slab_rows=slab_rows, bit_identical=same,
          single_fold_s=t_single, slab_fold_s=t_slab,
          single_fold_peak_gib=peak_single, slab_fold_peak_gib=peak_slab,
          edges=n_edges, aggregate_device_s=t_dev, aggregate_host_s=t_host,
          aggregate_device_peak_gib=peak_dev)
    check(all(same.values()), f"the bounded-memory paths differ: {same}")
    check(n_over > 0, "no row overflowed in the 4M fold: the case is empty")
    return same


def large_build(port, gather, dev) -> int:
    """Phase 14: the 4M world of scripts/torch_bench_4m_fused.py, built with
    engine "auto" and served by seeded FusedSearcher. Returns K1 launches."""
    from mysteryann_tpu_torch.graph.roargraph import (_build_memory_plan,
                                                      device_memory)
    from mysteryann_tpu_torch.search.fused import _row_bytes
    from mysteryann_tpu_torch.utils.trace import tracer

    from mysteryann_tpu_torch.ops import select

    drv = _script("torch_bench_4m_fused.py")
    n = LARGE_N
    t0 = time.perf_counter()
    base, train_q, eval_q = drv.make_world(n, LARGE_TRAIN, LARGE_EVAL, DIM)
    t_data = time.perf_counter() - t0
    base_dev = port.prepare_vectors(base, METRIC, dev)
    del base
    select.reset_launches()
    t0 = time.perf_counter()
    gt_d, gt_i = port.exact_knn(eval_q, base_dev, k=K, metric=METRIC,
                                query_batch=4096, base_tile=131072,
                                precision="highest")
    t_gt = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, knn = port.exact_knn(train_q, base_dev, k=drv.M_SQ, metric=METRIC,
                            query_batch=8192, base_tile=131072)
    t_knn = time.perf_counter() - t0
    K3_LAUNCHES["large_knn"] = select.launches
    phase("large_data", n_base=n, n_train=LARGE_TRAIN, n_eval=LARGE_EVAL,
          dim=DIM, data_s=t_data, gt_s=t_gt, train_knn_s=t_knn,
          k3_launches=select.launches, reduced=LARGE_REDUCED)
    check(select.launches > 0, "the 4M exact kNN launched K3 0 times")

    cfg = drv.build_config(LARGE_PASSES, "auto")
    plan = _build_memory_plan(cfg, n, DIM, device_memory(dev))
    phase("large_plan", engine=plan.engine, fold=plan.fold,
          slab_rows=plan.slab_rows, memory_gb=plan.memory / 1e9,
          bytes_gb={k: v / 1e9 for k, v in plan.bytes.items()})
    tr = tracer()
    tr.reset()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gather.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = port.build_roargraph(base_dev, train_q, knn, cfg, verbose=True)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build_launches = gather.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    spans = tr.summary()["spans"]
    st = index.graph.degree_stats()
    reach = reachable_all(index.graph.neighbors, index.graph.ep)
    flag = gather.error_flag_value()
    phase("large_build", engine=plan.engine, fold=plan.fold,
          passes=LARGE_PASSES, seconds=t_build,
          phases_s={k: v["total_s"] for k, v in spans.items()},
          degree=st, all_reachable=reach, k1_launches=build_launches,
          error_flag=flag, peak_gb=peak, reduced=LARGE_REDUCED)
    check(build_launches > 0, "the 4M build launched K1 0 times")
    check(flag == 0, "the gather kernel met an out-of-range index (4M build)")
    check(st["zero"] == 0, f"4M build: {st['zero']} zero-degree nodes")
    check(st["max"] <= 2 * cfg.M_pjbp,
          f"4M build: max degree {st['max']} > {2 * cfg.M_pjbp}")
    check(reach, "4M build: not every node is reachable")
    index.graph.validate()
    del knn, train_q

    # K1 against its plain version at the shapes this build gave it: the
    # live f32 base, and tables of the supply's and the phase-D byte rows'
    # shapes (the build frees its own before it returns)
    torch.cuda.empty_cache()
    W = 2 * cfg.M_pjbp
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    k1 = {"base_f32": k1_on_table(gather, base_dev, "the 4M base", 65536)}
    supply = torch.randint(0, n + 1, (n, W), generator=g, device=dev,
                           dtype=torch.int32)
    k1["supply_i32"] = k1_on_table(gather, supply, "4M supply rows", 65536)
    del supply
    table = random_bytes((n + 1, _row_bytes(W, DIM, cfg.connectivity_bits)),
                         dev, 14)
    k1["build_rows_u8"] = k1_on_table(gather, table, "4M phase-D byte rows")
    del table

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gather.reset_launches()
    fs = port.FusedSearcher(index, base_dev, max_degree=32, seed_sample=2,
                            bits=4)
    rows = []
    for seeds, L in LARGE_SWEEP:
        r = fs.benchmark(eval_q, k=K, L=L, query_batch=8192, expand=4,
                         seeds=seeds, warmup=1)
        check(np.isfinite(r["dists"]).all()
              and r["ids"].shape == (eval_q.shape[0], K),
              f"4M fused L={L}: results not finite / wrong shape")
        row = {"seeds": seeds, "L_pq": L, "qps": r["qps"],
               "recall@10": port.compute_recall(r["ids"], gt_i, K),
               "rderr": port.compute_rderr(r["dists"], gt_d, K, METRIC),
               "avg_hops": r["avg_hops"]}
        rows.append(row)
        phase("large_serve", **row)
    serve_launches = gather.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    k1["serve_rows_u8"] = k1_on_table(gather, fs.table,
                                      "the 4M serving table")
    phase("large_k1", **k1)
    best = max(r["recall@10"] for r in rows)
    phase("large_serve_summary", k1_launches=serve_launches,
          best_recall=best, table_gb=fs.table.numel() / 1e9,
          peak_gb=peak_gb)
    check(serve_launches > 0, "4M fused serving launched K1 0 times")
    check(best >= LARGE_RECALL_FLOOR,
          f"no 4M fused row reached recall@10 >= {LARGE_RECALL_FLOOR} "
          f"(best {best:.4f})")
    check(gather.error_flag_value() == 0,
          "the gather kernel met an out-of-range index (4M serving)")
    del fs, index, base_dev
    torch.cuda.empty_cache()
    return build_launches + serve_launches


def device_world(port, gather, dev, n: int = WORLD_N) -> int:
    """Phase 15: the index-keyed corpus on the card, then the 50M script's
    pipeline at 10M rows. Returns the K1 launches of the IVF searches."""
    from mysteryann_tpu_torch.io.synthetic import CrossModalDeviceSpec

    drv = _script("torch_bench_50m.py")
    spec = drv.make_spec(DIM, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    idx = torch.randint(0, 50_000_000, (100_000,), generator=g, device=dev,
                        dtype=torch.int32)
    whole, cid = spec.rows(idx), spec.concept_ids(idx)
    parts = torch.cat([spec.rows(c) for c in idx.split(7_777)])
    cid_parts = torch.cat([spec.concept_ids(c) for c in idx.split(7_777)])
    shape_err = float((whole - parts).abs().max())
    cpu = CrossModalDeviceSpec(DIM, metric="ip", seed=drv.SEED, device="cpu",
                               **drv.WORLD)
    few = idx[:4096]
    cpu_same = torch.equal(cpu.concept_ids(few.cpu()), cid[:4096].cpu())
    cpu_err = float((cpu.rows(few.cpu()) - whole[:4096].cpu()).abs().max())
    norm_err = float((whole.norm(dim=1) - 1).abs().max())
    t_gen = time_ms(lambda: spec.base_tile(0, WORLD_TILE), reps=1, trials=3)
    phase("device_world", draws="threefry2x32, jax.random key layout",
          concept_ids_same_across_shapes=torch.equal(cid, cid_parts),
          rows_max_abs_diff_across_shapes=shape_err,
          concept_ids_same_as_cpu=cpu_same, rows_max_abs_diff_vs_cpu=cpu_err,
          norm_err=norm_err, tile_rows=WORLD_TILE, tile_ms=t_gen,
          rows_per_s=WORLD_TILE / t_gen * 1e3)
    check(torch.equal(cid, cid_parts) and cpu_same,
          "concept ids depend on the batch shape or the device")
    check(shape_err <= WORLD_ROW_ATOL and cpu_err <= WORLD_ROW_ATOL,
          f"generated rows differ across shapes ({shape_err}) or from the "
          f"CPU ({cpu_err}) by more than {WORLD_ROW_ATOL}")
    check(norm_err <= 1e-5, f"generated rows are not unit norm ({norm_err})")
    del whole, parts, cid, cid_parts

    eval_q = spec.queries(WORLD_EVAL)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bd, bi = drv.streamed_gt(spec, eval_q, n, WORLD_TILE)
    torch.cuda.synchronize()
    t_gt = time.perf_counter() - t0
    gt_i, gt_d = bi.cpu().numpy().astype(np.int64), bd.cpu().numpy()
    check(np.isfinite(gt_d).all() and (gt_i < n).all() and (gt_i >= 0).all(),
          "streamed ground truth not finite / ids out of range")
    t0 = time.perf_counter()
    index = port.build_ivf_streaming(spec.base_tile, n, DIM, metric=METRIC,
                                     tile=WORLD_TILE, seed=drv.SEED,
                                     rows_fn=spec.rows, verbose=True)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    phase("device_world_build", n=n, gt_queries=WORLD_EVAL, gt_s=t_gt,
          ivf_build_s=t_build, n_clusters=index.n_clusters, cap=index.cap,
          blocks=list(index.blocks.shape),
          waste=index.n_clusters * index.cap / n,
          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
          reduced=WORLD_REDUCED)
    # K1 against its plain version on this index's own blocks, C = 4 and 64
    phase("device_world_k1", blocks=list(index.blocks.shape),
          bit_identical=True, timings=ivf_k1_blocks(gather, index))
    gather.reset_launches()
    rows = []
    for nprobe in WORLD_NPROBES:
        row = drv.bench(drv.ivf_search_fn(index, spec, n, nprobe,
                                          WORLD_RERANK),
                        eval_q, WORLD_EVAL, f"ivf_i8_p{nprobe}", gt_i, gt_d)
        rows.append(row)
        phase("device_world_ivf", nprobe=nprobe, rerank=WORLD_RERANK, **row)
    launches = gather.launches
    gate = drv.ivf_search_fn(index, spec, n, index.n_clusters, WORLD_RERANK)
    ids, dists = gate(eval_q[:WORLD_GATE_QUERIES])
    exact = port.compute_recall(ids.cpu().numpy().astype(np.int64),
                                gt_i[:WORLD_GATE_QUERIES], K)
    phase("device_world_exact", nprobe=index.n_clusters,
          queries=WORLD_GATE_QUERIES, rerank=WORLD_RERANK,
          **{"recall@10": exact}, k1_launches=launches,
          error_flag=gather.error_flag_value())
    check(launches > 0, "the 10M IVF searches launched K1 0 times")
    check(exact >= IVF_EXACT_FLOORS["int8"],
          f"10M ivf-int8 at nprobe = n_clusters: recall@10 {exact:.4f} < "
          f"{IVF_EXACT_FLOORS['int8']}")
    check(rows[-1]["recall"] >= rows[0]["recall"],
          f"10M IVF recall falls as nprobe rises: {rows}")
    check(gather.error_flag_value() == 0,
          "the gather kernel met an out-of-range index (device world)")
    index.free()
    torch.cuda.empty_cache()
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA device and has no CPU fallback")
    t_start = time.perf_counter()
    port = import_port()
    from mysteryann_tpu_torch.ops import gather, scan, score_select, select

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    phase("device", name=name, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # one nvcc per source, all started together
    kernels = (gather, scan, select, score_select)
    with ThreadPoolExecutor(len(kernels)) as ex:
        futures = [ex.submit(m.build, True) for m in kernels]
        secs = [f.result() for f in futures]
    for m, src, sec in zip(kernels, (KERNEL_SOURCE, SCAN_SOURCE,
                                     SELECT_SOURCE, SCORE_SOURCE), secs):
        phase("build_kernel", source=src, seconds=sec,
              ptxas=[ln.strip() for ln in m.build_log.splitlines()
                     if "registers" in ln or "spill" in ln])

    k1 = kernel_checks(gather, dev)
    kernel_fused_rows(gather, dev)
    k2 = kernel_scan(scan, dev)
    k3 = kernel_select(select, dev)
    k3f = kernel_score_select(score_select, dev)
    run = main_path(port, gather, dev, 1_000_000, 200_000, 8192)
    flat = flat_path(port, gather, scan, run)
    fused = fused_path(port, gather, run)
    k1_seeded = seeded_build_path(port, gather, run)["k1_launches"]
    seed_scan_k3f(port, score_select, run, fused["index"])
    run["fused_neighbors"] = fused["index"].graph.neighbors
    run["fused_ep"] = fused["index"].graph.ep
    k1_twin = bench_twin_path(gather, run, fused)
    k1_probe = probe_variance_path(port, gather, run, fused)
    native_path(fused["index"])
    k1_bip = bipartite_path(port, gather, run)
    with tempfile.TemporaryDirectory(dir=HERE) as work:
        ivf = ivf_path(port, gather, run, save_dir=work)
        k1_par = parallel_path(port, run, work, dev)
    k1_cli = cli_path(run, gather, fused["index"])
    run_launches, fused_launches = run["launches"], fused["k1_launches"]
    del run, fused      # the 1M world makes room for the larger ones
    torch.cuda.empty_cache()
    large_fold(dev)
    k1_large = large_build(port, gather, dev)
    k1_world = device_world(port, gather, dev)
    phase("k3_launches", **K3_LAUNCHES)
    check(all(K3_LAUNCHES.get(p, 0) > 0 for p in
              ("main_path", "flat", "fused", "ivf", "large_knn")),
          f"a main-path phase launched K3 0 times: {K3_LAUNCHES}")
    phase("k3f_launches", **K3F_LAUNCHES,
          unfused=dict(K3F_UNFUSED))
    check(all(K3F_LAUNCHES.get(p, 0) > 0 for p in
              ("flat", "fused_build", "fused")),
          f"a main-path phase launched K3f 0 times: {K3F_LAUNCHES}")
    phase("smoke", seconds=time.perf_counter() - t_start)

    print(json.dumps({"kernels": [
        {"name": "gather_rows", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES,
         "launches": (run_launches + flat["k1_launches"]
                      + fused_launches + k1_seeded + k1_twin + k1_probe
                      + k1_bip
                      + ivf["k1_launches"]
                      + k1_par + k1_cli + k1_large + k1_world),
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]},
        {"name": "binned_scan", "route": "cuda", "source": SCAN_SOURCE,
         "replaces": SCAN_REPLACES, "launches": flat["k2_launches"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"]},
        {"name": "topk_smallest", "route": "cuda", "source": SELECT_SOURCE,
         "replaces": SELECT_REPLACES,
         "launches": sum(K3_LAUNCHES.values()),
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"]},
        {"name": "score_select", "route": "cuda", "source": SCORE_SOURCE,
         "replaces": SCORE_REPLACES,
         "launches": sum(K3F_LAUNCHES.values()),
         "max_abs_err": k3f["max_abs_err"], "ms": k3f["ms"],
         "plain_ms": k3f["plain_ms"], "bound_ms": k3f["bound_ms"],
         "bound_by": k3f["bound_by"], "library_ms": k3f["library_ms"],
         "library": "a bf16 torch.matmul, then torch.topk: no single "
                    "PyTorch call computes the function"}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
