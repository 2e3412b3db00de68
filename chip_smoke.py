"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): build, check and
time both hand-written kernels (the row gather K1 and the binned scan K2),
drive the RoarGraph build-then-search path once at full width, then the
flat serving path in four precisions, the fused engine (the bench's build
recipe and its seeded serving sweep) and three CLIs on the same world.

    python3 chip_smoke.py     # 1M x 128 base, 200k train queries, one card

Phases, one line each before the last:
  1. device: the card's name and power limit (there is no CPU fallback);
  2. build_kernel: nvcc compiles csrc/gather.cu and csrc/scan.cu, in
     parallel, into mysteryann_tpu_torch/build/; ptxas registers / spills;
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
  9. cli: the port's compute_gt, search_flat (int8) and search_roargraph
     (--engine fused, seeded) CLIs through their main() on the same world
     written as .fbin files.
Then a JSON line with the kernels' records, and last a JSON line with the
device. Any failed check exits non-zero before the last line is printed.
"""

from __future__ import annotations

import contextlib
import io
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


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(tag: str, **fields) -> None:
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


def kernel_checks(gather, dev) -> dict:
    """Phase 3: the kernel against index_select at the listed shapes."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cases = [
        ("f32", (1_000_000, 128), torch.float32, 65536),
        ("i32", (1_000_000, 64), torch.int32, 65536),
        ("i8_odd_width", (4096, 48), torch.int8, 65536),
        ("bf16", (10_000, 96), torch.bfloat16, 65536),
        ("empty", (1000, 128), torch.float32, 0),
    ]
    max_err = 0.0
    timings = {}
    for name, shape, dt, n_idx in cases:
        if dt.is_floating_point:
            table = torch.randn(shape, generator=g, device=dev).to(dt)
        else:
            table = torch.randint(-100, 100, shape, generator=g, device=dev,
                                  dtype=torch.int32).to(dt)
        idx = torch.randint(0, shape[0], (n_idx,), generator=g, device=dev,
                            dtype=torch.int32)
        if n_idx:
            idx[0], idx[-1] = 0, shape[0] - 1
        for ix in (idx, idx.long()):
            got = gather.gather_rows(table, ix)
            want = gather.gather_rows_ref(table, ix)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"kernel {name}: shape/dtype {got.shape} {got.dtype}")
            equal = torch.equal(got, want)
            err = (float((got.float() - want.float()).abs().max())
                   if got.numel() else 0.0)
            max_err = max(max_err, err)
            check(equal, f"kernel {name} ({ix.dtype}): differs from "
                         f"index_select, max abs err {err}")
        if name in ("f32", "i32"):
            timings[name] = {
                "kernel_ms": time_ms(lambda: gather.gather_rows(table, idx)),
                "plain_ms": time_ms(
                    lambda: gather.gather_rows_ref(table, idx)),
                "index_select_ms": time_ms(
                    lambda: torch.index_select(table, 0, idx)),
                "rows": n_idx, "row_bytes": shape[1] * table.element_size()}
    phase("kernel", bit_identical=True, cases=[c[0] for c in cases],
          timings=timings)

    # an index of N must not be read: its row comes back zero and the
    # device flag is set; then the flag is cleared for the main path
    table = torch.ones((1000, 128), device=dev)
    out = gather.gather_rows(table, torch.tensor([5, 1000], device=dev,
                                                 dtype=torch.int32))
    torch.cuda.synchronize()
    check(gather.error_flag_value() == 1, "out-of-range index set no flag")
    check(bool((out[1] == 0).all()) and bool((out[0] == 1).all()),
          "out-of-range row not zeroed")
    gather.reset_error_flag()
    check(gather.error_flag_value() == 0, "error flag did not reset")
    phase("kernel_flag", out_of_range_flagged=True, reset=True)
    f32 = timings["f32"]
    # each gathered row read once and written once, the indices read once
    moved = 2 * f32["rows"] * f32["row_bytes"] + 4 * f32["rows"]
    return {"max_abs_err": max_err, "ms": f32["kernel_ms"],
            "plain_ms": f32["plain_ms"], "library_ms": f32["index_select_ms"],
            "bound_ms": moved / HBM_BYTES_S * 1e3, "bound_by": "bytes"}


def kernel_fused_rows(gather, dev, n_rows: int = 1_000_001,
                      n_idx: int = 32768) -> dict:
    """Phase 3b: the gather kernel on the fused engine's byte-row tables —
    serving (bits 8, M 48: 6,528 B) and build (bits 4, W 64: 4,608 B) — bit
    for bit against index_select, with median times of both (~11 GB of
    tables, freed after each case)."""
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    timings = {}
    for name, row_bytes in (("serve_u8_6528", 6528), ("build_u8_4608", 4608)):
        table = torch.randint(0, 256, (n_rows, row_bytes), generator=g,
                              device=dev, dtype=torch.uint8)
        idx = torch.randint(0, n_rows, (n_idx,), generator=g, device=dev,
                            dtype=torch.int32)
        idx[0], idx[-1] = 0, n_rows - 1
        got = gather.gather_rows(table, idx)
        want = gather.gather_rows_ref(table, idx)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"kernel {name}: differs from index_select")
        del got, want
        t_k = time_ms(lambda: gather.gather_rows(table, idx))
        t_p = time_ms(lambda: gather.gather_rows_ref(table, idx))
        moved = 2 * n_idx * row_bytes   # bytes read + written
        timings[name] = {"kernel_ms": t_k, "index_select_ms": t_p,
                         "kernel_gb_s": moved / t_k / 1e6,
                         "index_select_gb_s": moved / t_p / 1e6,
                         "rows": n_idx, "row_bytes": row_bytes,
                         "table_rows": n_rows}
        del table, idx
        torch.cuda.empty_cache()
    check(gather.error_flag_value() == 0,
          "the gather kernel met an out-of-range index (byte rows)")
    phase("kernel_fused_rows", bit_identical=True, timings=timings)
    return timings


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
    from mysteryann_tpu_torch.utils.trace import tracer

    t0 = time.perf_counter()
    base, train_q = port.make_cross_modal(n_base, n_train, DIM,
                                          metric=METRIC, seed=7, **WORLD)
    _, eval_q = port.make_cross_modal(1, n_eval, DIM, metric=METRIC, seed=7,
                                      query_seed=8, **WORLD)
    phase("data", n_base=n_base, n_train=n_train, n_eval=n_eval, dim=DIM,
          seconds=time.perf_counter() - t0)

    gather.reset_launches()
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
    phase("knn", train_knn_s=t_knn, gt_s=t_gt, gt_vs_float64=gt_agree)

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
    phase("main_path", k1_launches_build=build_launches,
          k1_launches_search=search_launches, k1_launches_total=launches,
          error_flag=flag)
    check(flag == 0, "the gather kernel met an out-of-range index")
    return {"launches": launches, "base": base, "base_dev": base_dev,
            "eval_q": eval_q, "gt_d": gt_d, "gt_i": gt_i,
            "train_q": train_q, "knn": knn}


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
        elif "gather_rows" in e.name:
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
    base_dev, eval_q = world["base_dev"], world["eval_q"]
    n = base_dev.shape[0]
    k1 = k2 = 0
    for prec in ("f32", "bf16", "int8", "scan"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        idx = port.FlatIndex(base_dev, METRIC, tile=n, oversample=2,
                             precision=prec)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        gather.reset_launches()
        scan.reset_launches()
        r = idx.benchmark(eval_q, k=K, query_batch=query_batch)
        l1, l2 = gather.launches, scan.launches
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
        k1 += l1
        k2 += l2
    flag = gather.error_flag_value()
    check(flag == 0, "the gather kernel met an out-of-range index (flat)")
    return {"k1_launches": k1, "k2_launches": k2}


def fused_path(port, gather, world: dict, query_batch: int = 8192) -> dict:
    """Phases 7-8: the bench's fused build recipe, then seeded FusedSearcher
    serving over the bench's sweep and the classic parity row."""
    from mysteryann_tpu_torch.graph.roargraph import _resolve_engine
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = port.build_roargraph(base_dev, world["train_q"], world["knn"],
                                 cfg, verbose=True)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build_launches = gather.launches
    spans = tr.summary()["spans"]
    st = index.graph.degree_stats()
    reach = reachable_all(index.graph.neighbors, index.graph.ep)
    flag = gather.error_flag_value()
    phase("fused_build", engine=engine, seconds=t_build,
          phases_s={k: v["total_s"] for k, v in spans.items()},
          degree=st, all_reachable=reach, k1_launches=build_launches,
          error_flag=flag,
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
    peak = torch.cuda.max_memory_allocated() / 2**30
    del fs
    torch.cuda.empty_cache()
    best = max(r["recall@10"] for r in rows)
    at_target = [r for r in rows if r["recall@10"] >= TARGET_RECALL]
    phase("fused_serve_summary", k1_launches=serve_launches,
          best_recall=best, peak_gib=peak,
          best_qps_at_target=max((r["qps"] for r in at_target),
                                 default=None))
    check(serve_launches > 0, "fused serving launched K1 0 times")
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
    return {"index": index, "k1_launches": build_launches + serve_launches}


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
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA device and has no CPU fallback")
    t_start = time.perf_counter()
    port = import_port()
    from mysteryann_tpu_torch.ops import gather, scan

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

    # one nvcc per source, both started together
    with ThreadPoolExecutor(2) as ex:
        futures = [ex.submit(m.build, True) for m in (gather, scan)]
        secs = [f.result() for f in futures]
    for m, src, sec in ((gather, KERNEL_SOURCE, secs[0]),
                        (scan, SCAN_SOURCE, secs[1])):
        phase("build_kernel", source=src, seconds=sec,
              ptxas=[ln.strip() for ln in m.build_log.splitlines()
                     if "registers" in ln or "spill" in ln])

    k1 = kernel_checks(gather, dev)
    kernel_fused_rows(gather, dev)
    k2 = kernel_scan(scan, dev)
    run = main_path(port, gather, dev, 1_000_000, 200_000, 8192)
    flat = flat_path(port, gather, scan, run)
    fused = fused_path(port, gather, run)
    k1_cli = cli_path(run, gather, fused["index"])
    phase("smoke", seconds=time.perf_counter() - t_start)

    print(json.dumps({"kernels": [
        {"name": "gather_rows", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES,
         "launches": (run["launches"] + flat["k1_launches"]
                      + fused["k1_launches"] + k1_cli),
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]},
        {"name": "binned_scan", "route": "cuda", "source": SCAN_SOURCE,
         "replaces": SCAN_REPLACES, "launches": flat["k2_launches"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
