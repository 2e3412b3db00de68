"""Round benchmark on the PyTorch port (the twin of bench.py, which drives the
JAX package): one JSON line on stdout, progress on stderr.

Metric: QPS per card at recall@10 >= 0.95 on the T2I-like synthetic 1M-vector
cross-modal world (128-d, inner product, out-of-distribution training
queries), one card. The best serving mode at that recall is the headline:
flat f32, flat int8 (exact f32 rerank) or the seeded fused RoarGraph sweep;
the classic `Searcher` row is parity evidence. ``vs_baseline`` is the ratio
against the reference C++ binary's measured CPU QPS at the same recall on
identical data (BASELINE.md, 16-thread equivalent), not against any
accelerator.

Rows follow bench.py's protocol (`_bench_median`): ``ramp`` trials thrown
away, the first with a warm-up, then the median QPS of ``repeats``. The flat
f32 row is measured in two windows, before the graph sweep and after it, and
pooled. The graph index is built in a child process (``--build-only``), so
the timed rows run in a process whose device never held the build's working
set; the build checkpoints each phase, so a cut run resumes. bench.py's
contention sentinel (`contention_sentinel`: a fixed bf16 8,192 x 1M product
and min) is timed after the ground truth and again after the classic row,
and both go into the detail as ``contention_sentinel_ms``.

Arrays and the index are cached under ``.bench_cache/``. The world arrays
share bench.py's keys (both packages make them with the same numpy code and
give identical arrays); what the port computes (ground truth, build kNN, the
index and its checkpoints) has keys of its own, prefixed ``torch_``.

Run on the card:   python3 bench_torch.py [--no_cache]
On the CPU (tiny): python3 bench_torch.py --device cpu --n_base 3000
                   --n_train 600 --n_eval 256 --repeats 1 --ramp 1
                   --cache_dir /tmp/bench_torch_cache
The last stdout line is the compact headline; the full rows go to
bench_torch_detail.json beside this file.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.join(HERE, "scripts") not in sys.path:
    sys.path.append(os.path.join(HERE, "scripts"))

from mysteryann_tpu_torch.cli.common import add_device_flag, device_from  # noqa: E402
from _torch_benchrun import cached, card_info, log, sync  # noqa: E402

KEY_VERSION = "v3"
WORLD = dict(n_concepts=20_000, intrinsic_dim=48, noise=0.85)
N_BASE = 1_000_000
N_TRAIN = 200_000
N_EVAL = 32_768
DIM = 128
METRIC = "ip"
K = 10
M_SQ, M_PJBP, L_PJPQ = 64, 32, 128
BUILD_PASSES, BUILD_EXPAND, BUILD_BITS = 2, 4, 4
QUERY_BATCH = 8192
TARGET_RECALL = 0.95
REPEATS, RAMP = 5, 2
SEED_SAMPLE, SEED_MAX_DEGREE = 2, 48
# (expand, seeds, L) rows of the seeded fused sweep, bench.py's
SEEDED_L_SWEEP = ((4, 40, 40), (4, 40, 44), (4, 40, 48), (4, 40, 56),
                  (4, 40, 64), (4, 40, 80), (4, 40, 112),
                  (3, 48, 144), (3, 48, 176), (2, 48, 224))
CLASSIC_L = 100
# bench.py's contention sentinel: q [8192, 128] against 1M base rows
SENTINEL_QUERIES, SENTINEL_ROWS, SENTINEL_TILE = 8192, 1_000_000, 131_072
DETAIL_FILE = "bench_torch_detail.json"
CACHE = os.path.join(HERE, ".bench_cache")
BASELINE_LABEL = "reference C++ binary on the CPU, 16 threads (BASELINE.md)"


def world_key(n_base: int = N_BASE, n_train: int = N_TRAIN) -> str:
    """bench.py's key of the world arrays (their cache names start with it)."""
    return f"t2i1m_{KEY_VERSION}_{n_base}_{n_train}_{DIM}"


def world(cache, n_base: int = N_BASE, n_train: int = N_TRAIN,
          n_eval: int = N_EVAL):
    """(base, train_q, eval_q) as numpy arrays. The eval queries come from
    the same seed-7 world through ``query_seed=8``."""
    from mysteryann_tpu_torch.io import make_cross_modal
    key = world_key(n_base, n_train)
    base, train_q = cached(cache, key + "_data", lambda: make_cross_modal(
        n_base, n_train, DIM, metric=METRIC, seed=7, **WORLD))
    (eval_q,) = cached(cache, f"{key}_evalw{n_eval}", lambda: [
        make_cross_modal(1, n_eval, DIM, metric=METRIC, seed=7,
                         query_seed=8, **WORLD)[1]])
    return base, train_q, eval_q


def ground_truth(cache, key: str, eval_q: np.ndarray, base_dev):
    """(gt_i int64, gt_d): exact top-K of the eval queries, f32 "highest"."""
    from mysteryann_tpu_torch.ops import exact_knn
    gt_i, gt_d = cached(cache, f"torch_{key}_gtw{eval_q.shape[0]}",
                        lambda: list(reversed(exact_knn(
                            eval_q, base_dev, k=K, metric=METRIC,
                            query_batch=QUERY_BATCH, base_tile=131072,
                            precision="highest"))))
    return gt_i.astype(np.int64), gt_d


def build_knn(cache, key: str, train_q: np.ndarray, base_dev) -> np.ndarray:
    """The build's train-query -> base kNN (M_SQ ids per query)."""
    from mysteryann_tpu_torch.ops import exact_knn
    (knn,) = cached(cache, f"torch_{key}_knn", lambda: [exact_knn(
        train_q, base_dev, k=M_SQ, metric=METRIC, query_batch=QUERY_BATCH,
        base_tile=131072, approx=True)[1]])
    return knn


def build_config(passes: int = BUILD_PASSES, expand: int = BUILD_EXPAND,
                 bits: int = BUILD_BITS, **kw):
    """bench.py's recipe; engine "auto" (fused where the plan fits)."""
    from mysteryann_tpu_torch.utils.params import BuildConfig
    return BuildConfig(M_sq=M_SQ, M_pjbp=M_PJBP, L_pjpq=L_PJPQ, metric=METRIC,
                       query_batch=QUERY_BATCH, search_batch=QUERY_BATCH,
                       connectivity_passes=passes,
                       connectivity_expand=expand, connectivity_bits=bits,
                       **kw)


def index_paths(cache: str, key: str, tag: str | None = None):
    """(index file, checkpoint directory) of a build tagged ``tag``
    (default: bench.py's recipe, ``p2e4b4``)."""
    tag = tag or f"p{BUILD_PASSES}e{BUILD_EXPAND}b{BUILD_BITS}"
    stem = os.path.join(cache, f"torch_{key}_{M_SQ}_{M_PJBP}_{L_PJPQ}_{tag}")
    return stem + "_proj.index", stem + "_ck"


def build_index(base, train_q, knn, cfg, index_path: str, ck_dir: str,
                dev: torch.device, sidecar: dict | None = None):
    """Build, save and time the index; ``index_path + ".build.json"`` holds
    ``build_secs`` (and ``sidecar``). The base is on the device before the
    clock starts (the reference's build timer also starts with its data in
    memory) and ``torch.cuda.synchronize`` closes both ends."""
    from mysteryann_tpu_torch.graph import build_roargraph
    from mysteryann_tpu_torch.ops.distances import prepare_vectors
    base_staged = prepare_vectors(base, METRIC, dev)
    sync(dev)
    t0 = time.time()
    index = build_roargraph(base_staged, train_q, knn, cfg, verbose=True,
                            checkpoint_dir=ck_dir)
    sync(dev)
    build_secs = round(time.time() - t0, 1)
    log(f"build took {build_secs:.1f}s")
    index.save(index_path)
    with open(index_path + ".build.json", "w") as f:
        json.dump({"build_secs": build_secs, **(sidecar or {})}, f)
    return index, build_secs


def load_index(index_path: str):
    """(index, build_secs): the sidecar's build time, None when it is not
    there."""
    from mysteryann_tpu_torch.graph import RoarGraphIndex
    index = RoarGraphIndex.load(index_path)
    try:
        with open(index_path + ".build.json") as f:
            return index, json.load(f)["build_secs"]
    except (OSError, KeyError, ValueError):
        return index, None


def read_baseline_qps() -> float:
    """The reference binary's measured CPU QPS at the target recall
    (16-thread equivalent), from BASELINE.md; 0.0 when absent."""
    try:
        with open(os.path.join(HERE, "BASELINE.md")) as f:
            m = re.search(r"MEASURED_REFERENCE_QPS_AT_R95_T16\s*=\s*([0-9.]+)",
                          f.read())
        return float(m.group(1)) if m else 0.0
    except OSError:
        return 0.0


def _finish_row(r: dict, gt_i, gt_d, k: int) -> dict:
    """Attach recall + rderr, strip the bulky ids / dists arrays."""
    from mysteryann_tpu_torch.utils.metrics import compute_recall, compute_rderr
    r["recall"] = compute_recall(r["ids"], gt_i, k)
    r["rderr"] = compute_rderr(np.asarray(r["dists"]), gt_d, k, METRIC)
    return {kk: vv for kk, vv in r.items() if kk not in ("ids", "dists")}


def sentinel_min(q: torch.Tensor, base: torch.Tensor,
                 tile: int = SENTINEL_TILE) -> torch.Tensor:
    """The sentinel's function: the min over each query's row of the bf16
    product q·baseᵀ (both operands cast to bf16 inside the call, as
    bench.py's jitted function does), the columns taken ``tile`` at a time
    with a running min, so the [B, N] product is never held whole."""
    qb = q.to(torch.bfloat16)
    out = None
    for s in range(0, base.shape[0], tile):
        m = (qb @ base[s:s + tile].to(torch.bfloat16).T).amin(dim=1)
        out = m if out is None else torch.minimum(out, m)
    return out


def contention_sentinel(base_dev: torch.Tensor) -> list:
    """bench.py's contention sentinel on the card: the sorted ms of five
    calls of `sentinel_min` for q = 0.01 [8192, 128] f32 against the first
    1M rows of the base, after one warm call, each closed by
    ``torch.cuda.synchronize``. Recorded beside a run's rows, a value above
    the card's quiet one tells a depressed row (another tenant, a
    lingering context) from a regression of the code."""
    dev = base_dev.device
    q = torch.zeros(SENTINEL_QUERIES, base_dev.shape[1], dtype=torch.float32,
                    device=dev) + 0.01
    b = base_dev[:SENTINEL_ROWS]
    sentinel_min(q, b)
    sync(dev)
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        sentinel_min(q, b)
        sync(dev)
        ts.append(round(1000 * (time.perf_counter() - t0), 3))
    return sorted(ts)


def _bench_median(bench_fn, gt_i, gt_d, k, repeats=REPEATS, ramp=RAMP):
    """bench.py's row protocol: ``ramp`` trials recorded in ``qps_ramp`` and
    left out of the median (the first runs ``warmup=1``), then ``repeats``
    trials; ``qps`` is their median, ``qps_min`` / ``qps_max`` / the sorted
    ``qps_trials`` their spread; recall, rderr and latency are the last
    trial's."""
    ramp_qps = [round(bench_fn(warmup=1 if t == 0 else 0)["qps"], 1)
                for t in range(ramp)]
    trials = [bench_fn(warmup=0) for _ in range(repeats)]
    qpss = sorted(t["qps"] for t in trials)
    row = _finish_row(trials[-1], gt_i, gt_d, k)
    row["qps"] = qpss[len(qpss) // 2]
    row["qps_trials"] = [round(x, 1) for x in qpss]
    row["qps_min"], row["qps_max"] = qpss[0], qpss[-1]
    row["qps_ramp"] = ramp_qps
    row["mean_latency_ms"] = trials[-1]["mean_latency_ms"]
    return row


def _release(dev: torch.device) -> None:
    """Hand the cached blocks of a finished mode back to the card."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def flat_row(base_dev, eval_q, gt_i, gt_d, precision: str = "f32",
             repeats: int = REPEATS, ramp: int = RAMP) -> dict:
    """`FlatIndex` over the whole base in one tile (f32), or int8 with an
    exact f32 rerank of an ``oversample=2`` head."""
    from mysteryann_tpu_torch.flat import FlatIndex
    flat = FlatIndex(base_dev, metric=METRIC, precision=precision,
                     oversample=2, tile=base_dev.shape[0])
    row = _bench_median(
        lambda warmup: flat.benchmark(eval_q, k=K, query_batch=QUERY_BATCH,
                                      warmup=warmup),
        gt_i, gt_d, K, repeats, ramp)
    log(f"flat {precision}: QPS={row['qps']:.0f} recall={row['recall']:.4f}")
    del flat
    _release(base_dev.device)
    return row


def pool_flat_windows(w1: dict, w2: dict) -> dict:
    """The flat f32 row of two windows: QPS over both windows' trials,
    ``qps_w1`` / ``qps_w2`` the windows' medians, latency the mean of both.
    The search is exact and deterministic, so the two windows' recall and
    rderr must be equal; raises ValueError if they are not."""
    for m in ("recall", "rderr"):
        if w1[m] != w2[m]:
            raise ValueError(f"flat windows differ in {m}: {w1[m]} vs {w2[m]}")
    pooled = sorted(w1["qps_trials"] + w2["qps_trials"])
    row = dict(w1)
    row["qps_w1"], row["qps_w2"] = w1["qps"], w2["qps"]
    row["qps"] = pooled[len(pooled) // 2]
    row["qps_min"], row["qps_max"] = pooled[0], pooled[-1]
    row["qps_trials"] = pooled
    row["qps_ramp"] = w1["qps_ramp"] + w2["qps_ramp"]
    row["mean_latency_ms"] = (w1["mean_latency_ms"]
                              + w2["mean_latency_ms"]) / 2
    log(f"flat pooled: QPS={row['qps']:.0f} (w1={row['qps_w1']:.0f}, "
        f"w2={row['qps_w2']:.0f})")
    return row


def graph_sweep(index, base_dev, eval_q, gt_i, gt_d,
                rows_spec=SEEDED_L_SWEEP, bits: int = 8,
                repeats: int = REPEATS, ramp: int = RAMP) -> list:
    """Seeded `FusedSearcher` (48-wide rows, a 1-in-2 sample for the seeds)
    over the (expand, seeds, L) rows."""
    from mysteryann_tpu_torch.search.fused import FusedSearcher
    fused = FusedSearcher(index, base_dev, max_degree=SEED_MAX_DEGREE,
                          seed_sample=SEED_SAMPLE, bits=bits)
    rows = []
    for expand, seeds, L in rows_spec:
        r = _bench_median(
            lambda warmup: fused.benchmark(
                eval_q, k=K, L=L, query_batch=QUERY_BATCH, expand=expand,
                seeds=min(seeds, L), warmup=warmup),
            gt_i, gt_d, K, repeats, ramp)
        r["expand"], r["seeds"] = expand, seeds
        rows.append(r)
        log(f"bits={bits} e={expand} L={L}: QPS={r['qps']:.0f} "
            f"[{r['qps_min']:.0f},{r['qps_max']:.0f}] "
            f"recall={r['recall']:.4f} cmps={r['avg_cmps']:.0f} "
            f"hops={r['avg_hops']:.0f}")
    del fused
    _release(base_dev.device)
    return rows


def classic_row(index, base_dev, eval_q, gt_i, gt_d, repeats: int = REPEATS,
                ramp: int = RAMP) -> dict:
    """The classic `Searcher` parity row on the same graph: L = 100, pool
    mode, expand 2, every eval query in one batch."""
    from mysteryann_tpu_torch.search import Searcher
    searcher = Searcher(index, base_dev)
    row = _bench_median(
        lambda warmup: searcher.benchmark(
            eval_q, k=K, L=CLASSIC_L, query_batch=eval_q.shape[0],
            visited_mode="pool", expand=2, warmup=warmup),
        gt_i, gt_d, K, repeats, ramp)
    log(f"classic L={CLASSIC_L}: QPS={row['qps']:.0f} "
        f"recall={row['recall']:.4f}")
    return row


def _headline(value, base_qps, detail, card, provisional=False):
    """The compact driver-facing JSON line (< ~600 chars): bench.py's keys,
    with the card's name and power limit in ``detail``."""
    result = {
        "metric": f"QPS/card at recall@{K}>={TARGET_RECALL} on synthetic "
                  f"T2I-1M ({DIM}d, IP, OOD)",
        "value": round(value, 1),
        "unit": "QPS",
        "vs_baseline": round(value / base_qps, 3) if base_qps else 0.0,
        "detail": {**detail, "device": card["device"],
                   "power_limit": card["power_limit"]},
    }
    if provisional:
        result["provisional"] = True
    return result


def _mode(row, flat, flat8) -> str:
    return ("flat" if row is flat else "flat_int8" if row is flat8
            else "roargraph" if row else "none")


def best_at_target(rows):
    """The fastest row at recall >= TARGET_RECALL, None if there is none."""
    ok = [r for r in rows if r and r["recall"] >= TARGET_RECALL]
    return max(ok, key=lambda r: r["qps"]) if ok else None


def summarize(flat, flat8, graph_rows, classic, build_secs, base_qps, card,
              wall_secs, sentinel_ms: dict | None = None):
    """(headline, detail): the final compact line and the full rows;
    ``sentinel_ms`` ({"pre": [...], "post": [...]}, `contention_sentinel`
    before and after the rows) goes into the detail only."""
    graph_best = best_at_target(graph_rows)
    best = best_at_target([flat, flat8, graph_best])

    def _r(row):
        return {kk: (round(vv, 4) if isinstance(vv, float) else vv)
                for kk, vv in (row or {}).items()}

    detail = {
        "mode": _mode(best, flat, flat8),
        "recall": round(best["recall"], 4) if best else 0.0,
        "flat": _r(flat),
        "flat_int8": _r(flat8),
        "graph_rows": [_r(r) for r in graph_rows],
        "classic_graph_row": _r(classic),
        "graph_build_secs": build_secs,
        "baseline_qps_t16": base_qps,
        "baseline": BASELINE_LABEL,
        "contention_sentinel_ms": sentinel_ms,
        "wall_secs": round(wall_secs, 1),
        **card,
    }
    gbest = _r(graph_best) if graph_best else None
    headline = _headline(best["qps"] if best else 0.0, base_qps, {
        "mode": detail["mode"], "recall": detail["recall"],
        "flat_qps": detail["flat"].get("qps"),
        "graph_best": ({"qps": gbest["qps"], "recall": gbest["recall"],
                        "L": gbest.get("L_pq")} if gbest else None),
        "graph_build_secs": build_secs,
        "baseline_qps_t16": base_qps,
        "detail_file": DETAIL_FILE,
        "wall_secs": detail["wall_secs"],
    }, card)
    return headline, detail


def _child_argv(args, cache: str) -> list:
    """The ``--build-only`` child's command line: every flag of this run."""
    return [sys.executable, os.path.abspath(__file__), "--build-only",
            "--device", args.device, "--n_base", str(args.n_base),
            "--n_train", str(args.n_train), "--n_eval", str(args.n_eval),
            "--repeats", str(args.repeats), "--ramp", str(args.ramp),
            "--cache_dir", cache]


def run(args, dev: torch.device, cache: str) -> dict:
    from mysteryann_tpu_torch.ops.distances import prepare_vectors

    t_all = time.time()
    key = world_key(args.n_base, args.n_train)
    log("== data ==")
    base, train_q, eval_q = world(cache, args.n_base, args.n_train,
                                  args.n_eval)
    base_dev = prepare_vectors(base, METRIC, dev)
    index_path, ck_dir = index_paths(cache, key)
    if args.build_only:
        log("== build (child process) ==")
        knn = build_knn(cache, key, train_q, base_dev)
        build_index(base_dev, train_q, knn, build_config(), index_path,
                    ck_dir, dev)
        return {}

    log("== ground truth (exact) ==")
    gt_i, gt_d = ground_truth(cache, key, eval_q, base_dev)
    sentinel_pre = contention_sentinel(base_dev)
    log(f"contention sentinel (ms): {sentinel_pre}")
    card = card_info(dev)
    base_qps = read_baseline_qps()
    reps = dict(repeats=args.repeats, ramp=args.ramp)

    # flat needs no index: its row is out as a provisional headline before
    # the build starts, so a run cut during the build still reports one
    log("== flat index ==")
    flat_w1 = flat_row(base_dev, eval_q, gt_i, gt_d, "f32", **reps)
    if flat_w1["recall"] >= TARGET_RECALL:
        print(json.dumps(_headline(
            flat_w1["qps"], base_qps,
            {"mode": "flat", "recall": round(flat_w1["recall"], 4),
             "flat_qps": round(flat_w1["qps"], 1),
             "baseline_qps_t16": base_qps,
             "note": "flat rows only; graph rows follow"},
            card, provisional=True)), flush=True)
    flat8 = flat_row(base_dev, eval_q, gt_i, gt_d, "int8", **reps)

    if not os.path.exists(index_path):
        log("== build (child process) ==")
        subprocess.run(_child_argv(args, cache), check=True)
    index, build_secs = load_index(index_path)

    log("== graph search sweep (fused int8 rows, seeded) ==")
    graph_rows = graph_sweep(index, base_dev, eval_q, gt_i, gt_d, **reps)
    best = best_at_target([flat_w1, flat8, best_at_target(graph_rows)])
    if best:
        print(json.dumps(_headline(
            best["qps"], base_qps,
            {"mode": _mode(best, flat_w1, flat8),
             "recall": round(best["recall"], 4),
             "note": "pre-final; flat window 2 pending"},
            card, provisional=True)), flush=True)

    log("== flat index (window 2) ==")
    flat_w2 = flat_row(base_dev, eval_q, gt_i, gt_d, "f32", **reps)
    flat = pool_flat_windows(flat_w1, flat_w2)
    classic = classic_row(index, base_dev, eval_q, gt_i, gt_d, **reps)
    sentinel = {"pre": sentinel_pre, "post": contention_sentinel(base_dev)}
    log(f"contention sentinel (ms): {sentinel}")

    headline, detail = summarize(flat, flat8, graph_rows, classic, build_secs,
                                 base_qps, card, time.time() - t_all,
                                 sentinel)
    record = {**headline, "detail": detail}
    with open(os.path.join(HERE, DETAIL_FILE), "w") as f:
        json.dump(record, f, indent=1)
    log(json.dumps(detail))
    print(json.dumps(headline), flush=True)
    return record


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_base", type=int, default=N_BASE)
    ap.add_argument("--n_train", type=int, default=N_TRAIN)
    ap.add_argument("--n_eval", type=int, default=N_EVAL)
    ap.add_argument("--cache_dir", default=CACHE)
    ap.add_argument("--no_cache", action="store_true",
                    help="keep this run's arrays and index in a temporary "
                         "directory, removed at the end")
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--ramp", type=int, default=RAMP)
    ap.add_argument("--build-only", action="store_true",
                    help="build and save the index, then exit (the child "
                         "process of a run)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_from(ap, args)
    if args.no_cache:
        with tempfile.TemporaryDirectory(prefix="bench_torch_") as tmp:
            return run(args, dev, tmp)
    return run(args, dev, args.cache_dir)


if __name__ == "__main__":
    main()
