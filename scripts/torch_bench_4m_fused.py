"""4M-row single-card graph build and seeded fused serving (PyTorch port of
scripts/bench_4m_fused.py).

Pipeline: the difficulty-calibrated T2I world at 4M x 128 (seed 23, 400k
train queries, 32,768 eval queries) -> exact ground truth -> train kNN ->
`build_roargraph` -> seeded `FusedSearcher` sweep at int4 rows, each row
the median of 3 trials after 2 discarded, against the exact ground truth.

The defaults (`--engine classic`, `--max_degree 32`) are the JAX script's,
so rows compare; `--engine auto` lets the build plan its phase-D engine
from the card's memory (`graph/roargraph._build_memory_plan`), and
`--max_degree 48` serves the wider rows a larger card has room for.

`--flat` runs the flat section instead (port of scripts/probe_flat_4m.py):
`FlatIndex` over the cached world in f32 (one tile of n rows) and bf16
(resident bf16 rows, exact f32 rerank of a 2k head), with bench_torch.py's
row protocol (2 trials discarded, the median of 5); no kNN, build or graph.

Run on the card:  python scripts/torch_bench_4m_fused.py [--engine auto]
                  [--max_degree 48] [--passes 2] [--no_cache] [--flat]
On the CPU (tiny): --device cpu --n_base 2000 --n_train 600 --n_eval 128
Emits one JSON line; artifacts cache under .bench_cache/.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import bench_torch as bt
from mysteryann_tpu_torch.cli.common import add_device_flag, device_from
from _torch_benchrun import (cached, card_info, default_cache_dir, log,
                             med3_row, peak_gb, sync)

K = 10
M_SQ, M_PJBP, L_PJPQ = 64, 32, 128
WORLD = dict(n_concepts=20_000, intrinsic_dim=48, noise=0.85)
WORLD_SEED = 23


def make_world(n: int, n_train: int, n_eval: int, dim: int = 128):
    """(base, train_q, eval_q): train and eval queries are one draw from
    the world's query stream, split."""
    from mysteryann_tpu_torch.io import make_cross_modal
    base, queries = make_cross_modal(n, n_train + n_eval, dim, metric="ip",
                                     seed=WORLD_SEED, **WORLD)
    return base, queries[:n_train], queries[n_train:]


def build_config(passes: int = 2, engine: str = "classic",
                 m_sq: int = M_SQ, m_pjbp: int = M_PJBP,
                 l_pjpq: int = L_PJPQ):
    from mysteryann_tpu_torch.utils.params import BuildConfig
    return BuildConfig(M_sq=m_sq, M_pjbp=m_pjbp, L_pjpq=l_pjpq, metric="ip",
                       query_batch=8192, search_batch=8192,
                       connectivity_passes=passes, connectivity_expand=4,
                       connectivity_bits=4, connectivity_engine=engine)


def serve_rows(fused, eval_q, gt_i, gt_d, Ls, seeds: int, query_batch: int):
    """The seeded sweep: per L the benchmark scripts' row protocol (`med3`: two
    trials thrown away, then the median QPS of three)."""
    rows = []
    for L in Ls:
        rows.append(med3_row(lambda warmup: fused.benchmark(
            eval_q, k=K, L=L, query_batch=query_batch, expand=4,
            seeds=min(seeds, L), warmup=warmup), gt_i, gt_d, K, "ip", L_pq=L))
        log(json.dumps(rows[-1]))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_base", type=int, default=4_000_000)
    ap.add_argument("--n_train", type=int, default=400_000)
    ap.add_argument("--n_eval", type=int, default=32_768)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--engine", default="classic",
                    choices=("auto", "fused", "classic"))
    ap.add_argument("--max_degree", type=int, default=32)
    ap.add_argument("--seed_sample", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--Ls", default="48,56,64,80,112")
    ap.add_argument("--query_batch", type=int, default=8192)
    ap.add_argument("--skip_serve", action="store_true")
    ap.add_argument("--flat", action="store_true",
                    help="the flat f32 / bf16 rows only (no kNN, build or "
                         "graph rows)")
    ap.add_argument("--cache_dir", default=default_cache_dir(__file__))
    ap.add_argument("--no_cache", action="store_true",
                    help="compute everything, write nothing to disk")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_from(ap, args)

    from mysteryann_tpu_torch.graph import RoarGraphIndex, build_roargraph
    from mysteryann_tpu_torch.graph.roargraph import (_build_memory_plan,
                                                      device_memory)
    from mysteryann_tpu_torch.ops import exact_knn
    from mysteryann_tpu_torch.ops.distances import prepare_vectors
    from mysteryann_tpu_torch.search.fused import FusedSearcher

    n, ntr, dim = args.n_base, args.n_train, args.dim
    cache = None if args.no_cache else args.cache_dir
    key = f"torch_t2i4m_v3_{n}_{dim}"
    gkey = f"{key}_graph{ntr}"
    m_sq = min(M_SQ, n - 1)
    cfg = build_config(args.passes, args.engine, m_sq=m_sq)

    log("== data ==")
    t0 = time.time()
    base, train_q, eval_q = cached(
        cache, f"{key}_all{ntr}_{args.n_eval}",
        lambda: make_world(n, ntr, args.n_eval, dim))
    log(f"data in {time.time() - t0:.0f}s")
    base_dev = prepare_vectors(base, "ip", dev)

    log("== exact GT ==")
    gt_i, gt_d = cached(cache, f"{gkey}_gt{args.n_eval}", lambda: list(
        exact_knn(eval_q, base_dev, k=K, metric="ip", query_batch=4096,
                  base_tile=131072, precision="highest"))[::-1])
    gt_i = gt_i.astype(np.int64)

    if args.flat:
        rows = [{"mode": f"flat_{p}",
                 **bt.flat_row(base_dev, eval_q, gt_i, gt_d, p)}
                for p in ("f32", "bf16")]
        out = {"probe": "flat_4m", "scale": n, "rows": rows, **card_info(dev)}
        print(json.dumps(out))
        return out

    log("== train kNN ==")
    t0 = time.time()
    (knn,) = cached(cache, f"{gkey}_knn", lambda: [exact_knn(
        train_q, base_dev, k=m_sq, metric="ip", query_batch=8192,
        base_tile=131072)[1].astype(np.int32)])
    knn_secs = time.time() - t0

    plan = _build_memory_plan(cfg, n, dim, device_memory(dev))
    index_path = (os.path.join(cache, f"{gkey}_p{args.passes}_{plan.engine}"
                                      f"_proj.index") if cache else None)
    build_secs = None
    if index_path and os.path.exists(index_path):
        index = RoarGraphIndex.load(index_path)
        try:
            with open(index_path + ".build.json") as f:
                build_secs = json.load(f)["build_secs"]
        except (OSError, KeyError, ValueError):
            pass
    else:
        log(f"== build (engine {plan.engine}, {plan.fold} fold) ==")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        sync(dev)
        t0 = time.time()
        index = build_roargraph(
            base_dev, train_q, knn, cfg, verbose=True,
            checkpoint_dir=os.path.join(cache, f"{gkey}_ck") if cache
            else None)
        sync(dev)
        build_secs = round(time.time() - t0, 1)
        log(f"build took {build_secs:.1f}s")
        if index_path:
            index.save(index_path)
            with open(index_path + ".build.json", "w") as f:
                json.dump({"build_secs": build_secs}, f)
    build_peak = peak_gb(dev)

    rows = []
    if not args.skip_serve:
        log(f"== fused serve (bits=4, max_degree={args.max_degree}, "
            f"1-in-{args.seed_sample} sample, seeds={args.seeds}) ==")
        fused = FusedSearcher(index, base_dev, max_degree=args.max_degree,
                              seed_sample=args.seed_sample, bits=4)
        rows = serve_rows(fused, eval_q, gt_i, gt_d,
                          [int(x) for x in args.Ls.split(",")], args.seeds,
                          args.query_batch)

    out = {"scale": n, "passes": args.passes, "build_secs": build_secs,
           "max_degree": args.max_degree, "bits": 4, "rows": rows,
           "engine": plan.engine, "fold": plan.fold,
           "train_knn_secs": round(knn_secs, 1),
           "build_peak_gb": build_peak, **card_info(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
