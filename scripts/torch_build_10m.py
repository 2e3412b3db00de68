"""Build and serve a RoarGraph at the reference's headline 10M scale
(PyTorch port of scripts/build_10m.py).

The reference's flagship regime is T2I-10M graph build + search (reference
run_roargraph_test.sh:5-10, run_roargraph_search_test.sh). This script
produces the equivalent rows on the synthetic 10M corpus:

1. data: the difficulty-calibrated 10M x 128 base (seed 17) with a 1M-query
   train set and a 32,768-query eval set drawn from the same manifold;
2. exact eval ground truth and exact train kNN (the build's input);
3. build: M_sq=64, M_pjbp=32, L_pjpq=128, expand 4, int4 rows. With
   `--engine auto` the phase-D engine and the fold path are planned from
   the card's memory (`graph/roargraph._build_memory_plan`); the JSON line
   says what was chosen, the per-phase seconds and the peak memory;
4. serve: the classic engine with sample-scan seeding at L = 100, 150, 250
   (`--serve_engine fused` serves int4 byte rows at max_degree 32
   instead); flat rows come from scripts/torch_bench_10m.py.

Run on the card:  python scripts/torch_build_10m.py [--passes N]
On the CPU (tiny): --device cpu --n_base 2000 --n_train 600 --n_eval 128
Emits one JSON line; artifacts cache under .bench_cache/.
"""

import argparse
import functools
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from mysteryann_tpu_torch.cli.common import add_device_flag, device_from
from _torch_benchrun import (cached, card_info, default_cache_dir, log,
                             peak_gb, sync)

K = 10
M_SQ, M_PJBP, L_PJPQ = 64, 32, 128
# v3 = the difficulty-calibrated world (same geometry as the 1M bench's)
KEY_VERSION = "v3"
WORLD = dict(n_concepts=20_000, intrinsic_dim=48, noise=0.85)
WORLD_SEED = 17
SERVE_LS = (100, 150, 250)


def keys(n: int, dim: int, n_train: int):
    """Cache keys shared by the 10M scripts (build, sweep, bench)."""
    key = f"torch_t2i10m_{KEY_VERSION}_{n}_{dim}"
    return key, f"{key}_graph{n_train}"


def load_world(cache, n: int, n_train: int, n_eval: int, dim: int):
    """(base, train_q, eval_q), cached as two files: the base alone (the
    flat / IVF script needs no train set) and the query split."""
    from mysteryann_tpu_torch.io import make_cross_modal
    key, gkey = keys(n, dim, n_train)

    @functools.lru_cache(maxsize=1)
    def world():
        return make_cross_modal(n, n_train + n_eval, dim, metric="ip",
                                seed=WORLD_SEED, **WORLD)

    (base,) = cached(cache, f"{key}_base", lambda: [world()[0]])
    train_q, eval_q = cached(
        cache, f"{gkey}_queries{n_eval}",
        lambda: [world()[1][:n_train], world()[1][n_train:]])
    return base, train_q, eval_q


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_base", type=int, default=10_000_000)
    ap.add_argument("--n_train", type=int, default=1_000_000)
    ap.add_argument("--n_eval", type=int, default=32_768)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "fused", "classic"))
    ap.add_argument("--search_batch", type=int, default=8192)
    ap.add_argument("--query_batch", type=int, default=8192)
    ap.add_argument("--serve_engine", default="classic",
                    choices=("classic", "fused"))
    ap.add_argument("--skip_serve", action="store_true")
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
    from mysteryann_tpu_torch.search import Searcher
    from mysteryann_tpu_torch.search.fused import FusedSearcher
    from mysteryann_tpu_torch.utils.metrics import compute_recall, compute_rderr
    from mysteryann_tpu_torch.utils.params import BuildConfig
    from mysteryann_tpu_torch.utils.trace import tracer

    n, ntr, dim = args.n_base, args.n_train, args.dim
    cache = None if args.no_cache else args.cache_dir
    key, gkey = keys(n, dim, ntr)
    m_sq = min(M_SQ, n - 1)

    log("== data (base manifold + same-distribution queries) ==")
    t0 = time.time()
    base, train_q, eval_q = load_world(cache, n, ntr, args.n_eval, dim)
    log(f"data ready in {time.time() - t0:.0f}s (base {base.shape}, "
        f"train {train_q.shape}, eval {eval_q.shape})")
    # the base is on the device before any clock starts
    base_dev = prepare_vectors(base, "ip", dev)

    log("== exact eval GT ==")
    gt_i, gt_d = cached(cache, f"{gkey}_gt{args.n_eval}", lambda: list(
        exact_knn(eval_q, base_dev, k=K, metric="ip", query_batch=2048,
                  base_tile=131072, precision="highest"))[::-1])
    gt_i = gt_i.astype(np.int64)

    log("== train kNN (build input) ==")
    t0 = time.time()
    (knn,) = cached(cache, f"{gkey}_knn", lambda: [exact_knn(
        train_q, base_dev, k=m_sq, metric="ip", query_batch=8192,
        base_tile=131072)[1].astype(np.int32)])
    knn_secs = round(time.time() - t0, 1)
    log(f"train kNN in {knn_secs:.0f}s")

    cfg = BuildConfig(M_sq=m_sq, M_pjbp=M_PJBP, L_pjpq=L_PJPQ, metric="ip",
                      query_batch=8192, search_batch=args.search_batch,
                      connectivity_passes=args.passes, connectivity_expand=4,
                      connectivity_bits=4, connectivity_engine=args.engine)
    plan = _build_memory_plan(cfg, n, dim, device_memory(dev))
    index_path = (os.path.join(cache, f"{gkey}_p{args.passes}_{plan.engine}"
                                      f"_proj.index") if cache else None)
    build_secs, phases = None, None
    if index_path and os.path.exists(index_path):
        index = RoarGraphIndex.load(index_path)
        try:
            with open(index_path + ".build.json") as f:
                build_secs = json.load(f)["build_secs"]
        except (OSError, KeyError, ValueError):
            pass
    else:
        log(f"== build (engine {plan.engine}, {plan.fold} fold) ==")
        tr = tracer()
        tr.reset()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        sync(dev)
        t0 = time.time()
        # shared checkpoint dir: connectivity_passes is fingerprint-neutral,
        # so a later --passes 2 run resumes from the 1-pass phase D
        index = build_roargraph(
            base_dev, train_q, knn, cfg, verbose=True,
            checkpoint_dir=os.path.join(cache, f"{gkey}_ck") if cache
            else None)
        sync(dev)
        build_secs = round(time.time() - t0, 1)
        phases = {k: round(v["total_s"], 1)
                  for k, v in tr.summary()["spans"].items()}
        log(f"build took {build_secs:.1f}s")
        if index_path:
            index.save(index_path)
            with open(index_path + ".build.json", "w") as f:
                json.dump({"build_secs": build_secs}, f)
    build_peak = peak_gb(dev)

    rows = []
    if not args.skip_serve:
        log(f"== serve sweep ({args.serve_engine} engine, seeded) ==")
        if args.serve_engine == "fused":
            s = FusedSearcher(index, base_dev, max_degree=32, seed_sample=4,
                              bits=4)
            kw = dict(expand=4)
        else:
            s = Searcher(index, base_dev, seed_sample=8)
            kw = dict(visited_mode="merge", expand=4)
        for L in SERVE_LS:
            r = s.benchmark(eval_q, k=K, L=L, query_batch=args.query_batch,
                            seeds=min(32, L), **kw)
            rows.append({
                "mode": f"graph_{args.serve_engine}_seeded_L{L}",
                "qps": round(r["qps"], 1),
                "recall": round(compute_recall(r["ids"], gt_i, K), 4),
                "rderr": round(compute_rderr(r["dists"], gt_d, K, "ip"), 6),
                "avg_hops": round(r["avg_hops"], 1)})
            log(rows[-1])

    st = index.graph.degree_stats()
    out = {"scale": n, "n_train": ntr, "passes": args.passes,
           "build_secs": build_secs, "rows": rows, "engine": plan.engine,
           "fold": plan.fold, "phases_s": phases,
           "train_knn_secs": knn_secs, "build_peak_gb": build_peak,
           "degree": {k: (round(v, 2) if isinstance(v, float) else v)
                      for k, v in st.items()}, **card_info(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
