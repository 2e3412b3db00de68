"""3-pass RoarGraph at 1M (PyTorch port of scripts/sweep_1m_p3.py): build
bench_torch.py's world with three phase-D passes (expand 1, 8-bit rows, the
build's defaults) and sweep the seeded fused searcher over L, each row the
median of 3 trials after 2 discarded. Each extra pass lifts the recall
frontier, so the QPS at recall .95 may move to a smaller L.

The index is cached beside bench_torch.py's (``..._p3_proj.index``); a
cached index is loaded, not rebuilt.

Run on the card:   python scripts/torch_sweep_1m_p3.py
On the CPU (tiny): --device cpu --n_base 2000 --n_train 600 --n_eval 128
                   --passes 1 --L 40 60 --cache_dir /tmp/bench_torch_cache
Emits one JSON line.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import bench_torch as bt  # noqa: E402
from mysteryann_tpu_torch.cli.common import add_device_flag, device_from  # noqa: E402
from _torch_benchrun import card_info, log, med3_row  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--seed_sample", type=int, default=4)
    ap.add_argument("--expand", type=int, default=4)
    ap.add_argument("--max_degree", type=int, default=48)
    ap.add_argument("--exit_f", type=float, default=None,
                    help="early-termination factor (see search/fused.py)")
    ap.add_argument("--visited_mode", default="auto",
                    choices=("auto", "merge", "pool", "bitmask"))
    ap.add_argument("--query_batch", type=int, default=bt.QUERY_BATCH)
    ap.add_argument("--bits", type=int, default=8, choices=(8, 4),
                    help="traversal-row quantization (4 halves the bytes)")
    ap.add_argument("--rerank", type=int, default=0,
                    help="exact-rerank head depth (0 = the engine's)")
    ap.add_argument("--L", type=int, nargs="+",
                    default=[40, 50, 60, 75, 90, 110, 130, 160, 200])
    ap.add_argument("--n_base", type=int, default=bt.N_BASE)
    ap.add_argument("--n_train", type=int, default=bt.N_TRAIN)
    ap.add_argument("--n_eval", type=int, default=bt.N_EVAL)
    ap.add_argument("--cache_dir", default=bt.CACHE)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_from(ap, args)
    from mysteryann_tpu_torch.ops.distances import prepare_vectors
    from mysteryann_tpu_torch.search.fused import FusedSearcher

    cache, key = args.cache_dir, bt.world_key(args.n_base, args.n_train)
    base, train_q, eval_q = bt.world(cache, args.n_base, args.n_train,
                                     args.n_eval)
    base_dev = prepare_vectors(base, bt.METRIC, dev)
    gt_i, gt_d = bt.ground_truth(cache, key, eval_q, base_dev)

    p = args.passes
    index_path, ck_dir = bt.index_paths(cache, key, f"p{p}")
    if os.path.exists(index_path):
        index, build_secs = bt.load_index(index_path)
    else:
        log(f"== build ({p}-pass) ==")
        knn = bt.build_knn(cache, key, train_q, base_dev)
        index, build_secs = bt.build_index(
            base_dev, train_q, knn, bt.build_config(p, expand=1, bits=8),
            index_path, ck_dir, dev)
    degree = index.graph.degree_stats()
    log(f"degree: {degree}")

    fused = FusedSearcher(index, base_dev, max_degree=args.max_degree,
                          seed_sample=args.seed_sample, bits=args.bits)
    rows = []
    for L in args.L:
        rows.append(med3_row(
            lambda warmup: fused.benchmark(
                eval_q, k=bt.K, L=L, query_batch=args.query_batch,
                expand=args.expand, seeds=min(args.seeds, L),
                visited_mode=args.visited_mode, exit_f=args.exit_f,
                rerank=args.rerank, warmup=warmup),
            gt_i, gt_d, bt.K, bt.METRIC, L=L))
        log(json.dumps(rows[-1]))
    best = max((r for r in rows if r["recall"] >= bt.TARGET_RECALL),
               key=lambda r: r["qps"], default=None)
    out = {"passes": p, "build_secs": build_secs, "degree": degree,
           "seeds": args.seeds, "seed_sample": args.seed_sample,
           "expand": args.expand, "max_degree": args.max_degree,
           "visited_mode": args.visited_mode,
           "query_batch": args.query_batch, "bits": args.bits,
           "rows": rows, "best_at_95": best, **card_info(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
