"""Probe the phase-D build knobs at 1M (PyTorch port of
scripts/probe_build_1m.py): build bench_torch.py's world with a chosen
``connectivity_expand`` / ``connectivity_bits`` / passes (and, optionally,
seeded phase-D entries), time the build, then serve the record
configuration (seeded `FusedSearcher`, 48-wide rows, a 1-in-2 sample, 40
seeds, expand 4) over an L sweep, each row the median of 3 trials after 2
discarded — so a faster build counts only with its recall frontier intact.

The index is cached under bench_torch.py's names: the default knobs
(``p2e4b4``) are bench_torch.py's own build, which
torch_probe_frontier_99.py reads; a cached index is loaded, not rebuilt.

Run on the card:   python scripts/torch_probe_build_1m.py [--expand 4]
                   [--bits 4] [--passes 2] [--Ls 40,44,48,52,56]
On the CPU (tiny): --device cpu --n_base 2000 --n_train 600 --n_eval 128
                   --cache_dir /tmp/bench_torch_cache
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
    ap.add_argument("--expand", type=int, default=bt.BUILD_EXPAND)
    ap.add_argument("--bits", type=int, default=bt.BUILD_BITS)
    ap.add_argument("--passes", type=int, default=bt.BUILD_PASSES)
    ap.add_argument("--Ls", default="40,44,48,52,56")
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--seed_sample", type=int, default=bt.SEED_SAMPLE)
    ap.add_argument("--max_degree", type=int, default=bt.SEED_MAX_DEGREE)
    ap.add_argument("--skip_serve", action="store_true")
    ap.add_argument("--build_seeds", type=int, default=0,
                    help="phase-D entry seeding (0 = medoid walk)")
    ap.add_argument("--build_seed_sample", type=int, default=4)
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

    tag = f"p{args.passes}e{args.expand}b{args.bits}"
    if args.build_seeds:
        tag += f"s{args.build_seeds}r{args.build_seed_sample}"
    index_path, ck_dir = bt.index_paths(cache, key, tag)
    if os.path.exists(index_path):
        index, build_secs = bt.load_index(index_path)
        log(f"loaded cached index {index_path} (build {build_secs}s)")
    else:
        knn = bt.build_knn(cache, key, train_q, base_dev)
        cfg = bt.build_config(args.passes, args.expand, args.bits,
                              connectivity_seeds=args.build_seeds,
                              connectivity_seed_sample=args.build_seed_sample)
        index, build_secs = bt.build_index(
            base_dev, train_q, knn, cfg, index_path, ck_dir, dev,
            sidecar={"expand": args.expand, "bits": args.bits,
                     "passes": args.passes, "build_seeds": args.build_seeds,
                     "build_seed_sample": args.build_seed_sample})

    rows = []
    if not args.skip_serve:
        fused = FusedSearcher(index, base_dev, max_degree=args.max_degree,
                              seed_sample=args.seed_sample)
        for L in (int(x) for x in args.Ls.split(",")):
            rows.append(med3_row(
                lambda warmup: fused.benchmark(
                    eval_q, k=bt.K, L=L, query_batch=bt.QUERY_BATCH,
                    expand=4, seeds=min(args.seeds, L), warmup=warmup),
                gt_i, gt_d, bt.K, bt.METRIC, L_pq=L))
            log(json.dumps(rows[-1]))
    out = {"tag": tag, "build_secs": build_secs, "rows": rows,
           "index": os.path.basename(index_path), **card_info(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
