"""High-recall frontier of the seeded fused sweep (PyTorch port of
scripts/probe_frontier_99.py): load bench_torch.py's cached 2-pass index
(``p2e4b4``) and walk configurations up in L until recall@10 crosses .992,
each row the median of 3 trials after 2 discarded. Expand shrinks as L
grows; the last configuration deepens the exact rerank head.

Run on the card after bench_torch.py (or torch_probe_build_1m.py) has built
the index:  python scripts/torch_probe_frontier_99.py
On the CPU (tiny): --device cpu --n_base 2000 --n_train 600 --n_eval 128
                   --cache_dir /tmp/bench_torch_cache
Emits one JSON line with every row measured.
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

# (label, max_degree, expand, seeds, seed_sample, rerank, Ls)
CONFIGS = [
    ("e4_hi", 48, 4, 40, 2, 0, (112, 128)),
    ("e3_hi", 48, 3, 48, 2, 0, (144, 176)),
    ("e2_hi", 48, 2, 48, 2, 0, (224, 320)),
    ("e2_rr", 48, 2, 48, 2, 96, (320, 448)),
]
STOP_RECALL = 0.992


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    index_path, _ = bt.index_paths(cache, key)
    if not os.path.exists(index_path):
        ap.exit(2, f"no index at {index_path}: run bench_torch.py or "
                   f"scripts/torch_probe_build_1m.py first\n")
    base, _, eval_q = bt.world(cache, args.n_base, args.n_train, args.n_eval)
    base_dev = prepare_vectors(base, bt.METRIC, dev)
    gt_i, gt_d = bt.ground_truth(cache, key, eval_q, base_dev)
    index, _ = bt.load_index(index_path)

    rows, fused, last_key = [], None, None
    for label, md, expand, seeds, ss, rerank, Ls in CONFIGS:
        if (md, ss) != last_key:
            del fused
            fused = FusedSearcher(index, base_dev, max_degree=md,
                                  seed_sample=ss)
            last_key = (md, ss)
        for L in Ls:
            rows.append(med3_row(
                lambda warmup: fused.benchmark(
                    eval_q, k=bt.K, L=L, query_batch=bt.QUERY_BATCH,
                    expand=expand, seeds=min(seeds, L), rerank=rerank,
                    warmup=warmup),
                gt_i, gt_d, bt.K, bt.METRIC, config=label, L_pq=L,
                expand=expand, seeds=seeds, rerank=rerank))
            log(json.dumps(rows[-1]))
            if rows[-1]["recall"] >= STOP_RECALL:
                break
        if rows[-1]["recall"] >= STOP_RECALL:
            break
    out = {"rows": rows, "index": os.path.basename(index_path),
           **card_info(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
