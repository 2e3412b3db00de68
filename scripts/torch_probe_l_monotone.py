"""Tell drift from a configuration's own cost across L (PyTorch port of
scripts/probe_l_monotone.py).

A sweep that measures each L minutes after the last can rank a larger L
above a smaller one when the card's state drifts between rows. Protocol:
ONE ``FusedSearcher(max_degree=48, seed_sample=2, bits=8)`` (one table
residency) on bench_torch.py's cached ``p2e4b4`` index; L in (40, 44, 48,
56), each ramped with 2 discarded trials (the first with a warm-up), then
10 rounds with the L values INTERLEAVED round-robin (config order cannot
alias drift); per L the median, min and max QPS and recall@10 (expand 4,
40 seeds, 8,192-query batches).

Run on an otherwise idle card after bench_torch.py has built its index:
                   python scripts/torch_probe_l_monotone.py
On the CPU (tiny): --device cpu --n_base 2000 --n_train 600 --n_eval 128
                   --cache_dir /tmp/bt
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
from _torch_benchrun import card_info, log  # noqa: E402

K = 10
LS = (40, 44, 48, 56)
TRIALS = 10
RAMP = 2
EXPAND, SEEDS, QB = 4, 40, 8192


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
    from mysteryann_tpu_torch.utils.metrics import compute_recall

    cache, key = args.cache_dir, bt.world_key(args.n_base, args.n_train)
    index_path, _ = bt.index_paths(cache, key)
    if not os.path.exists(index_path):
        ap.exit(2, f"no index at {index_path}: run bench_torch.py or "
                   f"scripts/torch_probe_build_1m.py first\n")
    base, _, eval_q = bt.world(cache, args.n_base, args.n_train, args.n_eval)
    base_dev = prepare_vectors(base, bt.METRIC, dev)
    gt_i, _ = bt.ground_truth(cache, key, eval_q, base_dev)
    index, _ = bt.load_index(index_path)
    fused = FusedSearcher(index, base_dev, max_degree=bt.SEED_MAX_DEGREE,
                          seed_sample=bt.SEED_SAMPLE, bits=8)

    def bench(L, warmup):
        return fused.benchmark(eval_q, k=K, L=L, query_batch=QB,
                               expand=EXPAND, seeds=min(SEEDS, L),
                               warmup=warmup)

    # warm + ramp-discard each L once
    for L in LS:
        for t in range(RAMP):
            bench(L, 1 if t == 0 else 0)
        log(f"L={L} ramped")

    qps = {L: [] for L in LS}
    recall = {}
    for t in range(TRIALS):
        for L in LS:  # interleaved: config order cannot alias drift
            r = bench(L, 0)
            qps[L].append(round(r["qps"], 1))
            if t == 0:
                recall[L] = round(float(compute_recall(r["ids"], gt_i, K)), 4)
        log(f"round {t}: " + " ".join(f"L{L}={qps[L][-1]:.0f}" for L in LS))

    rows = []
    for L in LS:
        s = sorted(qps[L])
        rows.append({"L": L, "median": s[len(s) // 2], "min": s[0],
                     "max": s[-1], "recall": recall[L], "trials": qps[L]})
        log(rows[-1])
    out = {"probe": "l_monotone", "rows": rows, **card_info(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
