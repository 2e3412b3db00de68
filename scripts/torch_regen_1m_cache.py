"""Fill bench_torch.py's 1M cache (PyTorch port of scripts/regen_1m_cache.py):
the world (base, train and eval queries), the exact ground truth and the
build's train kNN, each under the key bench_torch.py reads, so that a later
bench_torch.py run (and the torch_probe_* / torch_sweep_1m_p3 scripts) goes
straight to building or timing.

Run on the card:   python scripts/torch_regen_1m_cache.py
On the CPU (tiny): --device cpu --n_base 2000 --n_train 600 --n_eval 128
                   --cache_dir /tmp/bench_torch_cache
Emits one JSON line: each step's seconds and the cache's file names.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import bench_torch as bt  # noqa: E402
from mysteryann_tpu_torch.cli.common import add_device_flag, device_from  # noqa: E402
from _torch_benchrun import card_info, log  # noqa: E402


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

    cache, key = args.cache_dir, bt.world_key(args.n_base, args.n_train)
    secs = {}
    t0 = time.time()
    base, train_q, eval_q = bt.world(cache, args.n_base, args.n_train,
                                     args.n_eval)
    secs["data"] = round(time.time() - t0, 1)
    log(f"data: {secs['data']}s")
    base_dev = prepare_vectors(base, bt.METRIC, dev)
    t0 = time.time()
    bt.ground_truth(cache, key, eval_q, base_dev)
    secs["gt"] = round(time.time() - t0, 1)
    log(f"gt: {secs['gt']}s")
    t0 = time.time()
    bt.build_knn(cache, key, train_q, base_dev)
    secs["knn"] = round(time.time() - t0, 1)
    log(f"train knn: {secs['knn']}s")

    out = {"key": key, "secs": secs,
           "files": sorted(f for f in os.listdir(cache)
                           if f.startswith(("torch_" + key, key))),
           **card_info(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
