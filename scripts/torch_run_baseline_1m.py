"""Measure the reference C++ binary on the CPU on bench_torch.py's 1M world
(PyTorch port of scripts/run_baseline_1m.py).

Reads bench_torch.py's cache: the world arrays under bench.py's names and
the port's own ``torch_{key}_knn`` / ``torch_{key}_gtw{n_eval}``, making
what is missing with bench_torch.py's `world` / `build_knn` /
`ground_truth` on the card. Exports base, train queries, train kNN, eval
queries and the ground-truth ids to fbin / ibin with the port's
``io/formats.py``, builds the reference index unless the work directory
holds one (it does not depend on the eval queries), and runs the
reference's own OpenMP search sweep. The card is released before the
reference runs: the measurement is the CPU's alone.

The binary is the tracked ``baseline/bench_reference``; nothing is written
into ``baseline/`` (scripts/torch_reference.py says how a missing one is
built, and why a binary that cannot start ends the run).

Run:               python scripts/torch_run_baseline_1m.py [--threads 16]
                   [--Ls 50,100,150,250,400,700,1000] [--workdir DIR]
On the CPU (tiny): --device cpu --n_base 3000 --n_train 600 --n_eval 256
                   --threads 1 --cache_dir /tmp/bt --workdir /tmp/ref1m
Emits one JSON line: the sweep's rows, the first row at recall@10 >= .95,
the reference's build seconds and threads, the host's CPU and core count.
"""

import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import bench_torch as bt  # noqa: E402
import torch_reference as ref  # noqa: E402
from mysteryann_tpu_torch.cli.common import add_device_flag, device_from  # noqa: E402

NAMES = {"base": "base.fbin", "train": "train.fbin",
         "knn": "train_knn.ibin", "eval": "evalw.fbin",
         "gt": "evalw_gt.ibin"}


def inputs(cache: str, dev: torch.device, n_base: int, n_train: int,
           n_eval: int):
    """(base, train_q, knn, eval_q, gt_i) from bench_torch.py's cache,
    made on ``dev`` where missing."""
    from mysteryann_tpu_torch.ops.distances import prepare_vectors
    key = bt.world_key(n_base, n_train)
    base, train_q, eval_q = bt.world(cache, n_base, n_train, n_eval)
    base_dev = prepare_vectors(base, bt.METRIC, dev)
    knn = bt.build_knn(cache, key, train_q, base_dev)
    gt_i, _ = bt.ground_truth(cache, key, eval_q, base_dev)
    del base_dev
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return base, train_q, knn, eval_q, gt_i


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=None,
                    help="where the exports and the reference index go "
                         "(default: <cache_dir>/baseline_v3)")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--Ls", default="50,100,150,250,400,700,1000")
    ap.add_argument("--n_base", type=int, default=bt.N_BASE)
    ap.add_argument("--n_train", type=int, default=bt.N_TRAIN)
    ap.add_argument("--n_eval", type=int, default=bt.N_EVAL)
    ap.add_argument("--cache_dir", default=bt.CACHE)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_from(ap, args)
    wd = args.workdir or os.path.join(args.cache_dir, "baseline_v3")

    def body():
        exe = ref.reference_binary()
        paths = ref.export_inputs(wd, NAMES, *inputs(
            args.cache_dir, dev, args.n_base, args.n_train, args.n_eval))
        index_p = os.path.join(wd, "ref1m.index")
        build_secs = ref.build(exe, paths, index_p, bt.M_SQ, bt.M_PJBP,
                               bt.L_PJPQ, args.threads)
        rows = ref.search(exe, paths, index_p, bt.K, args.threads, args.Ls)
        cross = ref.crossing(rows, bt.TARGET_RECALL)
        out = {"world": bt.world_key(args.n_base, args.n_train),
               "n_eval": args.n_eval, "threads": args.threads,
               "build_secs": build_secs, "rows": rows,
               "crossing_L": cross["L_pq"] if cross else None,
               "crossing_qps": cross["qps"] if cross else None,
               "target": bt.TARGET_RECALL,
               "binary": os.path.relpath(exe, ref.REPO), **ref.host_cpu()}
        print(json.dumps(out))
        return out

    return ref.exit_on_failure(body)


if __name__ == "__main__":
    main()
