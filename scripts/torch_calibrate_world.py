"""Calibrate the synthetic world's difficulty against the reference binary
(PyTorch port of scripts/calibrate_world.py).

The world generator's difficulty knobs (concept count, intrinsic dimension,
concept noise) are chosen against the reference's own binary: pick the
config whose recall@10-vs-L_pq frontier, measured by the unmodified
reference (``baseline/bench_reference``), crosses the target in the wanted
L band. The recorded v3 calibration (BASELINE.md) is ``--n_concepts 20000
--intrinsic_dim 48 --noise 0.85`` at 1M, which these defaults reproduce
(one single-core reference build, then the L sweep; pass --Ls to refine
around the crossing).

Pipeline per config: the world from the port's `make_cross_modal` (the
generator bench_torch.py uses) -> exact train kNN and in-world eval ground
truth with the port's `exact_knn` on the card -> fbin / ibin exports ->
reference build and search sweep -> the first row at the target. Artifacts
land in ``--workdir`` keyed by the config, so a re-run reuses the build.
When the config is bench_torch.py's v3 world, its cached arrays are reused
(the world under bench.py's names, kNN and ground truth under the port's
``torch_`` keys); another config caches its own arrays, the port's prefixed
``torch_``. Nothing is written into ``baseline/`` (scripts/torch_reference.py).

Run:               python scripts/torch_calibrate_world.py [--threads 16]
On the CPU (tiny): --device cpu --n_base 3000 --n_train 600 --n_eval 256
                   --dim 32 --n_concepts 200 --intrinsic_dim 16 --M_sq 16
                   --M_pjbp 8 --L_pjpq 32 --Ls 10,50 --cache_dir /tmp/cal
Prints the JSON result (rows, crossing_L, crossing_qps) on stdout.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import bench_torch as bt  # noqa: E402
import torch_reference as ref  # noqa: E402
import torch_run_baseline_1m as r1  # noqa: E402
from mysteryann_tpu_torch.cli.common import add_device_flag, device_from  # noqa: E402
from _torch_benchrun import cached, log  # noqa: E402

NAMES = {"base": "base.fbin", "train": "train.fbin", "knn": "knn.ibin",
         "eval": "eval.fbin", "gt": "gt.ibin"}


def world_key(args) -> str:
    return (f"cal_n{args.n_base}_t{args.n_train}_d{args.dim}"
            f"_c{args.n_concepts}_h{args.intrinsic_dim}"
            f"_z{args.noise:g}_s{args.seed}")


def is_bench_v3(args) -> bool:
    return (args.n_base == 1_000_000 and args.n_train == 200_000
            and args.dim == 128 and args.n_concepts == 20_000
            and args.intrinsic_dim == 48 and abs(args.noise - 0.85) < 1e-9
            and args.seed == 7 and args.n_eval == 32768)


def load_or_make(args, cache: str, dev: torch.device):
    """(key, base, train, eval_q, train_knn, gt_i int32): from
    bench_torch.py's cache for its v3 world, else this config's own."""
    from mysteryann_tpu_torch.io import make_cross_modal
    from mysteryann_tpu_torch.ops import exact_knn
    from mysteryann_tpu_torch.ops.distances import prepare_vectors

    if is_bench_v3(args):
        key = bt.world_key(args.n_base, args.n_train)
        log(f"config == bench_torch.py v3; reusing its {key}_* arrays")
        base, train, knn, eval_q, gt_i = r1.inputs(
            cache, dev, args.n_base, args.n_train, args.n_eval)
        return key, base, train, eval_q, knn, gt_i.astype(np.int32)
    key = world_key(args)
    world = dict(n_concepts=args.n_concepts,
                 intrinsic_dim=args.intrinsic_dim, noise=args.noise)
    base, train = cached(cache, key + "_data", lambda: make_cross_modal(
        args.n_base, args.n_train, args.dim, metric="ip", seed=args.seed,
        **world))
    (eval_q,) = cached(
        cache, f"{key}_evalw{args.n_eval}",
        lambda: [make_cross_modal(1, args.n_eval, args.dim, metric="ip",
                                  seed=args.seed, query_seed=args.seed + 1,
                                  **world)[1]])
    base_dev = prepare_vectors(base, "ip", dev)
    gt_i, _ = cached(cache, f"torch_{key}_gtw{args.n_eval}", lambda: list(
        reversed(exact_knn(eval_q, base_dev, k=10, metric="ip",
                           query_batch=8192, base_tile=131072,
                           precision="highest"))))
    # the train kNN's width is M_sq: its key carries it
    (knn,) = cached(cache, f"torch_{key}_knn{args.M_sq}", lambda: [exact_knn(
        train, base_dev, k=args.M_sq, metric="ip", query_batch=8192,
        base_tile=131072, approx=True)[1]])
    del base_dev
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return key, base, train, eval_q, knn, gt_i.astype(np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # world knobs (defaults = the recorded v3 calibration)
    ap.add_argument("--n_concepts", type=int, default=20_000)
    ap.add_argument("--intrinsic_dim", type=int, default=48)
    ap.add_argument("--noise", type=float, default=0.85)
    ap.add_argument("--seed", type=int, default=7)
    # scale knobs (1M = the recorded calibration scale; smaller scales
    # shift the crossing left: calibrate at the scale that is benched)
    ap.add_argument("--n_base", type=int, default=1_000_000)
    ap.add_argument("--n_train", type=int, default=200_000)
    ap.add_argument("--n_eval", type=int, default=32768)
    ap.add_argument("--dim", type=int, default=128)
    # reference build / search params (bench_torch.py's)
    ap.add_argument("--M_sq", type=int, default=64)
    ap.add_argument("--M_pjbp", type=int, default=32)
    ap.add_argument("--L_pjpq", type=int, default=128)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--Ls", default="15,50,100,125,150,200,250,400")
    ap.add_argument("--target", type=float, default=0.95)
    ap.add_argument("--workdir", default=None,
                    help="where the exports and reference indexes go "
                         "(default: <cache_dir>/calibrate_world)")
    ap.add_argument("--cache_dir", default=bt.CACHE)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_from(ap, args)

    def body():
        exe = ref.reference_binary()
        key, base, train, eval_q, knn, gt_i = load_or_make(
            args, args.cache_dir, dev)
        wd = os.path.join(args.workdir or os.path.join(
            args.cache_dir, "calibrate_world"), key)
        paths = ref.export_inputs(wd, NAMES, base, train, knn, eval_q, gt_i)
        index_p = os.path.join(
            wd, f"ref_{args.M_sq}_{args.M_pjbp}_{args.L_pjpq}.index")
        ref.build(exe, paths, index_p, args.M_sq, args.M_pjbp, args.L_pjpq,
                  args.threads)
        rows = ref.search(exe, paths, index_p, 10, args.threads, args.Ls)
        cross = ref.crossing(rows, args.target)
        out = {
            "world": {"n_concepts": args.n_concepts,
                      "intrinsic_dim": args.intrinsic_dim,
                      "noise": args.noise, "seed": args.seed},
            "scale": {"n_base": args.n_base, "n_train": args.n_train,
                      "dim": args.dim, "n_eval": args.n_eval},
            "rows": rows,
            "crossing_L": cross["L_pq"] if cross else None,
            "crossing_qps": cross["qps"] if cross else None,
            "target": args.target,
        }
        print(json.dumps(out, indent=1))
        return out

    return ref.exit_on_failure(body)


if __name__ == "__main__":
    main()
