"""Measure the reference C++ binary on the CPU on the 4M world of
scripts/torch_bench_4m_fused.py (PyTorch port of scripts/run_baseline_4m.py).

Reads torch_bench_4m_fused.py's cache (``torch_t2i4m_v3_{n}_{dim}``: the
world, and ``{gkey}_gt{n_eval}`` / ``{gkey}_knn``), making what is missing
on the card with that script's world and the port's `exact_knn` under the
same keys and with the same calls, so either script reuses the other's
arrays. Exports them to fbin / ibin with the port's ``io/formats.py``,
builds the reference index unless the work directory holds one, and runs
the reference's OpenMP search sweep; ``--prep-only`` stops after the
exports (the card's part). The card is released before the reference runs.

The binary is the tracked ``baseline/bench_reference``; nothing is written
into ``baseline/`` (scripts/torch_reference.py).

Run:               python scripts/torch_run_baseline_4m.py [--threads 16]
                   [--prep-only] [--workdir DIR]
On the CPU (tiny): --device cpu --n_base 3000 --n_train 600 --n_eval 256
                   --dim 32 --threads 1 --cache_dir /tmp/bt
Emits one JSON line (none with --prep-only): the sweep's rows, the first
row at recall@10 >= .95, the build seconds, the host's CPU and core count.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import torch_bench_4m_fused as b4  # noqa: E402
import torch_reference as ref  # noqa: E402
from mysteryann_tpu_torch.cli.common import add_device_flag, device_from  # noqa: E402
from _torch_benchrun import cached, default_cache_dir, log  # noqa: E402

NAMES = {"base": "base.fbin", "train": "train.fbin",
         "knn": "train_knn.ibin", "eval": "evalw.fbin",
         "gt": "evalw_gt.ibin"}
TARGET_RECALL = 0.95


def inputs(cache: str, dev: torch.device, n: int, ntr: int, n_eval: int,
           dim: int):
    """(base, train_q, knn, eval_q, gt_i) under torch_bench_4m_fused.py's
    keys, made on ``dev`` where missing."""
    from mysteryann_tpu_torch.ops import exact_knn
    from mysteryann_tpu_torch.ops.distances import prepare_vectors
    key = f"torch_t2i4m_v3_{n}_{dim}"
    gkey = f"{key}_graph{ntr}"
    m_sq = min(b4.M_SQ, n - 1)
    base, train_q, eval_q = cached(
        cache, f"{key}_all{ntr}_{n_eval}",
        lambda: b4.make_world(n, ntr, n_eval, dim))
    base_dev = prepare_vectors(base, "ip", dev)
    gt_i, _ = cached(cache, f"{gkey}_gt{n_eval}", lambda: list(
        exact_knn(eval_q, base_dev, k=b4.K, metric="ip", query_batch=4096,
                  base_tile=131072, precision="highest"))[::-1])
    (knn,) = cached(cache, f"{gkey}_knn", lambda: [exact_knn(
        train_q, base_dev, k=m_sq, metric="ip", query_batch=8192,
        base_tile=131072)[1].astype(np.int32)])
    del base_dev
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return base, train_q, knn, eval_q, gt_i


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=None,
                    help="where the exports and the reference index go "
                         "(default: <cache_dir>/baseline_4m)")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--Ls", default="50,100,150,200,250,400,700")
    ap.add_argument("--prep-only", action="store_true",
                    help="compute / cache kNN + GT and export the inputs; "
                         "skip the reference build and search")
    ap.add_argument("--n_base", type=int, default=4_000_000)
    ap.add_argument("--n_train", type=int, default=400_000)
    ap.add_argument("--n_eval", type=int, default=32_768)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--cache_dir", default=default_cache_dir(__file__))
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_from(ap, args)
    wd = args.workdir or os.path.join(args.cache_dir, "baseline_4m")

    def body():
        exe = None if args.prep_only else ref.reference_binary()
        paths = ref.export_inputs(wd, NAMES, *inputs(
            args.cache_dir, dev, args.n_base, args.n_train, args.n_eval,
            args.dim))
        if args.prep_only:
            log("prep done (kNN / GT cached, inputs exported)")
            return {}
        index_p = os.path.join(wd, "ref4m.index")
        m_sq = min(b4.M_SQ, args.n_base - 1)
        build_secs = ref.build(exe, paths, index_p, m_sq, b4.M_PJBP,
                               b4.L_PJPQ, args.threads)
        rows = ref.search(exe, paths, index_p, b4.K, args.threads, args.Ls)
        cross = ref.crossing(rows, TARGET_RECALL)
        out = {"scale": args.n_base, "n_train": args.n_train,
               "n_eval": args.n_eval, "threads": args.threads,
               "build_secs": build_secs, "rows": rows,
               "crossing_L": cross["L_pq"] if cross else None,
               "crossing_qps": cross["qps"] if cross else None,
               "target": TARGET_RECALL,
               "binary": os.path.relpath(exe, ref.REPO), **ref.host_cpu()}
        print(json.dumps(out))
        return out

    return ref.exit_on_failure(body)


if __name__ == "__main__":
    main()
