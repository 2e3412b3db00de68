"""Bipartite-variant benchmark at 1M, the reference's NeurIPS-track pair
(PyTorch port of scripts/bench_bipartite.py).

Builds the bipartite index (BuildBipartite / qbaseNNbipartite, reference
src/index_bipartite.cpp:42-141, 235-280) on the 1M bench corpus and sweeps
the two-hop search (SearchBipartiteGraph, :282-356) with the chunked hop-2
expansion: `make_cross_modal(1_000_000, 200_000, 128, seed=7)` in the
difficulty-calibrated world, eval queries from `query_seed=8`, exact train
kNN and ground truth, `build_bipartite(M_sq=64, M_pjbp=32,
base_row_cap=64)`, then L = 50, 100, 200, 400 at 4,096 queries a batch.

Run on the card:  python scripts/torch_bench_bipartite.py [--n_eval 4096]
`--smoke` runs the identical path on a tiny in-process world (use it with
`--device cpu` to validate the script). Emits one JSON line.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from mysteryann_tpu_torch.cli.common import add_device_flag, device_from
from _torch_benchrun import cached, card_info, default_cache_dir, log, sync

K = 10
WORLD = dict(n_concepts=20_000, intrinsic_dim=48, noise=0.85)
BUILD = dict(M_sq=64, M_pjbp=32, metric="ip")
CAP, LS, QB = 64, (50, 100, 200, 400), 4096


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny world (4,000 x 32), the same path")
    ap.add_argument("--n_base", type=int, default=1_000_000)
    ap.add_argument("--n_train", type=int, default=200_000)
    ap.add_argument("--n_eval", type=int, default=32_768)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--Ls", type=int, nargs="+", default=None)
    ap.add_argument("--cache_dir", default=default_cache_dir(__file__))
    ap.add_argument("--no_cache", action="store_true",
                    help="compute everything, write nothing to disk")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_from(ap, args)

    from mysteryann_tpu_torch.graph.bipartite import (BipartiteSearcher,
                                                      build_bipartite)
    from mysteryann_tpu_torch.io import make_cross_modal
    from mysteryann_tpu_torch.ops import exact_knn
    from mysteryann_tpu_torch.ops.distances import prepare_vectors
    from mysteryann_tpu_torch.utils.metrics import compute_recall, compute_rderr
    from mysteryann_tpu_torch.utils.params import BuildConfig

    if args.smoke:
        n, ntr, n_eval, dim = 4_000, 2_000, 256, 32
        world, cap, Ls, qbmax, seeds, cache = {}, 24, (50, 100), 256, (11, 12), None
    else:
        n, ntr, n_eval, dim = args.n_base, args.n_train, args.n_eval, args.dim
        world, cap, Ls, qbmax, seeds = WORLD, CAP, LS, QB, (7, 8)
        cache = None if args.no_cache else args.cache_dir
    Ls = tuple(args.Ls) if args.Ls else Ls
    key = f"torch_t2i1m_v3_{n}_{ntr}_{dim}"

    base, train_q = cached(cache, key + "_data", lambda: make_cross_modal(
        n, ntr, dim, metric="ip", seed=seeds[0], **world))
    (eval_q,) = cached(cache, f"{key}_evalw{n_eval}", lambda: [
        make_cross_modal(1, n_eval, dim, metric="ip", seed=seeds[0],
                         query_seed=seeds[1], **world)[1]])
    base_dev = prepare_vectors(base, "ip", dev)
    gt_i, gt_d = cached(cache, f"{key}_gtw{n_eval}", lambda: list(exact_knn(
        eval_q, base_dev, k=K, metric="ip", precision="highest"))[::-1])
    gt_i = gt_i.astype(np.int64)
    m_sq = min(BUILD["M_sq"], n - 1)
    (knn,) = cached(cache, key + "_knn", lambda: [exact_knn(
        train_q, base_dev, k=m_sq, metric="ip", query_batch=8192,
        precision="highest")[1].astype(np.int32)])

    log("== build bipartite (M_pjbp=32) ==")
    t0 = time.time()
    index = build_bipartite(base, train_q, np.asarray(knn, np.int32),
                            BuildConfig(**{**BUILD, "M_sq": m_sq}),
                            base_row_cap=cap)
    build_secs = time.time() - t0
    log(f"build {build_secs:.1f}s")

    s = BipartiteSearcher(index, base_dev)
    qb = min(qbmax, eval_q.shape[0])
    rows = []
    for L in Ls:
        # one warm-up batch, then the timed pass (closed by a synchronize)
        r = s.benchmark(eval_q, k=K, L=L, query_batch=qb, warmup=1)
        rows.append({
            "mode": f"bipartite_two_hop_L{L}",
            "qps": round(r["qps"], 1),
            "recall": round(compute_recall(r["ids"], gt_i, K), 4),
            "rderr": round(compute_rderr(r["dists"], gt_d, K, "ip"), 6),
            "avg_hops": round(r["avg_hops"], 1),
            "avg_cmps": round(r["avg_cmps"], 1)})
        log(rows[-1])
    sync(dev)
    out = {"scale": int(base.shape[0]), "build_secs": round(build_secs, 1),
           "two_hop_chunk": s.auto_two_hop_chunk(qb, dim), "rows": rows,
           **card_info(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
