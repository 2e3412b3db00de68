"""10M-scale serving benchmark, the reference's headline T2I-10M regime
(PyTorch port of scripts/bench_10m.py).

Measures QPS and recall of the flat scan in f32, bf16, int8 (global scale)
and scan precision (the hand-written binned-scan kernel; dims that are a
multiple of 128), of the classic graph rows when scripts/torch_build_10m.py
has left an index in the cache, and of the IVF index (4,096 clusters), on
the 10M x 128 synthetic cross-modal corpus with exact ground truth.
Queries are on the device before a clock starts, timed windows are closed
by `torch.cuda.synchronize()`, and each row is the median of 3 trials after
2 discarded.

`--sharded-fused MP` serves the cached graph instead (it needs
scripts/torch_build_10m.py's index; without one the script exits 2) from
int4 byte rows of width 32 row-sharded over MP ranks
(`parallel.ShardedFusedSearcher`, expand 4, seeds min(40, L) from a 1-in-2
sample) at L = 48, 64, 96, 128, and prints only those rows. The ranks are
spawned here (`parallel.launch`): with a card each they take NCCL, when
they share fewer cards gloo (a correctness run, not a scaling figure).

Run on the card:  python scripts/torch_bench_10m.py [--skip-flat]
                  [--skip-ivf] [--only-ivf] [--no_cache] [--sharded-fused MP]
On the CPU (tiny): --device cpu --n_base 3000 --n_eval 128 --dim 32
Emits one JSON line; artifacts cache under .bench_cache/.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from mysteryann_tpu_torch.cli.common import add_device_flag, device_from
from _torch_benchrun import (cached, card_info, default_cache_dir, load_script,
                             log, med3, sync)

K = 10
N_TRAIN = 1_000_000     # the graph caches are keyed by the train-set size
FLAT_ROWS = (("f32", 2), ("bf16", 2), ("int8", 4), ("scan", 2))
GRAPH_LS = (100, 150, 250)
SHARDED_LS = (48, 64, 96, 128)
SHARDED_TIMEOUT_S = 7200


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_base", type=int, default=10_000_000)
    ap.add_argument("--n_train", type=int, default=N_TRAIN)
    ap.add_argument("--n_eval", type=int, default=32_768)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--query_batch", type=int, default=8192)
    ap.add_argument("--n_clusters", type=int, default=4096)
    ap.add_argument("--nprobes", type=int, nargs="+", default=[64, 128, 256])
    ap.add_argument("--only-ivf", action="store_true",
                    help="re-run the IVF rows alone")
    ap.add_argument("--skip-flat", action="store_true")
    ap.add_argument("--skip-ivf", action="store_true")
    ap.add_argument("--sharded-fused", type=int, metavar="MP", default=0,
                    help="serve the cached graph sharded over MP ranks "
                         "and print only those rows")
    ap.add_argument("--cache_dir", default=default_cache_dir(__file__))
    ap.add_argument("--no_cache", action="store_true",
                    help="compute everything, write nothing to disk")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_from(ap, args)

    from mysteryann_tpu_torch.flat import FlatIndex
    from mysteryann_tpu_torch.graph import RoarGraphIndex
    from mysteryann_tpu_torch.io import make_cross_modal
    from mysteryann_tpu_torch.ivf import IVFIndex
    from mysteryann_tpu_torch.ops import exact_knn
    from mysteryann_tpu_torch.ops.distances import prepare_vectors
    from mysteryann_tpu_torch.search import Searcher
    from mysteryann_tpu_torch.utils.metrics import compute_recall

    build = load_script(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "torch_build_10m.py"))
    n, dim, n_eval = args.n_base, args.dim, args.n_eval
    cache = None if args.no_cache else args.cache_dir
    key, gkey = build.keys(n, dim, args.n_train)
    found = None
    for passes in (2, 1):
        for engine in ("fused", "classic"):
            p = (os.path.join(cache, f"{gkey}_p{passes}_{engine}_proj.index")
                 if cache else "")
            if found is None and p and os.path.exists(p):
                found = (p, passes)
    if args.sharded_fused and found is None:
        log("no cached 10M index — run scripts/torch_build_10m.py first")
        sys.exit(2)

    log("== data ==")
    (base,) = cached(cache, f"{key}_base", lambda: [make_cross_modal(
        n, 10, dim, metric="ip", seed=build.WORLD_SEED, **build.WORLD)[0]])
    # eval queries of the SAME world as the base. torch_build_10m.py's
    # held-out eval split is reused when its cache exists (the graph rows
    # below were built against that world); else an independent query
    # stream of the same world
    q_path = (os.path.join(cache, f"{gkey}_queries{n_eval}.npz")
              if cache else None)
    shared = bool(q_path and os.path.exists(q_path))
    if shared:
        with np.load(q_path) as z:
            eval_q = z[z.files[1]]
    else:
        (eval_q,) = cached(cache, f"{key}_evalw{n_eval}", lambda: [
            make_cross_modal(1, n_eval, dim, metric="ip",
                             seed=build.WORLD_SEED, query_seed=18,
                             **build.WORLD)[1]])
    base_dev = prepare_vectors(base, "ip", dev)

    log("== exact GT ==")
    gt_i, _ = cached(cache, f"{gkey}_gt{n_eval}" if shared
                     else f"{key}_gtw{n_eval}",
                     lambda: list(reversed(exact_knn(
                         eval_q, base_dev, k=K, metric="ip", query_batch=2048,
                         base_tile=131072, precision="highest"))))
    gt_i = gt_i.astype(np.int64)

    rows, skipped = [], []
    if args.sharded_fused:
        rows = _sharded_fused_rows(base, eval_q, gt_i, found[0],
                                   args.sharded_fused, dev, cache)
        out = {"scale": n, "rows": rows, "sharded_fused": args.sharded_fused,
               **card_info(dev)}
        print(json.dumps(out))
        return out

    def add_row(mode, r, **extra):
        rows.append({"mode": mode, "qps": round(r["qps"], 1),
                     "qps_min": round(r["qps_min"], 1),
                     "qps_max": round(r["qps_max"], 1),
                     "recall": round(compute_recall(r["ids"], gt_i, K), 4),
                     **extra})
        log(rows[-1])

    def ivf_rows():
        log(f"== IVF ({args.n_clusters} clusters) ==")
        sync(dev)
        t0 = time.time()
        ivf = IVFIndex(base_dev, metric="ip",
                       n_clusters=min(args.n_clusters, max(16, n // 64)),
                       cap_factor=1.2, verbose=True)
        sync(dev)
        build_s = round(time.time() - t0, 1)
        log(f"ivf build: {build_s:.0f}s")
        for nprobe in args.nprobes:
            nprobe = min(nprobe, ivf.n_clusters)
            r = med3(lambda warmup: ivf.benchmark(
                eval_q, k=K, nprobe=nprobe, query_batch=args.query_batch,
                warmup=warmup))
            add_row(f"ivf_np{nprobe}", r, build_s=build_s)

    if args.only_ivf:
        ivf_rows()
        # a partial run: whoever collects results must not take this for
        # a full sweep
        out = {"scale": n, "rows": rows, "only_ivf": True, **card_info(dev)}
        print(json.dumps(out))
        return out

    if args.skip_flat:
        skipped.append("flat")
    else:
        for precision, oversample in FLAT_ROWS:
            if precision == "scan" and dim % 128:
                skipped.append("flat_scan")
                continue
            log(f"== flat {precision} ==")
            idx = FlatIndex(base_dev, metric="ip", precision=precision,
                            oversample=oversample)
            add_row(f"flat_{precision}", med3(lambda warmup: idx.benchmark(
                eval_q, k=K, query_batch=args.query_batch, warmup=warmup)))
            del idx

    # ---- RoarGraph (built by scripts/torch_build_10m.py; cached index) ----
    if found is not None and shared:
        index_path, passes = found
        build_secs = None
        try:
            with open(index_path + ".build.json") as f:
                build_secs = json.load(f)["build_secs"]
        except (OSError, KeyError, ValueError):
            pass
        log(f"== RoarGraph (cached {passes}-pass index, seeded classic) ==")
        s = Searcher(RoarGraphIndex.load(index_path), base_dev, seed_sample=8)
        for L in GRAPH_LS:
            add_row(f"graph_p{passes}_seeded_L{L}", med3(
                lambda warmup: s.benchmark(
                    eval_q, k=K, L=L, query_batch=args.query_batch,
                    visited_mode="merge", expand=4, seeds=min(32, L),
                    warmup=warmup)), build_s=build_secs)
        del s
    else:
        skipped.append("graph")

    if args.skip_ivf:
        skipped.append("ivf")
    else:
        ivf_rows()
    out = {"scale": n, "rows": rows, "skipped": skipped, **card_info(dev)}
    print(json.dumps(out))
    return out


def _sharded_fused_rows(base, eval_q, gt_i, index_path, mp, dev, cache):
    """The cached graph served by `ShardedFusedSearcher` on a 1 x MP mesh:
    one row per L of SHARDED_LS, each the median of 3 trials after 2
    discarded, recall on rank 0's results (with dp = 1 every rank serves
    every query). The ranks read the base and the queries memory-mapped
    from .npy files written for them."""
    from mysteryann_tpu_torch.parallel import launch
    from mysteryann_tpu_torch.utils.metrics import compute_recall

    log(f"== sharded fused serve (mesh 1 x {mp}, bits 4, M 32) ==")
    with tempfile.TemporaryDirectory(dir=cache) as work:
        np.save(os.path.join(work, "base.npy"), base)
        np.save(os.path.join(work, "eval_q.npy"), eval_q)
        out = launch.run(
            "torch_bench_10m:sharded_fused_rank", mp,
            (work, index_path, mp, "cpu" if dev.type == "cpu" else None),
            timeout=SHARDED_TIMEOUT_S)[0]
    rows = []
    for L, r in zip(SHARDED_LS, out):
        rows.append({"mode": f"sharded_fused_mp{mp}_L{L}",
                     "qps": round(r["qps"], 1),
                     "qps_min": round(r["qps_min"], 1),
                     "qps_max": round(r["qps_max"], 1),
                     "recall": round(compute_recall(r["ids"], gt_i, K), 4)})
        log(rows[-1])
    return rows


def sharded_fused_rank(work: str, index_path: str, mp: int, device):
    """One rank of `_sharded_fused_rows` (spawned by `parallel.launch`)."""
    from mysteryann_tpu_torch import parallel as par
    from mysteryann_tpu_torch.graph import RoarGraphIndex

    mesh = par.make_mesh_distributed(dp=1, mp=mp, device=device)
    base = np.load(os.path.join(work, "base.npy"), mmap_mode="r")
    eval_q = np.load(os.path.join(work, "eval_q.npy"))
    sf = par.ShardedFusedSearcher(mesh, RoarGraphIndex.load(index_path),
                                  base, max_degree=32, seed_sample=2, bits=4)
    del base
    return [med3(lambda warmup: sf.benchmark(
        eval_q, k=K, L=L, expand=4, seeds=min(40, L), warmup=warmup))
        for L in SHARDED_LS]


if __name__ == "__main__":
    main()
