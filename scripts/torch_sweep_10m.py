"""Serve-only sweep on the cached 10M RoarGraph: the QPS at recall >= .95
frontier (PyTorch port of scripts/sweep_10m.py).

scripts/torch_build_10m.py serves at L >= 100; the reference's metric of
record is QPS at recall@10 = 0.95, which the seeded walk may cross well
below L = 100. This sweep loads the cached index (torch_build_10m.py must
have run with the same sizes) and grids (seed_sample, L) without
rebuilding anything.

Run on the card:  python scripts/torch_sweep_10m.py [--passes 1]
                  [--Ls 30 40 60 80]
Emits one JSON line with every row; exits 2 when there is no cached index.
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
from _torch_benchrun import card_info, default_cache_dir, load_script, log

K = 10


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_base", type=int, default=10_000_000)
    ap.add_argument("--n_train", type=int, default=1_000_000)
    ap.add_argument("--n_eval", type=int, default=32_768)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--engine", default="auto",
                    help="the engine tag of the cached index: 'auto' takes "
                         "whichever of fused / classic is cached")
    ap.add_argument("--Ls", type=int, nargs="+", default=[30, 40, 60, 80])
    ap.add_argument("--seed_samples", type=int, nargs="+", default=[4, 8])
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--expand", type=int, default=4)
    ap.add_argument("--query_batch", type=int, default=8192)
    ap.add_argument("--cache_dir", default=default_cache_dir(__file__))
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_from(ap, args)

    from mysteryann_tpu_torch.graph import RoarGraphIndex
    from mysteryann_tpu_torch.ops.distances import prepare_vectors
    from mysteryann_tpu_torch.search import Searcher
    from mysteryann_tpu_torch.utils.metrics import compute_recall, compute_rderr

    build = load_script(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "torch_build_10m.py"))
    n, ntr = args.n_base, args.n_train
    key, gkey = build.keys(n, args.dim, ntr)
    engines = ("fused", "classic") if args.engine == "auto" else (args.engine,)
    index_path = next((p for p in (os.path.join(
        args.cache_dir, f"{gkey}_p{args.passes}_{e}_proj.index")
        for e in engines) if os.path.exists(p)), None)
    if index_path is None:
        log(f"no cached {args.passes}-pass index under {args.cache_dir}; "
            f"run scripts/torch_build_10m.py")
        sys.exit(2)

    def loadz(name):
        with np.load(os.path.join(args.cache_dir, name + ".npz")) as z:
            return [z[k] for k in z.files]

    t0 = time.time()
    (base,) = loadz(f"{key}_base")
    _, eval_q = loadz(f"{gkey}_queries{args.n_eval}")
    gt_i, gt_d = loadz(f"{gkey}_gt{args.n_eval}")   # cached as [ids, dists]
    gt_i = gt_i.astype(np.int64)
    if gt_i.ndim != 2 or not np.issubdtype(gt_d.dtype, np.floating):
        raise ValueError(f"{gkey}_gt{args.n_eval}.npz is not [ids, dists]")
    index = RoarGraphIndex.load(index_path)
    base_dev = prepare_vectors(base, "ip", dev)
    log(f"loaded base {base.shape} + index in {time.time() - t0:.0f}s")

    rows = []
    for r in args.seed_samples:
        s = Searcher(index, base_dev, seed_sample=r)
        for L in args.Ls:
            br = s.benchmark(eval_q, k=K, L=L, query_batch=args.query_batch,
                             visited_mode="merge", expand=args.expand,
                             seeds=min(args.seeds, L))
            rows.append({
                "mode": f"graph_p{args.passes}_r{r}_L{L}",
                "qps": round(br["qps"], 1),
                "recall": round(compute_recall(br["ids"], gt_i, K), 4),
                "rderr": round(compute_rderr(br["dists"], gt_d, K, "ip"), 6),
                "avg_hops": round(br["avg_hops"], 1)})
            log(rows[-1])
        del s

    out = {"scale": n, "passes": args.passes, "rows": rows,
           "index": os.path.basename(index_path), **card_info(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
