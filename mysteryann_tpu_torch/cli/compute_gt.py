"""Exact kNN / ground-truth CLI (port of ``mysteryann_tpu/cli/compute_gt.py``).

Replaces the external DiskANN utility step the reference outsources
(reference SURVEY: the build input `learn_base_nn_path` file and the
search-eval GT files both come from outside the repo). Computes exact
kNN on the device and writes either the kNN `.ibin` (build input format,
reference src/index_bipartite.cpp:2622-2639) or the GT ids+dists format
(reference include/efanna2e/util.h:130-177).

    python -m mysteryann_tpu_torch.cli.compute_gt --base_data_path B.fbin \
        --query_path Q.fbin --k 100 --format gt --out_path gt.bin
"""

from __future__ import annotations

import argparse

from mysteryann_tpu_torch.cli.common import (add_device_flag, device_from,
                                             load_vectors)
from mysteryann_tpu_torch.io import write_gt_with_dist, write_knn_ibin
from mysteryann_tpu_torch.ops import compute_ground_truth


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base_data_path", required=True)
    p.add_argument("--query_path", required=True)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--dist", default="ip", choices=["l2", "ip", "cosine"])
    p.add_argument("--out_path", required=True)
    p.add_argument("--format", default="knn", choices=["knn", "gt"],
                   help="knn = ids-only .ibin (build input); gt = ids+dists")
    p.add_argument("--query_batch", type=int, default=4096)
    add_device_flag(p)
    args = p.parse_args(argv)
    dev = device_from(p, args)

    base = load_vectors(args.base_data_path)
    queries = load_vectors(args.query_path)
    ids, dists = compute_ground_truth(queries, base, k=args.k,
                                      metric=args.dist,
                                      query_batch=args.query_batch,
                                      device=dev)
    if args.format == "knn":
        write_knn_ibin(args.out_path, ids)
    else:
        write_gt_with_dist(args.out_path, ids, dists)
    print(f"wrote {args.format} [{ids.shape[0]} x {ids.shape[1]}] "
          f"to {args.out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
