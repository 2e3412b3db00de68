"""Flat (exact brute-force) search CLI (port of
``mysteryann_tpu/cli/search_flat.py``).

No reference counterpart: an exact scan on the device is a serving mode of
its own (see mysteryann_tpu_torch/flat.py). Same report schema as the graph
search CLIs; recall should be ~1.0 by construction.

    python -m mysteryann_tpu_torch.cli.search_flat --base_data_path B.fbin \
        --query_path Q.fbin --gt_path gt.bin --k 10 --precision int8
"""

from __future__ import annotations

import argparse

from mysteryann_tpu_torch.cli.common import (
    add_common_search_flags,
    device_from,
    load_vectors,
    result_header,
    result_row,
    write_csv,
)
from mysteryann_tpu_torch.flat import FlatIndex
from mysteryann_tpu_torch.io import read_gt_with_dist
from mysteryann_tpu_torch.utils.metrics import compute_recall, compute_rderr


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_search_flags(p)
    p.add_argument("--tile", type=int, default=262144)
    p.add_argument("--oversample", type=int, default=2)
    p.add_argument("--precision", choices=("f32", "bf16", "int8"),
                   default="f32",
                   help="bf16: bf16 scan table + exact f32 rerank; int8: "
                        "int8 scan (global scale for ip/cosine) + exact f32 "
                        "rerank. Both keep the f32 base resident too")
    args = p.parse_args(argv)
    dev = device_from(p, args)

    base = load_vectors(args.base_data_path)
    queries = load_vectors(args.query_path)
    gt_ids, gt_dists = read_gt_with_dist(args.gt_path)
    idx = FlatIndex(base, metric=args.dist or "ip", tile=args.tile,
                    oversample=args.oversample, precision=args.precision,
                    device=dev)
    r = idx.benchmark(queries, k=args.k, query_batch=args.query_batch)
    row = {
        "L_pq": 0,
        "qps": r["qps"],
        "avg_cmps": r["avg_cmps"],
        "avg_hops": 0.0,
        "mean_latency_ms": r["mean_latency_ms"],
        "recall": compute_recall(r["ids"], gt_ids, args.k),
        "rderr": compute_rderr(r["dists"], gt_dists, args.k,
                               args.dist or "ip"),
    }
    print(result_header())
    print(result_row(row))
    if args.csv_path:
        write_csv(args.csv_path, [row])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
