"""IVF search CLI — nprobe sweep with the graph CLIs' report schema (port
of ``mysteryann_tpu/cli/search_ivf.py``).

No reference counterpart (see ``build_ivf``). The sweep knob is
``--nprobe`` (clusters scanned per query) and is reported in the table's
``L_pq`` column; ``avg_cmps`` counts scanned rows (nprobe x cap) plus the
centroid scan, ``avg_hops`` is nprobe. ``--rerank R`` re-scores the merged
top-R candidates with exact f32 rows from ``--base_data_path`` (required
for int8-store indexes to report true distances).

    python -m mysteryann_tpu_torch.cli.search_ivf --index_path ivf.npz \
        --query_path Q.fbin --gt_path gt.bin --nprobe 16 64
"""

from __future__ import annotations

import argparse
import sys

from mysteryann_tpu_torch.cli.common import (
    add_device_flag,
    device_from,
    load_vectors,
    result_header,
    result_row,
    write_csv,
)
from mysteryann_tpu_torch.io import read_gt_with_dist
from mysteryann_tpu_torch.ivf import IVFIndex
from mysteryann_tpu_torch.ops.distances import Metric
from mysteryann_tpu_torch.utils.metrics import compute_recall, compute_rderr


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_type", default="float", choices=["float"])
    p.add_argument("--dist", default="",
                   help="override metric (else the saved index's)")
    p.add_argument("--index_path", required=True,
                   help=".npz written by build_ivf / IVFIndex.save")
    p.add_argument("--base_data_path", default="",
                   help="corpus .fbin; required with --rerank")
    p.add_argument("--query_path", required=True)
    p.add_argument("--gt_path", required=True)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--nprobe", type=int, nargs="+",
                   default=[4, 8, 16, 32, 64, 128])
    p.add_argument("--rerank", type=int, default=0,
                   help="exact-f32 rerank width (0 = off)")
    p.add_argument("--num_threads", type=int, default=0,
                   help="accepted for reference compatibility; unused")
    p.add_argument("--query_batch", type=int, default=1024)
    p.add_argument("--csv_path", default="", help="append result rows as CSV")
    add_device_flag(p)
    args = p.parse_args(argv)
    dev = device_from(p, args)

    if args.rerank and not args.base_data_path:
        p.error("--rerank needs --base_data_path")
    base = load_vectors(args.base_data_path) if args.base_data_path else None
    idx = IVFIndex.load(args.index_path, base=base, device=dev)
    if args.dist and Metric.parse(args.dist) != idx.metric:
        # the metric is baked into the index at build time (cosine
        # normalization + int8 quantization happen on the stored rows) — a
        # search-time override would silently report the wrong thing
        p.error(f"--dist {args.dist!r} conflicts with the index's "
                f"baked-in metric {idx.metric.value!r}; rebuild with "
                "build_ivf --dist")
    metric = idx.metric
    queries = load_vectors(args.query_path)
    gt_ids, gt_dists = read_gt_with_dist(args.gt_path)

    print(result_header())
    rows = []
    for nprobe in args.nprobe:
        if nprobe > idx.n_clusters:
            print(f"# skipping nprobe={nprobe} (> {idx.n_clusters} "
                  "clusters)", file=sys.stderr)
            continue
        r = idx.benchmark(queries, k=args.k, nprobe=nprobe,
                          query_batch=args.query_batch, rerank=args.rerank)
        row = {
            "L_pq": nprobe,
            "qps": r["qps"],
            "avg_cmps": r["avg_cmps"],
            "avg_hops": r["avg_hops"],
            "mean_latency_ms": r["mean_latency_ms"],
            "recall": compute_recall(r["ids"], gt_ids, args.k),
            "rderr": compute_rderr(r["dists"], gt_dists, args.k, metric),
        }
        rows.append(row)
        print(result_row(row))
    if args.csv_path:
        write_csv(args.csv_path, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
