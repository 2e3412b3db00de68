"""RoarGraph search/eval CLI (port of
``mysteryann_tpu/cli/search_roargraph.py``) — counterpart of the reference
search program (reference tests/test_search_roargraph.cpp): load base +
index + queries + GT, sweep L_pq, report QPS / avg cmps / latency /
recall@k / rderr / avg hops per row, optionally appending CSV
(schema: tests/test_search_roargraph.cpp:185-188, 233-236).

    python -m mysteryann_tpu_torch.cli.search_roargraph --base_data_path B.fbin \
        --projection_index_save_path I.index --query_path Q.fbin \
        --gt_path gt.bin --k 10 --L_pq 64 100 200
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
from mysteryann_tpu_torch.graph import RoarGraphIndex
from mysteryann_tpu_torch.io import read_gt_with_dist
from mysteryann_tpu_torch.search.fused import FusedSearcher
from mysteryann_tpu_torch.search.searcher import Searcher
from mysteryann_tpu_torch.utils.metrics import compute_recall, compute_rderr


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_search_flags(p)
    p.add_argument("--projection_index_save_path", required=True)
    p.add_argument("--engine", default="classic",
                   choices=("classic", "fused"),
                   help="fused = int8 inline neighbor blocks, one row "
                        "gather per expansion (index must fit the packed "
                        "table)")
    p.add_argument("--seeds", type=int, default=0,
                   help="per-query entry points from a coarse sample scan "
                        "(replaces the medoid walk; see search/seeding.py)")
    p.add_argument("--seed_sample", type=int, default=0,
                   help="1-in-r strided base sample rate for --seeds "
                        "(default 8 when --seeds is set)")
    p.add_argument("--expand", type=int, default=1,
                   help="closest-unexpanded entries popped per lockstep "
                        "step (amortizes pool maintenance)")
    p.add_argument("--bits", type=int, default=8, choices=(8, 4),
                   help="fused traversal-row quantization; 4 halves the "
                        "per-expansion row bytes (reported distances stay "
                        "exact f32 via the rerank)")
    args = p.parse_args(argv)
    dev = device_from(p, args)

    base = load_vectors(args.base_data_path)
    queries = load_vectors(args.query_path)
    gt_ids, gt_dists = read_gt_with_dist(args.gt_path)
    index = RoarGraphIndex.load(args.projection_index_save_path,
                                metric=args.dist or None,
                                dim=base.shape[1])
    if index.graph.n_nodes != base.shape[0]:
        p.error(f"index has {index.graph.n_nodes} nodes but "
                f"--base_data_path has {base.shape[0]} rows — wrong "
                "corpus for this index?")
    ss = args.seed_sample or (8 if args.seeds else 0)
    if args.engine == "fused":
        searcher = FusedSearcher(index, base, seed_sample=ss, bits=args.bits,
                                 device=dev)
    else:
        if args.bits != 8:
            p.error("--bits applies to --engine fused only")
        searcher = Searcher(index, base, seed_sample=ss,
                            device=dev)
    print(f"base {base.shape}, queries {queries.shape}, "
          f"graph degree avg {index.graph.degree_stats()['avg']:.1f}, "
          f"metric {index.metric.value}")
    print(result_header())
    rows = []
    for L in args.L_pq:
        if L < max(args.k, args.seeds):
            continue  # pool must hold k results and all seed entries
        r = searcher.benchmark(queries, k=args.k, L=L,
                               query_batch=args.query_batch,
                               seeds=args.seeds, expand=args.expand)
        r["recall"] = compute_recall(r["ids"], gt_ids, args.k)
        r["rderr"] = compute_rderr(r["dists"], gt_dists, args.k, index.metric)
        print(result_row(r))
        rows.append(r)
    if args.csv_path:
        write_csv(args.csv_path, rows)
        print(f"appended {len(rows)} rows to {args.csv_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
