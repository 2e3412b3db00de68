"""Bipartite-variant search/eval CLI (port of
``mysteryann_tpu/cli/search_bipartite.py``) — counterpart of the reference
test_search_bipartite driver (reference tests/test_search_bipartite.cpp):
two-hop search over the bipartite graph, same report schema as the
RoarGraph search CLI.

    python -m mysteryann_tpu_torch.cli.search_bipartite --base_data_path B.fbin \
        --bipartite_index_save_path I.index --query_path Q.fbin \
        --gt_path gt.bin --L_pq 50 100
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
from mysteryann_tpu_torch.graph import BipartiteIndex, BipartiteSearcher
from mysteryann_tpu_torch.io import read_gt_with_dist
from mysteryann_tpu_torch.utils.metrics import compute_recall, compute_rderr


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_search_flags(p)
    p.add_argument("--bipartite_index_save_path", required=True)
    p.add_argument("--seed", type=int, default=0,
                   help="entry-point RNG seed (reference uses 10 random "
                        "base seeds per query)")
    args = p.parse_args(argv)
    dev = device_from(p, args)

    base = load_vectors(args.base_data_path)
    queries = load_vectors(args.query_path)
    gt_ids, gt_dists = read_gt_with_dist(args.gt_path)
    index = BipartiteIndex.load(args.bipartite_index_save_path,
                                metric=args.dist or None,
                                dim=base.shape[1])
    searcher = BipartiteSearcher(index, base, seed=args.seed, device=dev)
    print(result_header())
    rows = []
    for L in args.L_pq:
        if L < args.k:
            continue
        r = searcher.benchmark(queries, k=args.k, L=L,
                               query_batch=args.query_batch)
        r["recall"] = compute_recall(r["ids"], gt_ids, args.k)
        r["rderr"] = compute_rderr(r["dists"], gt_dists, args.k,
                                   index.metric)
        print(result_row(r))
        rows.append(r)
    if args.csv_path:
        write_csv(args.csv_path, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
