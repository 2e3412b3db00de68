"""Bipartite-variant build CLI (port of
``mysteryann_tpu/cli/build_bipartite.py``) — counterpart of the reference
test_only_build_bipartite driver (reference
tests/test_only_build_bipartite.cpp:129-137): materialize the bipartite
graph from the train→base kNN and save it.

    python -m mysteryann_tpu_torch.cli.build_bipartite --base_data_path B.fbin \
        --sampled_query_data_path T.fbin --bipartite_index_save_path I.index
"""

from __future__ import annotations

import argparse
import time

from mysteryann_tpu_torch.cli.common import (add_common_build_flags,
                                             device_from, load_vectors)
from mysteryann_tpu_torch.graph import build_bipartite
from mysteryann_tpu_torch.io import read_knn_ibin
from mysteryann_tpu_torch.ops import exact_knn
from mysteryann_tpu_torch.utils.params import BuildConfig


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_build_flags(p)
    p.add_argument("--bipartite_index_save_path", required=True)
    p.add_argument("--base_row_cap", type=int, default=0,
                   help="bound base in-degree (0 = unbounded, reference "
                        "behavior)")
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    dev = device_from(p, args)
    base = load_vectors(args.base_data_path)
    train_q = load_vectors(args.sampled_query_data_path)
    if args.learn_base_nn_path:
        knn = read_knn_ibin(args.learn_base_nn_path,
                            expected_k=args.M_pjbp)
    else:
        print(f"computing exact train->base kNN (k={args.M_pjbp}) on {dev}")
        _, knn = exact_knn(train_q, base, k=args.M_pjbp, metric=args.dist,
                           query_batch=args.query_batch, device=dev)
    cfg = BuildConfig(M_sq=args.M_sq, M_pjbp=args.M_pjbp,
                      L_pjpq=args.L_pjpq, metric=args.dist)
    index = build_bipartite(base, train_q, knn, cfg,
                            base_row_cap=args.base_row_cap)
    index.save(args.bipartite_index_save_path)
    print(f"saved bipartite index ({index.n_total} nodes, width "
          f"{index.neighbors.shape[1]}) to {args.bipartite_index_save_path}")
    print(f"build wall time: {time.perf_counter() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
