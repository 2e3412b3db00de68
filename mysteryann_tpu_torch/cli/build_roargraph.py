"""RoarGraph build CLI (port of ``mysteryann_tpu/cli/build_roargraph.py``) —
counterpart of the reference build program (reference
tests/test_build_roargraph.cpp): load base + sampled training queries +
train→base kNN, build the projection graph, save it.

Unlike the reference, `--learn_base_nn_path` is optional: when omitted the
exact kNN is computed in-framework on the device (the reference requires a
precomputed DiskANN file). The connectivity engine is the config's
default, "auto", as in the JAX package's CLI.

    python -m mysteryann_tpu_torch.cli.build_roargraph --base_data_path B.fbin \
        --sampled_query_data_path T.fbin --projection_index_save_path I.index
"""

from __future__ import annotations

import argparse
import time

from mysteryann_tpu_torch.cli.common import (add_common_build_flags,
                                             device_from, load_vectors)
from mysteryann_tpu_torch.graph import build_roargraph
from mysteryann_tpu_torch.io import read_knn_ibin
from mysteryann_tpu_torch.ops import exact_knn, prepare_vectors
from mysteryann_tpu_torch.utils.params import BuildConfig


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_build_flags(p)
    p.add_argument("--projection_index_save_path", required=True)
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    dev = device_from(p, args)
    base = load_vectors(args.base_data_path)
    train_q = load_vectors(args.sampled_query_data_path)
    print(f"base: {base.shape}, train queries: {train_q.shape}")
    base_dev = prepare_vectors(base, args.dist, dev)

    if args.learn_base_nn_path:
        knn = read_knn_ibin(args.learn_base_nn_path, expected_k=args.M_sq)
    else:
        print(f"computing exact train->base kNN (k={args.M_sq}) on {dev}")
        _, knn = exact_knn(train_q, base_dev, k=args.M_sq, metric=args.dist,
                           query_batch=args.query_batch)

    cfg = BuildConfig(M_sq=args.M_sq, M_pjbp=args.M_pjbp,
                      L_pjpq=args.L_pjpq, metric=args.dist,
                      query_batch=args.query_batch,
                      search_batch=args.search_batch)
    index = build_roargraph(base_dev, train_q, knn, cfg)
    index.save(args.projection_index_save_path)
    dt = time.perf_counter() - t0
    print(f"saved projection index to {args.projection_index_save_path}")
    print(f"build wall time: {dt:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
