"""IVF index build CLI (port of ``mysteryann_tpu/cli/build_ivf.py``).

No reference counterpart (the reference builds graphs only). Builds k-means
cluster blocks from an .fbin corpus and persists the index
(`IVFIndex.save`, the JAX package's npz container); serve it with
``search_ivf``.

    python -m mysteryann_tpu_torch.cli.build_ivf --base_data_path B.fbin \
        --index_save_path ivf.npz --store int8
"""

from __future__ import annotations

import argparse
import sys
import time

from mysteryann_tpu_torch.cli.common import (add_device_flag, device_from,
                                             load_vectors)
from mysteryann_tpu_torch.ivf import IVFIndex


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_type", default="float", choices=["float"])
    p.add_argument("--dist", default="ip", choices=["l2", "ip", "cosine"])
    p.add_argument("--base_data_path", required=True)
    p.add_argument("--index_save_path", required=True,
                   help="output .npz (IVFIndex.save container)")
    p.add_argument("--n_clusters", type=int, default=0,
                   help="0 = auto (2*sqrt(N))")
    p.add_argument("--cap_factor", type=float, default=1.6)
    p.add_argument("--kmeans_iters", type=int, default=10)
    p.add_argument("--store", default="f32", choices=["f32", "int8"],
                   help="int8 = global-scale quantized blocks (IP/cosine)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_threads", type=int, default=0,
                   help="accepted for reference compatibility; unused")
    add_device_flag(p)
    args = p.parse_args(argv)
    dev = device_from(p, args)

    base = load_vectors(args.base_data_path)
    t0 = time.time()
    idx = IVFIndex(base, metric=args.dist, n_clusters=args.n_clusters,
                   cap_factor=args.cap_factor,
                   kmeans_iters=args.kmeans_iters, seed=args.seed,
                   store=args.store, verbose=True, device=dev)
    print(f"built {idx.n_clusters} clusters (cap {idx.cap}, "
          f"store {args.store}) in {time.time() - t0:.1f}s",
          file=sys.stderr, flush=True)
    idx.save(args.index_save_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
