"""Whole builds with the bounded-memory paths forced, against the default
build, on one device.

`build_roargraph` plans its memory from the device (`graph/roargraph.
_build_memory_plan`); on a card with room it takes the single fold, so the
slab fold, the host reverse aggregation, the host projection and the
slabbed tail never run there by themselves below ~11M x 128 rows. This
script builds one world twice with the engine pinned — once as planned,
once with the plan made as for a device of `--forced_memory` bytes (the
rule's `device_memory` is patched for that build; default 1: every
bounded-memory path with 1,024-row slabs) — and compares the two graphs
bit for bit. The world is bench.py's (seed 7) at `--n_base` rows.

Run on the card:  python scripts/torch_large_paths_check.py
At the slab height the rule picks for a 16 GB card at 4M rows (800,000):
  python scripts/torch_large_paths_check.py --n_base 4000000 \
      --n_train 400000 --forced_memory 16000000000
On the CPU (tiny): --device cpu --n_base 2000 --n_train 600 --dim 32
Emits one JSON line; exits 1 when the graphs differ.
"""

import argparse
import contextlib
import json
import os
import sys
import time
from unittest import mock

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from mysteryann_tpu_torch.cli.common import add_device_flag, device_from
from _torch_benchrun import card_info, log, peak_gb, sync

WORLD = dict(n_concepts=20_000, intrinsic_dim=48, noise=0.85)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_base", type=int, default=1_000_000)
    ap.add_argument("--n_train", type=int, default=200_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--engine", default="fused", choices=("fused", "classic"))
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--forced_memory", type=int, default=1,
                    help="plan the second build as for a device of this "
                         "many bytes")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_from(ap, args)

    from mysteryann_tpu_torch.graph import build_roargraph
    from mysteryann_tpu_torch.graph import roargraph as rg
    from mysteryann_tpu_torch.io import make_cross_modal
    from mysteryann_tpu_torch.ops import exact_knn
    from mysteryann_tpu_torch.ops.distances import prepare_vectors
    from mysteryann_tpu_torch.utils.params import BuildConfig

    n, dim = args.n_base, args.dim
    base, train_q = make_cross_modal(n, args.n_train, dim, metric="ip",
                                     seed=7, **WORLD)
    base_dev = prepare_vectors(base, "ip", dev)
    m_sq = min(64, n - 1)
    knn = exact_knn(train_q, base_dev, k=m_sq, metric="ip", query_batch=8192,
                    base_tile=131072)[1].astype(np.int32)
    cfg = BuildConfig(M_sq=m_sq, M_pjbp=32, L_pjpq=128, metric="ip",
                      query_batch=8192, search_batch=8192,
                      connectivity_passes=args.passes, connectivity_expand=4,
                      connectivity_bits=4, connectivity_engine=args.engine)

    runs = {}
    for name, mem in (("planned", None), ("forced", args.forced_memory)):
        def forced(m=mem):
            """The memory rule reading ``m`` bytes instead of the device."""
            if m is None:
                return contextlib.nullcontext()
            return mock.patch.object(rg, "device_memory", lambda device: m)

        with forced():
            plan = rg._build_memory_plan(cfg, n, dim, rg.device_memory(dev))
        log(f"== {name}: engine {plan.engine}, {plan.fold} fold ==")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        sync(dev)
        t0 = time.time()
        with forced():
            index = build_roargraph(base_dev, train_q, knn, cfg, verbose=True)
        sync(dev)
        runs[name] = {"fold": plan.fold, "large": plan.large,
                      "slab_rows": plan.slab_rows if plan.large else None,
                      "build_secs": round(time.time() - t0, 1),
                      "peak_gb": peak_gb(dev),
                      "neighbors": index.graph.neighbors,
                      "ep": index.graph.ep}
    same = (runs["planned"]["ep"] == runs["forced"]["ep"]
            and np.array_equal(runs["planned"]["neighbors"],
                               runs["forced"]["neighbors"]))
    out = {"scale": n, "engine": args.engine, "passes": args.passes,
           "forced_memory": args.forced_memory, "bit_identical": bool(same),
           **{k: {f: v for f, v in r.items() if f not in ("neighbors", "ep")}
              for k, r in runs.items()}, **card_info(dev)}
    print(json.dumps(out))
    if not same:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
