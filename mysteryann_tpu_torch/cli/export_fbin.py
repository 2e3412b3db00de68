"""Concatenate .npy embedding shards into one .fbin (port of
``mysteryann_tpu/cli/export_fbin.py``).

Counterpart of reference export_fbin_from_npy.py:1-42 generalized to any
shard list, streaming through a bounded buffer. Also pools per-video frame
embeddings first when `--pool_videos` is given (reference
prepare_for_clip_webvid.py:80-110 clip4clip math: normalize frames, mean,
renormalize). Host-only: no device.

    python -m mysteryann_tpu_torch.cli.export_fbin --npy a.npy b.npy --out x.fbin
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from mysteryann_tpu_torch.io.datasets import (export_fbin_from_npy,
                                              pool_frame_embeddings)
from mysteryann_tpu_torch.io.formats import write_fbin


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--npy", nargs="+", required=True,
                   help=".npy shard paths, concatenated in order")
    p.add_argument("--out", required=True, help="output .fbin path")
    p.add_argument("--normalize", action="store_true",
                   help="L2-normalize rows while exporting")
    p.add_argument("--pool_videos", action="store_true",
                   help="treat each .npy as ONE video's frame embeddings "
                        "and emit one pooled row per file")
    args = p.parse_args(argv)

    if args.pool_videos:
        rows = [pool_frame_embeddings(np.load(f)) for f in args.npy]
        arr = np.stack(rows).astype(np.float32)
        write_fbin(args.out, arr)
        npts, dim = arr.shape
    else:
        npts, dim = export_fbin_from_npy(args.npy, args.out,
                                         normalize=args.normalize)
    print(f"wrote [{npts} x {dim}] to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
