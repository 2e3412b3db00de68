"""Fetch and assemble a registry dataset (port of
``mysteryann_tpu/cli/prepare_data.py``).

Counterpart of reference prepare_data.sh:1-67: same three datasets, same
partial-download byte math for T2I, same LAION npy→fbin export, plus
`--list` to inspect the registry and graceful air-gap behaviour (prints the
outstanding URLs so files can be staged manually). Host-only: no device.

    python -m mysteryann_tpu_torch.cli.prepare_data --list
"""

from __future__ import annotations

import argparse
import sys

from mysteryann_tpu_torch.io.datasets import REGISTRY, prepare


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset", nargs="?", default="",
                   help=f"one of {sorted(REGISTRY)}")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--list", action="store_true",
                   help="print the dataset registry and exit")
    args = p.parse_args(argv)

    if args.list or not args.dataset:
        for name, spec in REGISTRY.items():
            print(f"{name}: dim={spec.dim} metric={spec.metric} "
                  f"n_base={spec.n_base:,}")
            print(f"  {spec.notes}")
            for r in spec.remotes:
                rng = r.byte_range()
                print(f"  - {r.filename} <- {r.url}"
                      + (f" (first {rng} bytes)" if rng else ""))
        return 0

    try:
        spec = prepare(args.dataset, args.data_dir)
    except (ValueError, RuntimeError) as e:
        print(str(e), file=sys.stderr)
        return 1
    print(f"{spec.name} ready under {args.data_dir}/{spec.name}/ "
          f"(dim={spec.dim}, metric={spec.metric})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
