"""Read the numbers that decide ``correct`` over many seeds in one process:
the run as the benchmark makes it, with the program as it stands, with one
of its own settings changed, or with the reference in its place.

    python3 benchmark/tools/control.py --workload t2i10m-flat.b8192 \
        --mode program --seeds 21 22 23 --seconds 5 \
        [--set serve.precision=int8] [--out chiprun_out/control.jsonl]

Modes:

- ``program``: the cell's engine, its configuration changed by each
  ``--set key.key=value`` (a value is read as JSON where it parses, else as
  a string): the sound runs with no ``--set``, the program's own
  lower-precision path as the control with one (``serve.precision=int8``
  for the flat scan);
- ``reference_tf32``: the reference put in the program's place, computed
  one precision below the float32 with TF32 off that the configurations
  state (``reference/tf32_control.py``).

Every seed is a whole run (world, engine, window, comparison) in this one
process. The benchmark's own runs never run a control. Runs on the card
only.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness.runner import run_cell  # noqa: E402
from benchmark.harness.spec import Spec, load_module  # noqa: E402


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def apply_sets(config: dict, sets) -> dict:
    """A copy of ``config`` with each ``key.key=value`` of ``sets`` set."""
    config = copy.deepcopy(config)
    for item in sets:
        path, _, raw = item.partition("=")
        keys = path.split(".")
        try:
            value = json.loads(raw)
        except ValueError:
            value = raw
        node = config
        for key in keys[:-1]:
            node = node[key]
        if keys[-1] not in node:
            raise KeyError(f"{path!r} is not in the configuration")
        node[keys[-1]] = value
    return config


def control_cell(root: str, workload: str, mode: str, sets=()):
    cell = Spec(root).cell(workload)
    if mode == "reference_tf32":
        cell.engine = load_module(os.path.join(
            root, "benchmark", "reference", "tf32_control.py"))
    elif mode != "program":
        raise ValueError(f"unknown mode {mode!r}")
    cell.config = apply_sets(cell.config, sets)
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True,
                    choices=("program", "reference_tf32"))
    ap.add_argument("--set", dest="sets", action="append", default=[])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("the control runs on the card")
        return 2
    for seed in args.seeds:
        cell = control_cell(ROOT, args.workload, args.mode, args.sets)
        result, numbers = run_cell(ROOT, args.workload, seed, args.seconds,
                                   False, torch.device("cuda", 0),
                                   time.perf_counter(), log=log, cell=cell)
        rec = {"workload": args.workload, "mode": args.mode,
               "sets": args.sets, "seed": seed,
               "correct": result["correct"], "checks": result["checks"],
               "attempted": result["attempted"],
               "metrics": result["metrics"]}
        print(json.dumps(rec), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
