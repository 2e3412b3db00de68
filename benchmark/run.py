"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Progress goes to standard error, ending with one line per number that
decides ``correct`` beside its limit; the last line of standard output is
the result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.

Exits 2 without a result when there is no CUDA card, or fewer than the cell
asks for; 3 when a JAX module was loaded, or the program was loaded from
elsewhere than this checkout. Every cache of the program stays
inside the checkout: the port builds its kernels into
``mysteryann_tpu_torch/build/``, and Triton's cache is set to
``benchmark/.cache/triton``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = "mysteryann_tpu_torch"
CACHE = os.path.join(ROOT, "benchmark", ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import guard
    from benchmark.harness.spec import Spec

    cell = Spec(ROOT).cell(args.workload)
    why = guard.device_problem(int(cell.workload["chips"]))
    if why:
        log(f"no run: {why}")
        return 2

    import torch

    from benchmark.harness.runner import run_cell

    result, numbers = run_cell(ROOT, args.workload, args.seed, args.seconds,
                               bool(args.trace), torch.device("cuda", 0),
                               T_START, log=log, cell=cell)
    found = guard.forbidden_modules()
    if found:
        log(f"no result: JAX modules were loaded: {', '.join(found)}")
        return 3
    found = guard.outside(ROOT, PROGRAM)
    if found:
        log(f"no result: {', '.join(found)} loaded from outside {ROOT}")
        return 3
    for name, v in numbers.items():
        log(f"check {name} {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['ok'] else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
