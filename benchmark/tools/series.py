"""Run one cell several times, each run a process of its own, and report the
spread of each metric between runs.

    python3 benchmark/tools/series.py --workload t2i10m-flat.b8192 \
        --seeds 11 12 13 14 15 16 --sets 2 --seconds 30 [--trace 1] \
        [--out chiprun_out/flat.jsonl]

Each set runs every seed once, in order; the sets use the same seeds. Each
run's record (seed, set, exit code, wall seconds, its result line and the
end of its standard error) is appended to ``--out`` as one JSON line. The
summary gives, for each metric and set, the median and the spread: the
distance between the first and third quartiles (``statistics.quantiles``,
n=4) as a share of the median. Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def spread(values):
    """(median, IQR / median) of a list of numbers."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=1300)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    log(f"card: {card()}")
    records = []
    for s in range(args.sets):
        for seed in args.seeds:
            cmd = [sys.executable, "benchmark/run.py", "--workload",
                   args.workload, "--seed", str(seed), "--seconds",
                   str(args.seconds), "--trace", str(args.trace)]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                               text=True, timeout=args.timeout)
            lines = p.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if lines else None
            except ValueError:
                result = None
            rec = {"workload": args.workload, "seed": seed, "set": s,
                   "trace": args.trace, "rc": p.returncode,
                   "wall_s": time.perf_counter() - t0, "result": result,
                   "stderr_tail": p.stderr[-3000:]}
            records.append(rec)
            short = {m: v["value"] for m, v in
                     (result or {}).get("metrics", {}).items()}
            log(json.dumps({"seed": seed, "set": s, "rc": p.returncode,
                            "wall_s": round(rec["wall_s"], 1),
                            "correct": (result or {}).get("correct"),
                            "metrics": short,
                            "checks": (result or {}).get("checks")}))
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                            exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    summary = {}
    names = sorted({m for r in records if r["result"]
                    for m in r["result"]["metrics"]})
    for m in names:
        per_set = []
        for s in range(args.sets):
            vals = [r["result"]["metrics"][m]["value"] for r in records
                    if r["set"] == s and r["result"]
                    and m in r["result"]["metrics"]]
            if vals:
                med, sp = spread(vals)
                per_set.append({"median": med, "spread": sp, "n": len(vals)})
        summary[m] = per_set
    print(json.dumps({"workload": args.workload, "card": card(),
                      "summary": summary}))
    return 0 if all(r["rc"] == 0 and r["result"] and r["result"]["correct"]
                    for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
