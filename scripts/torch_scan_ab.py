"""Time the port's binned scan kernel (K2) against another version of its
CUDA source on one card, in turns, at the flat path's shape.

    python scripts/torch_scan_ab.py                      # this checkout only
    python scripts/torch_scan_ab.py --other OLD/scan.cu  # A/B on one card

Builds ``mysteryann_tpu_torch/csrc/scan.cu`` of this checkout and, with
each ``--other``, another ``scan.cu`` with the same C entry point
(``msann_binned_scan``; for example the parent commit's, unpacked with
``git archive`` into a git-ignored directory). Checks each bit for bit
against ``binned_scan_ref`` on dyadic data, then times them by CUDA events
(median of 5 trials of 3 calls) in the order others, this, this, others
reversed, and prints the card, every build's ptxas lines and one JSON line
of times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from mysteryann_tpu_torch.ops import scan  # noqa: E402
from mysteryann_tpu_torch.ops._nvcc import build_library  # noqa: E402


def bind(source: str):
    lib, _, log = build_library(source, force=True)
    fn = lib.msann_binned_scan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    return fn, ptxas


def launch(fn, q, tbl, n, out_d, out_j):
    rc = fn(q.data_ptr(), tbl.data_ptr(), q.shape[0],
            tbl.shape[0] // scan.C_BLK, q.shape[1], n, out_d.data_ptr(),
            out_j.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def time_ms(fn, reps: int = 3, trials: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return float(np.median(out))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", action="append", default=[],
                   help="another scan.cu to compare (repeatable)")
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--queries", type=int, default=8192)
    p.add_argument("--dim", type=int, default=128)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    versions = {"this": bind(scan.SOURCE)}
    others = [f"other{i}" for i in range(len(args.other))]
    for name, path in zip(others, args.other):
        versions[name] = bind(os.path.abspath(path))
    for name, (_, ptxas) in versions.items():
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    q = (torch.randint(-8, 9, (args.queries, args.dim), generator=g,
                       device=dev) / 8).to(torch.bfloat16)
    tbl = scan.make_scan_table(
        torch.randint(-8, 9, (args.n, args.dim), generator=g, device=dev) / 8)
    want_d, want_j = scan.binned_scan_ref(q, tbl, args.n)
    out_d = torch.empty_like(want_d)
    out_j = torch.empty_like(want_j)
    for name, (fn, _) in versions.items():
        out_d.fill_(0)
        launch(fn, q, tbl, args.n, out_d, out_j)
        torch.cuda.synchronize()
        if not (torch.equal(out_d, want_d) and torch.equal(out_j, want_j)):
            sys.exit(f"{name}: differs from binned_scan_ref")
    del want_d, want_j

    order = others + ["this", "this"] + others[::-1]
    times = {name: [] for name in versions}
    for name in order:
        fn = versions[name][0]
        times[name].append(time_ms(
            lambda: launch(fn, q, tbl, args.n, out_d, out_j)))
    flops = 2.0 * args.queries * args.n * args.dim
    print(json.dumps({"shape": [args.queries, args.n, args.dim],
                      "sources": dict(zip(others, args.other)),
                      "bit_identical": True, "ms": times,
                      "tflop_s": {k: flops / min(v) / 1e9
                                  for k, v in times.items()}}), flush=True)


if __name__ == "__main__":
    main()
