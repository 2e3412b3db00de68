"""Time one of the port's hand-written kernels against other versions of its
CUDA source on one card, in turns.

    python scripts/torch_kernel_ab.py gather                        # this checkout
    python scripts/torch_kernel_ab.py gather --other OLD/gather.cu  # A/B
    python scripts/torch_kernel_ab.py scan --other OLD/scan.cu [--n --queries --dim]

Builds the kernel's source of this checkout (``csrc/gather.cu`` for K1, the
row gather; ``csrc/scan.cu`` for K2, the binned scan) and, with each
``--other``, another source with the same C entry point (for example the
parent commit's, unpacked with ``git archive`` into a git-ignored
directory). At every shape it checks each version bit for bit against the
plain version (K1: ``torch.index_select`` on random rows; K2:
``binned_scan_ref`` on dyadic data), then times them by CUDA events
(``chip_smoke.time_ms``; K1 median of 7 trials of 20 calls, K2 of 5 trials
of 3) in the order others, this, this, others reversed, and prints the card,
every build's ptxas lines and one JSON line per shape: each version's times,
the library call's (K1 ``index_select``; K2 none), the bound (K1: rows read
and written once and indices read once at 3.35 TB/s; K2: its bf16 products
at 989 TFLOP/s) and each version's best share of it.

K1's shapes are the IVF index's cluster blocks at the 1M x 128 world (2,000
clusters, cap 800; C = 4 rows per call at 8,192 queries and nprobe 64, 64
at small qmax), then the narrow rows of the graph paths. K2's is the flat
path's (8,192 queries x 1M x 128 by default).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from chip_smoke import BF16_FLOP_S, HBM_BYTES_S, time_ms  # noqa: E402
from mysteryann_tpu_torch.ops import gather, scan  # noqa: E402
from mysteryann_tpu_torch.ops._nvcc import build_library  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int64
GATHER_SHAPES = (
    ("ivf_f32_C4", (2000, 800, 128), torch.float32, 4),
    ("ivf_f32_C64", (2000, 800, 128), torch.float32, 64),
    ("ivf_i8_C4", (2000, 800, 128), torch.int8, 4),
    ("ivf_i8_C64", (2000, 800, 128), torch.int8, 64),
    ("f32_1M_x128", (1_000_000, 128), torch.float32, 65536),
    ("u8_1M_x6528", (1_000_001, 6528), torch.uint8, 32768),
)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _call(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def gather_cases(args, dev):
    """K1 at GATHER_SHAPES, one case per shape: (name, fields, launch(fn),
    clear(), agrees(), library())."""
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    for name, shape, dt, n_idx in GATHER_SHAPES:
        table = torch.randint(-100, 100, shape, generator=g, device=dev,
                              dtype=torch.int32).to(dt)
        idx = torch.randint(0, shape[0], (n_idx,), generator=g, device=dev,
                            dtype=torch.int32)
        want = torch.index_select(table, 0, idx.long())
        out = torch.empty_like(want)
        row_bytes = table[0].numel() * table.element_size()

        def launch(fn):
            _call(fn, table.data_ptr(), table.shape[0], row_bytes,
                  idx.data_ptr(), 0, n_idx, out.data_ptr(), flag.data_ptr(),
                  _stream())

        def agrees():
            return torch.equal(out, want) and not int(flag.item())

        fields = {"table": list(shape), "dtype": str(dt), "rows": n_idx,
                  "row_bytes": row_bytes,
                  "bound_ms": (2 * n_idx * row_bytes + 4 * n_idx)
                  / HBM_BYTES_S * 1e3}
        yield (name, fields, launch, lambda: out.zero_(), agrees,
               lambda: torch.index_select(table, 0, idx))
        del table, idx, want, out
        torch.cuda.empty_cache()


def scan_cases(args, dev):
    """K2 at one (queries, n, dim) shape on dyadic data."""
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    q = (torch.randint(-8, 9, (args.queries, args.dim), generator=g,
                       device=dev) / 8).to(torch.bfloat16)
    tbl = scan.make_scan_table(
        torch.randint(-8, 9, (args.n, args.dim), generator=g, device=dev) / 8)
    want_d, want_j = scan.binned_scan_ref(q, tbl, args.n)
    out_d, out_j = torch.empty_like(want_d), torch.empty_like(want_j)

    def launch(fn):
        _call(fn, q.data_ptr(), tbl.data_ptr(), q.shape[0],
              tbl.shape[0] // scan.C_BLK, q.shape[1], args.n,
              out_d.data_ptr(), out_j.data_ptr(), _stream())

    def agrees():
        return torch.equal(out_d, want_d) and torch.equal(out_j, want_j)

    flops = 2.0 * args.queries * args.n * args.dim
    yield ("scan", {"table": [args.queries, args.n, args.dim],
                    "bound_ms": flops / BF16_FLOP_S * 1e3},
           launch, lambda: out_d.zero_(), agrees, None)


KERNELS = {
    "gather": dict(source=gather.SOURCE, entry="msann_gather_rows",
                   argtypes=[_P, _I, _I, _P, _I, _I, _P, _P, _P],
                   cases=gather_cases, reps=20, trials=7),
    "scan": dict(source=scan.SOURCE, entry="msann_binned_scan",
                 argtypes=[_P, _P, _I, _I, _I, _I, _P, _P, _P],
                 cases=scan_cases, reps=3, trials=5),
}


def bind(kernel: dict, source: str):
    lib, _, log = build_library(source, force=True)
    fn = getattr(lib, kernel["entry"])
    fn.argtypes = kernel["argtypes"]
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    return fn, ptxas


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("kernel", choices=sorted(KERNELS))
    p.add_argument("--other", action="append", default=[],
                   help="another source of the same kernel (repeatable)")
    p.add_argument("--n", type=int, default=1_000_000, help="scan: rows")
    p.add_argument("--queries", type=int, default=8192, help="scan: queries")
    p.add_argument("--dim", type=int, default=128, help="scan: dimension")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    kernel = KERNELS[args.kernel]
    versions = {"this": bind(kernel, kernel["source"])}
    others = [f"other{i}" for i in range(len(args.other))]
    for name, path in zip(others, args.other):
        versions[name] = bind(kernel, os.path.abspath(path))
    for name, (_, ptxas) in versions.items():
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)

    reps, trials = kernel["reps"], kernel["trials"]
    order = others + ["this", "this"] + others[::-1]
    dev = torch.device("cuda", 0)
    for name, fields, launch, clear, agrees, library in kernel["cases"](
            args, dev):
        for ver, (fn, _) in versions.items():
            clear()
            launch(fn)
            torch.cuda.synchronize()
            if not agrees():
                sys.exit(f"{ver}: differs from the plain version at {name}")
        times = {ver: [] for ver in versions}
        for ver in order:
            fn = versions[ver][0]
            times[ver].append(time_ms(lambda: launch(fn), reps, trials))
        bound = fields["bound_ms"]
        print(json.dumps({
            "kernel": args.kernel, "shape": name, **fields,
            "bit_identical": True, "ms": times,
            "library_ms": (time_ms(library, reps, trials) if library
                           else None),
            "share": {v: bound / min(t) for v, t in times.items()},
            "sources": dict(zip(others, args.other))}), flush=True)


if __name__ == "__main__":
    main()
