"""Time one of the port's hand-written kernels against other versions of its
CUDA source on one card, in turns.

    python scripts/torch_kernel_ab.py gather                        # this checkout
    python scripts/torch_kernel_ab.py gather --other OLD/mysteryann_tpu_torch/csrc/gather.cu
    python scripts/torch_kernel_ab.py gather --shapes f32_1M,ivf_i8   # name prefixes
    python scripts/torch_kernel_ab.py scan --other OLD/scan.cu [--n --queries --dim]
    python scripts/torch_kernel_ab.py select                        # K3
    python scripts/torch_kernel_ab.py select --other OLD/mysteryann_tpu_torch/csrc/select.cu
    python scripts/torch_kernel_ab.py select --shapes seed,ivf       # name prefixes
    python scripts/torch_kernel_ab.py score_select [--shapes seed,flat]  # K3f
    python scripts/torch_kernel_ab.py score_select --other OLD/mysteryann_tpu_torch/csrc/score_select.cu

K1, the row gather: every version is timed through its own Python wrapper,
so host-launched times include each design's host path. ``--other`` names
another ``csrc/gather.cu`` (for example the parent commit's, unpacked with
``git archive`` into a git-ignored directory); the ``ops/gather.py`` beside
it in that tree is loaded with it. At every shape of GATHER_SHAPES (the
shapes the port's paths give K1) each version is checked bit for bit
against ``torch.index_select`` (int32 and int64 indices), then timed over
20 rotating index sets, so a run of calls reads its rows from HBM, not the
L2: graph-timed (``chip_smoke.time_ms_graph``, 20 calls replayed from one
CUDA graph: device time, the host out), host-launched
(``chip_smoke.time_ms``, median of 7 trials of 20 calls) and host enqueue
us per call (``chip_smoke.enqueue_us``, 1,000 calls, no synchronisation),
in the order others, this, this, others reversed. ``index_select`` is
timed the same way (the library call), and for this checkout the enqueue
of ``torch.empty`` of the output alone and of the bare ctypes launch, the
two parts of the host path. One JSON line per shape; the bound counts rows
read and written once and indices read once at 3.35 TB/s.

K2, the binned scan: each ``--other`` is bound by its C entry point; checked
bit for bit against ``binned_scan_ref`` on dyadic data and timed by CUDA
events (median of 5 trials of 3), with its bound at 989 TFLOP/s (bf16).

K3, the k-selection behind ``ops/sort.topk_smallest``: at every shape of
SELECT_SHAPES (the shapes the port's paths give it) each version (this
checkout's and each ``--other``'s, through the ``ops/select.py`` beside it)
is checked bit for bit against the composite-key plain version
(``topk_smallest_ref``, in row blocks of 2 GB of input, as
``chip_smoke.k3_plain``) on Gaussian scores, then timed graph-timed
(``reps`` calls replayed from one CUDA graph) and host-launched, in the
order others, this, this, others reversed; the plain version and
``torch.topk(x, k, largest=False)`` (the library call, tie order aside)
the same way, once each; host enqueue us per call where the bound is under
a millisecond (there the host path matters). The bound counts the input
read once and k values and int64 indices written a row at 3.35 TB/s. A
version that refuses a shape (an older wide route past k = 8,192) is
reported as refusing it and not timed there.

K3f, the bf16 score product fused with the selection
(``ops/score_select.score_topk``): at every shape of SCORE_SHAPES (the seed
scan, flat bf16, a fused-build batch, one query, the T2I flat cell's shape
at a tenth of its rows) each version (this checkout's and each
``--other``'s, through the ``ops/score_select.py`` beside it) is held
against its plain version (``score_topk_ref``) under ``check_tolerance``,
then graph-timed (min of two runs, each the median of its trials) in the
order others, this, this, others reversed, beside the plain version and the fastest two-call library composite, a bf16
``torch.matmul`` then ``torch.topk`` (no single PyTorch call computes the
function), and the unfused route (the f32 tiled matmul of the bf16 values
selected by K3: what the seed scan and flat bf16 ran before K3f, and what
a call ``_plan`` refuses still runs; CUDA-event timed, since it reads the
free memory to size its tiles). At d % 8 != 0 the table is made by
``aligned_rows``, as the seed sample and ``FlatIndex`` make theirs, and
``copy_ms`` times the same call on a contiguous table, which the wrapper
copies, padded, on every call. The bound is the larger of 2·B·n·d flops
at 989 TFLOP/s (bf16) and the operands read once with k values and int64
ids written at 3.35 TB/s.

Prints the card's name and power limit first, then every build's ptxas
lines.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from chip_smoke import (BF16_FLOP_S, HBM_BYTES_S, enqueue_us,  # noqa: E402
                        index_sets, k3_bound_ms, k3_plain, k3f_bound,
                        k3f_library, random_bytes, rotating, time_ms,
                        time_ms_graph)
from mysteryann_tpu_torch.ops import gather, scan, score_select  # noqa: E402
from mysteryann_tpu_torch.ops import select  # noqa: E402
from mysteryann_tpu_torch.ops._nvcc import build_library  # noqa: E402

# (name, table shape, dtype, rows per call): the narrow rows of the graph
# paths at 1M and 4M, the smoke's odd shapes, the fused engine's byte rows
# (serving 6,528 B, build 4,608 B; the 4M build's and its serving table's),
# and the IVF index's cluster blocks at the 1M world (2,000 clusters, cap
# 800; C = 4 rows per call at 8,192 queries and nprobe 64, 64 at small
# qmax) and at the 10M world (6,324 clusters, cap 2,080)
GATHER_SHAPES = (
    ("f32_1M_x128", (1_000_000, 128), torch.float32, 65536),
    ("i32_1M_x64", (1_000_000, 64), torch.int32, 65536),
    ("bf16_10k_x96", (10_000, 96), torch.bfloat16, 65536),
    ("i8_4096_x48", (4096, 48), torch.int8, 65536),
    ("f32_4M_x128", (4_000_000, 128), torch.float32, 65536),
    ("i32_4M_x64", (4_000_000, 64), torch.int32, 65536),
    ("u8_1M_x6528", (1_000_001, 6528), torch.uint8, 32768),
    ("u8_1M_x4608", (1_000_001, 4608), torch.uint8, 32768),
    ("u8_4M_x4608", (4_000_001, 4608), torch.uint8, 32768),
    ("u8_4M_x2304", (4_000_001, 2304), torch.uint8, 32768),
    ("ivf_f32_C4", (2000, 800, 128), torch.float32, 4),
    ("ivf_f32_C64", (2000, 800, 128), torch.float32, 64),
    ("ivf_i8_C4", (2000, 800, 128), torch.int8, 4),
    ("ivf_i8_C64", (2000, 800, 128), torch.int8, 64),
    ("ivf10m_i8_C4", (6324, 2080, 128), torch.int8, 4),
    ("ivf10m_i8_C64", (6324, 2080, 128), torch.int8, 64),
)


# (name, rows, n, k, reps): the seed scan over all 500,000 sample columns of
# the 1M world at 8,192 queries and at the tile _tiled_topk cuts with the
# card empty, flat f32 over the 1M base, a train-kNN tile (8,192 queries x
# 65,536 base rows, M_sq 64), an IVF step of the grouped scan ([C·qmax,
# cap] = [8,192, 800]) and 16 steps' rows in one call, the kNN's [B, k + k]
# merge, K2's bin top-k, the IVF probe choice, and on the wide route the
# probe choice at nprobe 300 and the exactness gates' k = n = 2,000 (1M
# world, 1,024 queries) and 6,324 (10M world, 256 queries)
SELECT_SHAPES = (
    ("seed_scan_full", 8192, 500_000, 48, 3),
    ("seed_scan_tile", 8192, 161_104, 48, 5),
    ("flat_f32_full", 8192, 1_000_000, 20, 3),
    ("knn_tile", 8192, 65_536, 64, 10),
    ("ivf_step", 8192, 800, 20, 20),
    ("ivf_rows_131072", 131072, 800, 20, 20),
    ("knn_merge", 8192, 128, 64, 20),
    ("scan_bins", 8192, 4096, 20, 20),
    ("ivf_topc", 8192, 2000, 64, 20),
    ("wide_topc_300", 8192, 2000, 300, 10),
    ("wide_gate_1m", 1024, 2000, 2000, 10),
    ("wide_gate_10m", 256, 6324, 6324, 10),
    ("wide_gate_50m", 64, 14142, 14142, 5),
    ("wide_k14142", 64, 20_000, 14142, 5),
    ("wide_k8193", 256, 20_000, 8193, 5),
)

# (name, queries B, table rows n, d, k, reps): the seed scan of an
# 8,192-query batch over the 1M world's 1-in-2 sample, flat bf16 over the 1M
# base (k = 10 x oversample 2), a fused-build phase-D batch of 8,192 nodes
# seeding 16 from a 1-in-4 sample, a small batch of 256 (a CLI's, the
# build's last), one query, the seed scan at GloVe's d = 100, and the
# t2i10m-flat cell's call (8,192 queries, T2I's d = 200, k 20) over a tenth
# of its 10M rows
SCORE_SHAPES = (
    ("seed_scan", 8192, 500_000, 128, 48, 3),
    ("flat_bf16", 8192, 1_000_000, 128, 20, 3),
    ("build_batch", 8192, 250_000, 128, 16, 3),
    ("small_batch", 256, 250_000, 128, 16, 10),
    ("one_query", 1, 500_000, 128, 48, 20),
    ("seed_scan_d100", 8192, 500_000, 100, 48, 3),
    ("flat_t2i", 8192, 1_000_000, 200, 20, 3),
)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _call(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def _ptxas(log: str) -> list:
    """ptxas's lines of each kernel: its name, registers, spills and any
    wgmma serialization warning."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln
            or "wgmma" in ln]


def load_wrapper(source: str, tag: str):
    """The wrapper module of another tree's ``csrc/<kernel>.cu``: the
    ``ops/<kernel>.py`` beside it in that tree, bound to that source."""
    stem = os.path.splitext(os.path.basename(source))[0]
    wrapper = os.path.join(os.path.dirname(os.path.dirname(source)), "ops",
                           stem + ".py")
    if not os.path.exists(wrapper):
        sys.exit(f"no ops/{stem}.py beside {source}")
    spec = importlib.util.spec_from_file_location(f"_{stem}_{tag}", wrapper)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = source
    return mod


def _same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def host_parts(table: torch.Tensor, idxs: list) -> dict:
    """Enqueue us of the two parts of this checkout's host path: the
    output's ``torch.empty`` and the bare ctypes launch."""
    n_idx = idxs[0].shape[0]
    shape = (n_idx,) + tuple(table.shape[1:])
    out = torch.empty(shape, dtype=table.dtype, device=table.device)
    d = table.get_device()
    plan = gather._cached_plan(d, out.nbytes // n_idx, n_idx,
                               table.data_ptr(), out.data_ptr())[2]
    args = [gather._pack_args(table.data_ptr(), table.shape[0], i.data_ptr(),
                              0, n_idx, out.data_ptr(), gather._flag_ptrs[d],
                              _stream(), plan) for i in idxs]
    it = iter(args * 100)
    return {"empty_us": enqueue_us(lambda: torch.empty(
                shape, dtype=table.dtype, device=table.device)),
            "launch_us": enqueue_us(lambda: gather._fn(next(it)))}


def run_gather(args, dev) -> None:
    versions = {"this": gather}
    others = [f"other{i}" for i in range(len(args.other))]
    for name, path in zip(others, args.other):
        versions[name] = load_wrapper(os.path.abspath(path), name)
    for name, mod in versions.items():
        mod.build(force=True)
        print(json.dumps({"build": name, "source": mod.SOURCE,
                          "ptxas": _ptxas(mod.build_log)}), flush=True)
    order = others + ["this", "this"] + others[::-1]
    wanted = args.shapes.split(",") if args.shapes else None
    for seed, (name, shape, dt, n_idx) in enumerate(GATHER_SHAPES):
        if wanted and not any(name.startswith(w) for w in wanted):
            continue
        flat = (shape[0], shape[1] * (shape[2] if len(shape) > 2 else 1))
        table = random_bytes(flat, dev, seed, dt).view(shape)
        idxs = index_sets(table, n_idx, seed)
        for ver, mod in versions.items():
            for idx in idxs[:2]:
                for ix in (idx, idx.long()):
                    got = mod.gather_rows(table, ix)
                    want = torch.index_select(table, 0, ix)
                    torch.cuda.synchronize()
                    if not _same_bytes(got, want):
                        sys.exit(f"{ver}: differs from index_select at "
                                 f"{name} ({ix.dtype})")
            if mod.error_flag_value():
                sys.exit(f"{ver}: error flag set at {name}")
        graph = {v: [] for v in versions}
        host = {v: [] for v in versions}
        enq = {v: [] for v in versions}
        for ver in order:
            fn = rotating(versions[ver].gather_rows, table, idxs)
            graph[ver].append(time_ms_graph(fn))
            host[ver].append(time_ms(fn))
            enq[ver].append(enqueue_us(fn))
        lib = rotating(lambda t, i: torch.index_select(t, 0, i), table, idxs)
        row_bytes = table.stride(0) * table.element_size()
        bound = (2 * n_idx * row_bytes + 4 * n_idx) / HBM_BYTES_S * 1e3
        print(json.dumps({
            "kernel": "gather", "shape": name, "table": list(shape),
            "dtype": str(dt), "rows": n_idx, "row_bytes": row_bytes,
            "plan": gather.plan_for(table, n_idx)._asdict(),
            "bit_identical": True, "bound_ms": bound,
            "graph_ms": graph, "host_ms": host, "enqueue_us": enq,
            "index_select": {"graph_ms": time_ms_graph(lib),
                             "host_ms": time_ms(lib),
                             "enqueue_us": enqueue_us(lib)},
            "this_host_parts": host_parts(table, idxs),
            "share_graph": {v: bound / min(t) for v, t in graph.items()},
            "sources": dict(zip(others, args.other))}), flush=True)
        del table, idxs
        torch.cuda.empty_cache()


def _readings(fn, reps: int, enqueue: bool) -> dict:
    trials = 7 if reps >= 10 else 3
    out = {"graph_ms": time_ms_graph(fn, reps, trials),
           "host_ms": time_ms(fn, reps, trials)}
    if enqueue:
        out["enqueue_us"] = enqueue_us(fn, calls=400, chunk=40)
    return out


def run_select(args, dev) -> None:
    versions = {"this": select}
    others = [f"other{i}" for i in range(len(args.other))]
    for name, path in zip(others, args.other):
        versions[name] = load_wrapper(os.path.abspath(path), name)
    for name, mod in versions.items():
        mod.build(force=True)
        print(json.dumps({"build": name, "source": mod.SOURCE,
                          "ptxas": _ptxas(mod.build_log)}), flush=True)
    order = others + ["this", "this"] + others[::-1]
    wanted = args.shapes.split(",") if args.shapes else None
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    for name, rows, n, k, reps in SELECT_SHAPES:
        if wanted and not any(name.startswith(w) for w in wanted):
            continue
        x = torch.randn((rows, n), generator=g, device=dev)
        want = k3_plain(x, k)
        refuse = set()
        for ver, mod in versions.items():
            try:
                got = mod.topk_smallest_cuda(x, k)
            except ValueError:
                refuse.add(ver)
                continue
            torch.cuda.synchronize()
            if not (torch.equal(got[1], want[1])
                    and torch.equal(got[0].view(torch.int32),
                                    want[0].view(torch.int32))):
                sys.exit(f"{ver}: differs from the plain version at {name}")
            del got
        del want
        bound = k3_bound_ms(rows, n, k)
        enqueue = bound < 1.0
        times = {v: [] for v in versions if v not in refuse}
        for ver in order:
            if ver in refuse:
                continue
            times[ver].append(_readings(
                lambda m=versions[ver]: m.topk_smallest_cuda(x, k), reps,
                enqueue))
        plain = _readings(lambda: k3_plain(x, k), max(1, reps // 3),
                          enqueue)
        library = _readings(lambda: torch.topk(x, k, dim=-1, largest=False),
                            reps, enqueue)
        print(json.dumps({
            "kernel": "select", "shape": name, "rows": rows, "n": n, "k": k,
            "plan": select.plan_for(x, k)._asdict(), "bit_identical": True,
            "bound_ms": bound, "versions": times, "plain": plain,
            "library": library, "refuses": sorted(refuse),
            "share_graph": {v: bound / min(t["graph_ms"] for t in r)
                            for v, r in times.items()},
            "sources": dict(zip(others, args.other))}), flush=True)
        del x
        torch.cuda.empty_cache()


def run_score_select(args, dev) -> None:
    versions = {"this": score_select}
    others = [f"other{i}" for i in range(len(args.other))]
    for name, path in zip(others, args.other):
        versions[name] = load_wrapper(os.path.abspath(path), name)
    for name, mod in versions.items():
        mod.build(force=True)
        print(json.dumps({"build": name, "source": mod.SOURCE,
                          "ptxas": _ptxas(mod.build_log)}), flush=True)
    order = others + ["this", "this"] + others[::-1]
    wanted = args.shapes.split(",") if args.shapes else None
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    for name, B, n, d, k, reps in SCORE_SHAPES:
        if wanted and not any(name.startswith(w) for w in wanted):
            continue
        q = torch.randn((B, d), generator=g, device=dev).to(torch.bfloat16)
        t_flat = torch.randn((n, d), generator=g, device=dev).to(
            torch.bfloat16)
        t = score_select.aligned_rows(t_flat)
        if t.data_ptr() == t_flat.data_ptr():
            t_flat = None
        want = score_select.score_topk_ref(q, t, k, "ip")
        tol = {}
        for ver, mod in versions.items():
            got = mod.score_topk(q, t, k, "ip")
            tol[ver] = score_select.check_tolerance(q, t, "ip", got, want)
            if not tol[ver]["ok"]:
                sys.exit(f"{ver}: K3f outside its tolerance at {name}: "
                         f"{tol[ver]}")
            del got
        del want
        trials = 7 if reps >= 10 else 3
        times = {v: [] for v in versions}
        for ver in order:
            times[ver].append(min(time_ms_graph(
                lambda m=versions[ver]: m.score_topk(q, t, k, "ip"), reps,
                trials) for _ in range(2)))
        plain = time_ms(lambda: score_select.score_topk_ref(q, t, k, "ip"),
                        1, 3)
        library = [time_ms_graph(lambda: k3f_library(q, t, k), reps,
                                 trials) for _ in range(2)]
        unfused = time_ms(lambda: score_select._tiled(
            q, t, k, score_select.Metric.IP, None, None, None,
            score_select.topk_smallest), reps, trials)
        copy = None
        if t_flat is not None:
            copy = min(time_ms_graph(
                lambda: score_select.score_topk(q, t_flat, k, "ip"), reps,
                trials) for _ in range(2))
        bound, by = k3f_bound(B, n, d, k)
        ms = {v: min(r) for v, r in times.items()}
        print(json.dumps({
            "kernel": "score_select", "shape": name, "B": B, "n": n, "d": d,
            "k": k, "plan": {v: m.plan_for(q, t, k)._asdict()
                             for v, m in versions.items()},
            "tolerance": tol, "graph_ms": times, "ms": ms,
            "plain_ms": plain, "library_graph_ms": library,
            "library_ms": min(library), "unfused_ms": unfused,
            "copy_ms": copy, "bound_ms": bound, "bound_by": by,
            "share": {v: bound / m for v, m in ms.items()},
            "sources": dict(zip(others, args.other))}), flush=True)
        del q, t, t_flat
        torch.cuda.empty_cache()


def run_scan(args, dev) -> None:
    argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 4 \
        + [ctypes.c_void_p] * 3
    sources = {"this": scan.SOURCE}
    others = [f"other{i}" for i in range(len(args.other))]
    sources.update(zip(others, (os.path.abspath(p) for p in args.other)))
    fns = {}
    for ver, source in sources.items():
        lib, _, log = build_library(source, force=True)
        fn = lib.msann_binned_scan
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[ver] = fn
        print(json.dumps({"build": ver, "ptxas": _ptxas(log)}), flush=True)
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

    for ver, fn in fns.items():
        out_d.zero_()
        launch(fn)
        torch.cuda.synchronize()
        if not (torch.equal(out_d, want_d) and torch.equal(out_j, want_j)):
            sys.exit(f"{ver}: differs from the plain version")
    times = {ver: [] for ver in fns}
    for ver in others + ["this", "this"] + others[::-1]:
        times[ver].append(time_ms(lambda: launch(fns[ver]), 3, 5))
    bound = 2.0 * args.queries * args.n * args.dim / BF16_FLOP_S * 1e3
    print(json.dumps({
        "kernel": "scan", "shape": [args.queries, args.n, args.dim],
        "bound_ms": bound, "bit_identical": True, "ms": times,
        "share": {v: bound / min(t) for v, t in times.items()},
        "sources": dict(zip(others, args.other))}), flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("kernel", choices=("gather", "scan", "select",
                                      "score_select"))
    p.add_argument("--other", action="append", default=[],
                   help="another source of the same kernel (repeatable)")
    p.add_argument("--shapes", default="",
                   help="gather, select, score_select: comma-separated "
                        "prefixes of shape names")
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
    dev = torch.device("cuda", 0)
    {"gather": run_gather, "scan": run_scan, "select": run_select,
     "score_select": run_score_select}[args.kernel](args, dev)


if __name__ == "__main__":
    main()
