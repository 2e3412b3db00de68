"""Plumbing shared by the benchmark scripts beside it (``torch_*.py``):
the card's identity for the JSON line, the timed-window fence, the row
protocol and the result cache switch. Not part of the library: the
scripts put this directory on ``sys.path`` and import it by name."""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
from typing import Callable, Optional

import torch

from mysteryann_tpu_torch.utils.cache import npz_cached


def log(*a) -> None:
    """Progress goes to stderr: stdout carries the one JSON line."""
    print(*a, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    """Close a timed window: wait for the card (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card_info(device: torch.device) -> dict:
    """``{"device": name, "power_limit": "700.00 W"}`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them for a
    CUDA device (power_limit None when nvidia-smi is not there);
    ``{"device": "cpu", "power_limit": None}`` on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    info = {"device": torch.cuda.get_device_name(device), "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            name, _, limit = out.stdout.strip().splitlines()[0].partition(",")
            info = {"device": name.strip(), "power_limit": limit.strip()}
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def peak_gb(device: torch.device) -> Optional[float]:
    """Peak allocated device memory since the last reset, in GB."""
    if torch.device(device).type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 1e9, 2)


def med3(bench_fn: Callable[..., dict]) -> dict:
    """Row protocol of the benchmark scripts: two trials discarded (the first with
    its own warm-up), then the median QPS of three; the returned row is
    the last trial's with ``qps`` / ``qps_min`` / ``qps_max`` set. A
    protocol for these one-off sweeps only: a benchmark's end-to-end rate
    is taken over its whole window, not from a median of trials."""
    for t in range(2):
        bench_fn(warmup=1 if t == 0 else 0)
    trials = [bench_fn(warmup=0) for _ in range(3)]
    qpss = sorted(t["qps"] for t in trials)
    r = trials[-1]
    r["qps"], r["qps_min"], r["qps_max"] = qpss[1], qpss[0], qpss[2]
    return r


def med3_row(bench_fn: Callable[..., dict], gt_i, gt_d, k: int = 10,
             metric: str = "ip", **fields) -> dict:
    """One sweep row by `med3`: ``fields`` first, then QPS (median, min,
    max), recall@k and rderr against the ground truth, and hops."""
    from mysteryann_tpu_torch.utils.metrics import compute_recall, compute_rderr
    r = med3(bench_fn)
    return {**fields, "qps": round(r["qps"], 1),
            "qps_min": round(r["qps_min"], 1),
            "qps_max": round(r["qps_max"], 1),
            "recall": round(compute_recall(r["ids"], gt_i, k), 4),
            "rderr": round(compute_rderr(r["dists"], gt_d, k, metric), 6),
            "avg_hops": round(r["avg_hops"], 1)}


def cached(cache_dir: Optional[str], name: str, fn):
    """`npz_cached` under ``cache_dir``; with no directory, just ``fn()``
    (a run on a machine that is thrown away gains nothing from writing
    gigabytes to its disk)."""
    if not cache_dir:
        return [a for a in fn()]
    return npz_cached(cache_dir, name, fn)


def default_cache_dir(script_file: str) -> str:
    """``.bench_cache/`` at the root of the checkout a script lives in."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(script_file))), ".bench_cache")


def load_script(path: str):
    """Import a benchmark script by path (they are not a package)."""
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
