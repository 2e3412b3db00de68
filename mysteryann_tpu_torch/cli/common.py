"""Shared CLI plumbing (port of ``mysteryann_tpu/cli/common.py``).

Flag vocabulary mirrors the reference programs
(reference tests/test_build_roargraph.cpp:34-68,
tests/test_search_roargraph.cpp:70-120) so shell scripts written for the
reference port with a rename. ``--num_threads`` is accepted for
compatibility and unused: device parallelism comes from batching, not host
threads. The CLIs run on the first CUDA device (``CUDA_VISIBLE_DEVICES``
picks the card) and exit with a message when there is none; ``--device
cpu`` runs them on the CPU, as ``JAX_PLATFORMS=cpu`` does the JAX CLIs.

Run one as ``python -m mysteryann_tpu_torch.cli.<name> ...``.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from mysteryann_tpu_torch.io import read_fbin


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; "
                        "'cpu' runs on the CPU)")


def device_from(p: argparse.ArgumentParser, args) -> torch.device:
    """The ``--device`` of the parsed ``args``; exits through ``p.error``
    when it names the card and there is none."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device: pass --device cpu to run on the CPU")
    return dev


def add_common_build_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data_type", default="float",
                   choices=["float"], help="vector dtype (fbin payload)")
    p.add_argument("--dist", default="ip", choices=["l2", "ip", "cosine"])
    p.add_argument("--base_data_path", required=True)
    p.add_argument("--sampled_query_data_path", required=True)
    p.add_argument("--learn_base_nn_path", required=False, default="",
                   help="precomputed train->base kNN .ibin; computed "
                        "in-framework when omitted")
    p.add_argument("--M_sq", type=int, default=100)
    p.add_argument("--M_pjbp", type=int, default=35)
    p.add_argument("--L_pjpq", type=int, default=500)
    p.add_argument("--num_threads", type=int, default=0,
                   help="accepted for reference compatibility; unused")
    p.add_argument("--query_batch", type=int, default=4096)
    p.add_argument("--search_batch", type=int, default=1024)
    add_device_flag(p)


def add_common_search_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data_type", default="float", choices=["float"])
    p.add_argument("--dist", default="", help="override metric (else sidecar)")
    p.add_argument("--base_data_path", required=True)
    p.add_argument("--query_path", required=True)
    p.add_argument("--gt_path", required=True)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--L_pq", type=int, nargs="+",
                   default=[10, 20, 30, 40, 50, 60, 80, 100, 150, 200, 300,
                            400, 500, 750, 1000, 1500, 2000])
    p.add_argument("--num_threads", type=int, default=0,
                   help="accepted for reference compatibility; unused")
    p.add_argument("--query_batch", type=int, default=1024)
    p.add_argument("--csv_path", default="", help="append result rows as CSV")
    add_device_flag(p)


def load_vectors(path: str) -> np.ndarray:
    return np.asarray(read_fbin(path), np.float32)


def result_header() -> str:
    return (f"{'L_pq':>6} {'QPS':>12} {'avg_cmps':>10} {'latency_ms':>11} "
            f"{'recall':>8} {'rderr':>10} {'avg_hops':>9}")


def result_row(r: dict) -> str:
    return (f"{r['L_pq']:>6} {r['qps']:>12.1f} {r['avg_cmps']:>10.1f} "
            f"{r['mean_latency_ms']:>11.3f} {r['recall']:>8.4f} "
            f"{r.get('rderr', float('nan')):>10.6f} {r['avg_hops']:>9.1f}")


def write_csv(path: str, rows: list[dict]) -> None:
    new = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(["L_pq", "QPS", "avg_cmps", "mean_latency_ms",
                        "recall", "rderr", "avg_hops"])
        for r in rows:
            w.writerow([r["L_pq"], f"{r['qps']:.2f}", f"{r['avg_cmps']:.2f}",
                        f"{r['mean_latency_ms']:.4f}", f"{r['recall']:.6f}",
                        f"{r.get('rderr', float('nan')):.6f}",
                        f"{r['avg_hops']:.2f}"])
