"""Whole runs at a tiny size on the CPU (the look for a card skipped), the
result line's keys, the refusal without a card, and one run on the card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from _tiny import REPO, copy_tree, tiny_tree

from benchmark.harness.runner import run_cell

CPU = torch.device("cpu")
SEED = 2**31 + 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_tree(str(tmp_path_factory.mktemp("tiny")))


def _run(root, workload, trace=False, seconds=0.5, device=CPU):
    return run_cell(root, workload, SEED, seconds, trace, device,
                    time.perf_counter(), log=lambda *a: None)


@pytest.mark.parametrize("workload", ["t2i10m-flat.b8192"])
def test_result_line_keys(root, workload):
    result, numbers = _run(root, workload)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    names = {m["name"] for m in json.load(
        open(os.path.join(root, "BENCHMARK.json")))["end_to_end"]
        if "workloads" not in m or workload in m["workloads"]}
    assert set(result["metrics"]) == names
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["checks"]) == {"bad_answers", "dist_gap",
                                     "recall_at_10"}
    for v in result["checks"].values():
        assert set(v) == {"value", "limit"}
    assert all(v["ok"] for v in numbers.values())
    json.dumps(result)


def test_trace_run_keys(root):
    result, _ = _run(root, "t2i10m-flat.b8192", trace=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert result["correct"] is True
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device trace: the device's readers read nothing
    assert result["metrics"] == {}


def test_no_card_no_result(tmp_path):
    """Without CUDA the command exits non-zero and prints nothing on
    standard output, here and in a tree of only the benchmark's files."""
    for cwd in (REPO, copy_tree(str(tmp_path / "alone"))):
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "t2i10m-flat.b8192", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_tiny_cells_on_the_card(root, cuda):
    result, _ = _run(root, "t2i10m-flat.b8192", trace=True, device=cuda)
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0
    assert set(result["metrics"]) == {"flat.k3f_roofline", "device.idle_pct"}
