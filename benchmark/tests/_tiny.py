"""A copy of the benchmark tree at a size the CPU runs in seconds."""

from __future__ import annotations

import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_WORLD = dict(n_base=2000, n_pool=256, n_concepts=64)
TINY_BATCH = {"b8192": 64}


def edit_json(path: str, **updates) -> dict:
    with open(path) as f:
        data = json.load(f)
    for key, value in updates.items():
        if isinstance(value, dict) and isinstance(data.get(key), dict):
            data[key].update(value)
        else:
            data[key] = value
    with open(path, "w") as f:
        json.dump(data, f)
    return data


def copy_tree(dst: str) -> str:
    """``BENCHMARK.json`` and ``benchmark/`` under ``dst``, as committed."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", ".cache",
                                                  "__pycache__"))
    return dst


def tiny_tree(dst: str) -> str:
    """``copy_tree`` with every configuration and mix cut to a tiny size."""
    copy_tree(dst)
    cfg_dir = os.path.join(dst, "benchmark", "configs")
    for name in os.listdir(cfg_dir):
        path = os.path.join(cfg_dir, name)
        with open(path) as f:
            cfg = json.load(f)
        edit_json(path, world=dict(TINY_WORLD))
    for mix, batch in TINY_BATCH.items():
        edit_json(os.path.join(dst, "benchmark", "traffic", f"{mix}.json"),
                  batch=batch, warmup_calls=1, trace_seconds=0.1)
    return dst
