"""Find a cell and everything it needs by the names in ``BENCHMARK.json``.

A later change adds a configuration, a traffic mix or a metric as new files
plus entries, and edits no file here: each piece is looked up by name under
the benchmark's directory.

- configuration ``c``: the ``file`` its entry names (``configs/<c>.json``),
  whose ``engine`` names ``engines/<engine>.py`` and whose ``reference``
  names ``reference/<reference>.py``;
- traffic mix ``t``: ``traffic/<t>.json``;
- metric ``m``: ``metrics/<m>.py``, a module with ``read(run) -> float |
  None``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass, field
from types import ModuleType
from typing import List

BENCH_DIR = "benchmark"
SPEC_FILE = "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_module(path: str) -> ModuleType:
    """Import the Python file ``path`` as a module of its own (a metric's
    name has dots, so it is no importable module name)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    tag = re.sub(r"[^A-Za-z0-9_]", "_", os.path.abspath(path))
    mod_name = f"_bench_file_{tag}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _check_name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


@dataclass
class Metric:
    """One entry of ``end_to_end`` or ``per_layer`` and its reader."""
    name: str
    unit: str
    entry: dict
    reader: ModuleType

    def read(self, run) -> float | None:
        value = self.reader.read(run)
        return None if value is None else float(value)


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict              # the configuration's file, plus "name"
    traffic: dict             # the traffic mix's file, plus "name"
    engine: ModuleType        # engines/<engine>.py
    reference: ModuleType     # reference/<reference>.py
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


class Spec:
    """``BENCHMARK.json`` under ``root``, the root of a checkout."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.data = _read_json(os.path.join(self.root, SPEC_FILE))
        self.dir = os.path.join(self.root, BENCH_DIR)

    def path(self, *parts: str) -> str:
        return os.path.join(self.dir, *parts)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        known = ", ".join(w["name"] for w in self.data["workloads"])
        raise KeyError(f"no workload {name!r} in {SPEC_FILE} ({known})")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                cfg = _read_json(os.path.join(self.root, c["file"]))
                return {**cfg, "name": name}
        raise KeyError(f"no config {name!r} in {SPEC_FILE}")

    def traffic(self, name: str) -> dict:
        _check_name("traffic", name)
        return {**_read_json(self.path("traffic", f"{name}.json")),
                "name": name}

    def engine(self, config: dict) -> ModuleType:
        return load_module(self.path(
            "engines", f"{_check_name('engine', config['engine'])}.py"))

    def reference(self, config: dict) -> ModuleType:
        return load_module(self.path(
            "reference", f"{_check_name('reference', config['reference'])}.py"))

    def metric(self, entry: dict) -> Metric:
        name = _check_name("metric", entry["name"])
        return Metric(name, entry["unit"], entry,
                      load_module(self.path("metrics", f"{name}.py")))

    def cell(self, name: str) -> Cell:
        w = self.workload(name)
        config = self.config(w["config"])
        e2e = [m for m in self.data["end_to_end"]
               if "workloads" not in m or name in m["workloads"]]
        e2e_names = {m["name"] for m in e2e}
        # a per-layer metric without "workloads" is read wherever the
        # end-to-end metric it moves is
        layer = [m for m in self.data["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
        return Cell(name=name, workload=w, config=config,
                    traffic=self.traffic(w["traffic"]),
                    engine=self.engine(config),
                    reference=self.reference(config),
                    end_to_end=[self.metric(m) for m in e2e],
                    per_layer=[self.metric(m) for m in layer])
