"""The spec: BENCHMARK.json's shape, and cells found from files by name."""

from __future__ import annotations

import hashlib
import json
import os
import re

import pytest

from _tiny import REPO, copy_tree, edit_json

from benchmark.harness.spec import Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return Spec(REPO)


def test_top_level_keys(spec):
    assert set(spec.data) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert spec.data["paths"] == ["benchmark"]
    assert spec.data["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec.data["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 * 1024


def test_entries_keys_and_names(spec):
    d = spec.data
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    assert len({c["source"] for c in d["configs"]}) == len(d["configs"])
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in d["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    assert len(set(names)) == len(names)
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
        assert m["source"] in SOURCES
        assert m["moves"] in {e["name"] for e in d["end_to_end"]}
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in d["end_to_end"]}


def test_every_cell_loads_with_its_metrics(spec):
    for w in spec.data["workloads"]:
        cell = spec.cell(w["name"])
        e2e = {m.name for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            # a per-layer metric's cell reports the metric it moves
            assert m.entry["moves"] in e2e
        assert hasattr(cell.engine, "Engine")
        assert hasattr(cell.reference, "exact_topk")


def _digests(root: str) -> dict:
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_new_cell_is_files_plus_entries(tmp_path):
    """A new configuration, traffic mix and per-layer metric come as new
    files and new entries: no file already there is edited."""
    root = copy_tree(str(tmp_path / "tree"))
    before = _digests(os.path.join(root, "benchmark"))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "t2i10m-flat.json")) as f:
        cfg = json.load(f)
    cfg["serve"]["precision"] = "f32"
    with open(os.path.join(bench, "configs", "t2i10m-flatf32.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "b512.json"), "w") as f:
        json.dump({"generator": "closed_loop", "clients": 1, "batch": 512,
                   "warmup_calls": 2, "trace_seconds": 1.0,
                   "why": "a throwaway mix"}, f)
    with open(os.path.join(bench, "metrics", "calls_per_s.py"), "w") as f:
        f.write("def read(run):\n    return run.calls / run.window_s\n")
    data = json.load(open(os.path.join(root, "BENCHMARK.json")))
    data["configs"].append({"name": "t2i10m-flatf32", "source": "a throwaway",
                            "file": "benchmark/configs/t2i10m-flatf32.json",
                            "reduced": [], "why": "a throwaway"})
    data["workloads"].append({"name": "t2i10m-flatf32.b512",
                              "config": "t2i10m-flatf32", "traffic": "b512",
                              "chips": 1, "why": "a throwaway"})
    data["per_layer"].append({"name": "calls_per_s", "unit": "calls/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry point", "moves": "qps",
                              "workloads": ["t2i10m-flatf32.b512"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(data, f)

    cell = Spec(root).cell("t2i10m-flatf32.b512")
    assert cell.config["serve"]["precision"] == "f32"
    assert cell.traffic["batch"] == 512
    assert [m.name for m in cell.per_layer] == ["calls_per_s"]

    class _Run:
        calls, window_s = 10, 2.0
    assert cell.per_layer[0].read(_Run()) == 5.0
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_unknown_names_raise(tmp_path):
    root = copy_tree(str(tmp_path / "tree"))
    spec = Spec(root)
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
    edit_json(os.path.join(root, "benchmark", "configs", "t2i10m-flat.json"),
              engine="../run")
    with pytest.raises(ValueError):
        Spec(root).cell("t2i10m-flat.b8192")
