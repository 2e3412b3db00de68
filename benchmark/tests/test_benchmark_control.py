"""The comparison that decides ``correct`` fails its controls and the
faults a cell can have, in a whole run at a tiny size on the CPU.

Two controls, one for each precision the configuration states: the
reference put in the program's place one precision below its float32 with
TF32 off (TF32, ``reference/tf32_control.py``), and the program's own int8
scan below its stated bf16 scan (``serve.precision=int8``). The faults are
planted in the program underneath the timed path: half of each call's
queries left out and the other half's answers returned for them, and one
answer altered where it is made. A flat search keeps no state from step to
step, and one card exchanges nothing between cards, so neither of those
faults can happen here.
"""

from __future__ import annotations

import time

import pytest
import torch

from _tiny import REPO, tiny_tree

from benchmark.harness.runner import run_cell
from benchmark.tools.control import apply_sets, control_cell

CPU = torch.device("cpu")
CELLS = ["t2i10m-flat.b8192"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_tree(str(tmp_path_factory.mktemp("tiny")))


def _run(root, workload, cell=None, seed=77):
    return run_cell(root, workload, seed, 0.3, False, CPU,
                    time.perf_counter(), log=lambda *a: None, cell=cell)


@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_control_fails(root, workload):
    result, numbers = _run(root, workload)
    assert result["correct"] is True, numbers
    gap = numbers["dist_gap"]["value"]
    result, numbers = _run(root, workload,
                           control_cell(root, workload, "reference_tf32"))
    assert result["correct"] is False
    assert not numbers["dist_gap"]["ok"]
    assert numbers["dist_gap"]["value"] > 30 * gap


@pytest.mark.parametrize("workload", CELLS)
def test_int8_scan_is_switched_on(root, workload):
    """The program's own int8 scan, one step below its stated bf16 scan,
    runs through the same loop and comparison. Its head is reranked in
    exact f32, so its distances hold; on the card at the cell's size its
    recall reads within the sound runs' range (``PERF.md``), so it is a
    reading, not a control that has to fail."""
    cell = control_cell(root, workload, "program", ["serve.precision=int8"])
    assert cell.config["serve"]["precision"] == "int8"
    result, numbers = _run(root, workload, cell)
    assert numbers["dist_gap"]["ok"] and numbers["bad_answers"]["ok"]


def test_apply_sets():
    cfg = {"serve": {"precision": "bf16", "k": 10}}
    out = apply_sets(cfg, ["serve.precision=int8", "serve.k=20"])
    assert out == {"serve": {"precision": "int8", "k": 20}}
    assert cfg["serve"]["precision"] == "bf16"
    with pytest.raises(KeyError):
        apply_sets(cfg, ["serve.bits=4"])
    with pytest.raises(ValueError):
        control_cell(REPO, CELLS[0], "program_tf32")


def _searcher(workload):
    from mysteryann_tpu_torch.flat import FlatIndex
    return FlatIndex


def _half_left_out(search):
    def broken(self, queries, *a, **kw):
        half = queries.shape[0] // 2
        ids, dists, *rest = search(self, queries[:half], *a, **kw)
        return (torch.cat([ids, ids]), torch.cat([dists, dists]),
                *[torch.cat([r, r]) for r in rest])
    return broken


def _answer_altered(search):
    def broken(self, queries, *a, **kw):
        ids, dists, *rest = search(self, queries, *a, **kw)
        ids = ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % self.n_base
        return (ids, dists, *rest)
    return broken


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
def test_fault_fails(root, workload, fault, monkeypatch):
    cls = _searcher(workload)
    plant = {"half_left_out": _half_left_out,
             "answer_altered": _answer_altered}[fault]
    monkeypatch.setattr(cls, "search", plant(cls.search))
    result, numbers = _run(root, workload)
    assert result["correct"] is False, numbers
