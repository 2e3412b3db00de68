"""bench_torch.py's contention sentinel and the serving-variance probes
(scripts/torch_probe_variance.py, scripts/torch_probe_l_monotone.py) at a
tiny size on the CPU (``--device cpu``): the sentinel's tiled min equals
the untiled one bit for bit, ``run()`` records it before and after the rows
without changing the compact headline's keys, and each probe prints its
JSON lines, with recall@10 equal to ``FusedSearcher.search``'s on the same
inputs.

The probes read bench_torch.py's cached index; the fixture builds a small
one (one phase-D pass, narrow batches) and saves it under that name, so the
tests time the probes' protocol, not a full recipe's build.
"""

import contextlib
import importlib.util
import io
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
sys.path[:0] = [ROOT, SCRIPTS]

import bench_torch as bt  # noqa: E402

from mysteryann_tpu_torch.search.fused import FusedSearcher  # noqa: E402
from mysteryann_tpu_torch.utils.metrics import compute_recall  # noqa: E402

N_BASE, N_TRAIN, N_EVAL = 2000, 600, 128
TINY = ["--n_base", str(N_BASE), "--n_train", str(N_TRAIN),
        "--n_eval", str(N_EVAL)]
CPU = ["--device", "cpu"]
# the compact headline's detail keys (tests/test_torch_bench.py)
HEADLINE_DETAIL_KEYS = {"mode", "recall", "flat_qps", "graph_best",
                        "graph_build_secs", "baseline_qps_t16",
                        "detail_file", "device", "power_limit", "wall_secs"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test processes run side by side (pytest-xdist): one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny_index(tmp_path_factory):
    """bench_torch.py's cache at the tiny size: world, ground truth and an
    index saved as bench_torch.py's own (a light recipe)."""
    d = str(tmp_path_factory.mktemp("bench_tools_cache"))
    key = bt.world_key(N_BASE, N_TRAIN)
    base, train_q, eval_q = bt.world(d, N_BASE, N_TRAIN, N_EVAL)
    base_t = torch.from_numpy(base)
    gt_i, gt_d = bt.ground_truth(d, key, eval_q, base_t)
    from mysteryann_tpu_torch.ops import exact_knn
    _, knn = exact_knn(train_q, base_t, k=16, metric="ip", device="cpu")
    from mysteryann_tpu_torch.utils.params import BuildConfig
    cfg = BuildConfig(M_sq=16, M_pjbp=16, L_pjpq=32, metric=bt.METRIC,
                      query_batch=512, search_batch=512,
                      connectivity_passes=1)
    index_path, ck_dir = bt.index_paths(d, key)
    index, _ = bt.build_index(base_t, train_q, knn, cfg, index_path, ck_dir,
                              torch.device("cpu"))
    return {"dir": d, "base": base, "eval_q": eval_q, "gt_i": gt_i,
            "gt_d": gt_d, "index": index}


# ---- the sentinel ---------------------------------------------------------

@pytest.mark.parametrize("n,tile", [(3000, 1024), (2048, 512), (700, 4096)])
def test_sentinel_tiled_min_equals_untiled(n, tile):
    rng = np.random.default_rng(n)
    q = torch.from_numpy(rng.standard_normal((64, 128), np.float32))
    base = torch.from_numpy(rng.standard_normal((n, 128), np.float32))
    tiled = bt.sentinel_min(q, base, tile)
    whole = (q.to(torch.bfloat16) @ base.to(torch.bfloat16).T).amin(dim=1)
    assert tiled.dtype == torch.bfloat16 and tiled.shape == (64,)
    assert torch.equal(tiled, whole)


def test_sentinel_returns_five_sorted_positive_ms():
    base = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1500, 128), np.float32))
    ts = bt.contention_sentinel(base)
    assert len(ts) == 5 and ts == sorted(ts) and all(t > 0 for t in ts)
    assert bt.SENTINEL_QUERIES == 8192 and bt.SENTINEL_ROWS == 1_000_000


def test_run_records_the_sentinel_pre_and_post(tiny_index):
    def no_build(*a, **kw):
        raise AssertionError("the index is cached: nothing to build")

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(bt.subprocess, "run", no_build)
        rec = bt.main(TINY + CPU + ["--cache_dir", tiny_index["dir"],
                                    "--repeats", "1", "--ramp", "1"])
    sent = rec["detail"]["contention_sentinel_ms"]
    assert set(sent) == {"pre", "post"}
    for ts in sent.values():
        assert len(ts) == 5 and ts == sorted(ts) and all(t > 0 for t in ts)
    head = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(head["detail"]) == HEADLINE_DETAIL_KEYS
    assert "contention_sentinel_ms" not in head["detail"]


# ---- the probes -----------------------------------------------------------

def _lines(capsys):
    return [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]


def test_probe_variance_tiny(tiny_index, capsys):
    pv = _script("torch_probe_variance")
    qb = 64                     # two batches of the 128 eval queries
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pv, "QB", qb)
        mp.setattr(pv, "TRIALS", 2)
        mp.setattr(pv, "CHURN_GIB", 0.001)
        out = pv.main(TINY + CPU + ["--cache_dir", tiny_index["dir"]])
    lines = _lines(capsys)
    assert lines == out
    assert [r["label"] for r in lines] == [
        "A_fresh", "B_after_alloc_churn", "C_after_empty_cache"]
    n_batches = math.ceil(N_EVAL / qb)
    fused = FusedSearcher(tiny_index["index"], tiny_index["base"],
                          max_degree=bt.SEED_MAX_DEGREE,
                          seed_sample=bt.SEED_SAMPLE, device="cpu")
    ids = fused.search(tiny_index["eval_q"], pv.K, pv.L, query_batch=qb,
                       expand=pv.EXPAND, seeds=pv.SEEDS)[0]
    want = compute_recall(ids, tiny_index["gt_i"], pv.K)
    for r in lines:
        assert len(r["per_batch_ms"]) == n_batches
        assert len(r["qps"]) == len(r["trial_ms"]) == 2
        assert all(len(b) == n_batches for b in r["trial_batch_ms"])
        assert all(q > 0 for q in r["qps"])
        assert r["recall"] == [want, want]
        assert r["device"] == "cpu" and r["L"] == 56
    assert len(lines[0]["sentinel_pre_ms"]) == 5
    assert len(lines[2]["sentinel_post_ms"]) == 5


def test_probe_l_monotone_tiny(tiny_index, capsys):
    pl = _script("torch_probe_l_monotone")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "TRIALS", 2)
        mp.setattr(pl, "RAMP", 1)
        out = pl.main(TINY + CPU + ["--cache_dir", tiny_index["dir"]])
    (line,) = _lines(capsys)
    assert line == out and out["probe"] == "l_monotone"
    assert [r["L"] for r in out["rows"]] == list(pl.LS)
    fused = FusedSearcher(tiny_index["index"], tiny_index["base"],
                          max_degree=bt.SEED_MAX_DEGREE,
                          seed_sample=bt.SEED_SAMPLE, bits=8, device="cpu")
    for r in out["rows"]:
        ids = fused.search(tiny_index["eval_q"], pl.K, r["L"],
                           query_batch=pl.QB, expand=pl.EXPAND,
                           seeds=min(pl.SEEDS, r["L"]))[0]
        assert r["recall"] == round(float(compute_recall(
            ids, tiny_index["gt_i"], pl.K)), 4)
        assert len(r["trials"]) == 2
        assert r["min"] <= r["median"] <= r["max"]


@pytest.mark.parametrize("name", ["torch_probe_variance",
                                  "torch_probe_l_monotone"])
def test_probe_without_an_index_exits_2(name, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        _script(name).main(TINY + CPU + ["--cache_dir", str(tmp_path)])
    assert e.value.code == 2
    assert "bench_torch.py" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["torch_probe_variance",
                                  "torch_probe_l_monotone"])
def test_probe_needs_a_card_without_device_cpu(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        _script(name).main(TINY + ["--cache_dir", str(tmp_path)])
    assert e.value.code == 2
