"""bench_torch.py, the port's twin of bench.py, at a tiny size on the CPU
(``--device cpu``, 3,000 base rows, 600 train and 256 eval queries, a
temporary cache): its row protocol and headline against bench.py's own
functions, the pooled flat row, ``main`` end to end (the child build, the
cache hit) and the slice against the JAX package on the same world.

Tolerance: the world arrays and the flat f32 ids are exact; the fused rows'
recall@10 may differ from the JAX package's by at most FUSED_RECALL_TOL,
since each package builds its own graph (phase-D ties and float sums may
order candidates differently) and serves it with its own searcher.
"""

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402  (the JAX package's driver: the protocol's reference)
import bench_torch  # noqa: E402

from mysteryann_tpu.flat import FlatIndex as JFlat  # noqa: E402
from mysteryann_tpu.graph import build_roargraph as j_build  # noqa: E402
from mysteryann_tpu.io import make_cross_modal as j_world  # noqa: E402
from mysteryann_tpu.ops import exact_knn as j_knn  # noqa: E402
from mysteryann_tpu.search.fused import FusedSearcher as JFused  # noqa: E402
from mysteryann_tpu.utils.metrics import compute_recall  # noqa: E402
from mysteryann_tpu.utils.params import BuildConfig as JConfig  # noqa: E402

TINY = ["--n_base", "3000", "--n_train", "600", "--n_eval", "256"]
CPU = ["--device", "cpu"]
FUSED_RECALL_TOL = 0.02
COMPARED_LS = (40, 112)      # two rows of SEEDED_L_SWEEP
# the scripted QPS sequences of tests/test_bench_protocol.py
SEQUENCES = [
    ([300_000.0, 10_000.0, 40_000.0, 41_000.0, 42_000.0], 3, 2),
    ([1.0, 2.0, 3.0, 4.0, 5.0], 3, 2),
    ([9.0, 9.0, 30.0, 10.0, 20.0], 3, 2),
    ([5.0, 7.0, 3.0, 8.0, 1.0, 9.0, 2.0], 5, 2),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test processes run side by side (pytest-xdist): one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scripted(seq):
    """bench_fn stub: a scripted qps series, ids equal to the ground truth."""
    nq, k = 8, 10
    ids = np.tile(np.arange(k, dtype=np.int64), (nq, 1))
    dists = -np.ones((nq, k), np.float32) * np.arange(1, k + 1)
    warmups = []

    def fn(warmup):
        i = min(len(warmups), len(seq) - 1)
        warmups.append(warmup)
        return {"qps": seq[i], "ids": ids, "dists": dists,
                "mean_latency_ms": 1.0 + i}

    return fn, ids, dists, warmups


@pytest.mark.parametrize("seq,repeats,ramp", SEQUENCES)
def test_protocol_equals_bench_py(seq, repeats, ramp):
    fn, ids, dists, w_jax = _scripted(seq)
    want = bench._bench_median(fn, ids, dists, k=10, repeats=repeats,
                               ramp=ramp)
    fn, ids, dists, w_port = _scripted(seq)
    got = bench_torch._bench_median(fn, ids, dists, k=10, repeats=repeats,
                                    ramp=ramp)
    assert got == want
    assert w_port == w_jax == [1] + [0] * (ramp + repeats - 1)


def test_protocol_defaults_are_bench_py():
    assert bench_torch.REPEATS == bench.REPEATS == 5
    assert bench_torch.SEEDED_L_SWEEP == bench.SEEDED_L_SWEEP
    assert (bench_torch.N_BASE, bench_torch.N_TRAIN, bench_torch.N_EVAL,
            bench_torch.KEY_VERSION, bench_torch.WORLD) == (
        bench.N_BASE, bench.N_TRAIN, bench.N_EVAL, bench.KEY_VERSION,
        bench.WORLD)
    assert (bench_torch.M_SQ, bench_torch.M_PJBP, bench_torch.L_PJPQ,
            bench_torch.BUILD_EXPAND, bench_torch.BUILD_BITS) == (
        bench.M_SQ, bench.M_PJBP, bench.L_PJPQ, bench.BUILD_EXPAND,
        bench.BUILD_BITS)
    assert bench_torch.read_baseline_qps() == bench.read_baseline_qps() > 0


CARD = {"device": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
# bench.py's compact final detail (bench.py::main, the `result` headline)
BENCH_DETAIL_KEYS = {"mode", "recall", "flat_qps", "graph_best",
                     "graph_build_secs", "baseline_qps_t16", "detail_file"}


@pytest.mark.parametrize("provisional", [False, True])
def test_headline_has_bench_py_keys_and_the_card(provisional):
    detail = {"mode": "flat", "recall": 0.9866}
    want = bench._headline(70729.5, 25418.0, dict(detail),
                           provisional=provisional)
    got = bench_torch._headline(70729.5, 25418.0, dict(detail), CARD,
                                provisional=provisional)
    assert set(got) == set(want)
    assert got["detail"] == {**detail, **CARD}
    for key in ("value", "unit", "vs_baseline"):
        assert got[key] == want[key]
    assert got["metric"] == want["metric"].replace("QPS/chip", "QPS/card")
    assert bench_torch._headline(1.0, 0.0, {}, CARD)["vs_baseline"] == 0.0


def _row(qps, recall=0.99, rderr=1e-4, latency=2.0):
    return {"qps": qps, "qps_trials": [qps - 1, qps, qps + 1],
            "qps_ramp": [qps / 2], "recall": recall, "rderr": rderr,
            "mean_latency_ms": latency}


def test_summarize_headline_keys_and_size():
    flat, flat8 = _row(100.0), _row(120.0, recall=0.98)
    graph = [dict(_row(90.0, recall=0.94), L_pq=40),
             dict(_row(150.0, recall=0.96), L_pq=48)]
    head, detail = bench_torch.summarize(flat, flat8, graph, _row(10.0), 12.5,
                                         25418.0, CARD, 61.23)
    assert set(head["detail"]) == BENCH_DETAIL_KEYS | {
        "device", "power_limit", "wall_secs"}
    assert head["detail"]["mode"] == detail["mode"] == "roargraph"
    assert head["value"] == 150.0
    assert head["detail"]["graph_best"] == {"qps": 150.0, "recall": 0.96,
                                            "L": 48}
    assert head["detail"]["detail_file"] == "bench_torch_detail.json"
    assert detail["wall_secs"] == 61.2 and detail["device"] == CARD["device"]
    assert len(json.dumps(head)) < 600
    # no row at the target: mode "none", value 0
    head, _ = bench_torch.summarize(_row(1.0, recall=0.5),
                                    _row(1.0, recall=0.5), [], None, None,
                                    0.0, CARD, 1.0)
    assert head["detail"]["mode"] == "none" and head["value"] == 0.0


def test_pooled_flat_row_takes_both_windows():
    w1, w2 = _row(100.0, latency=2.0), _row(200.0, latency=4.0)
    row = bench_torch.pool_flat_windows(w1, w2)
    assert row["qps_trials"] == [99.0, 100.0, 101.0, 199.0, 200.0, 201.0]
    assert row["qps"] == 199.0          # median of the pooled trials
    assert (row["qps_min"], row["qps_max"]) == (99.0, 201.0)
    assert (row["qps_w1"], row["qps_w2"]) == (100.0, 200.0)
    assert row["mean_latency_ms"] == 3.0
    assert row["qps_ramp"] == [50.0, 100.0]
    assert w1["qps"] == 100.0           # the windows' rows are not changed


@pytest.mark.parametrize("field", ["recall", "rderr"])
def test_pooled_flat_row_raises_on_unequal_windows(field):
    w1, w2 = _row(100.0), _row(200.0)
    w2[field] *= 0.5
    with pytest.raises(ValueError, match=field):
        bench_torch.pool_flat_windows(w1, w2)


def test_needs_a_card_without_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default device is valid")
    with pytest.raises(SystemExit) as e:
        bench_torch.main(TINY + ["--cache_dir", str(tmp_path)])
    assert e.value.code == 2


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def twin_run(tmp_path_factory):
    """main() twice on one cache: cold (the child builds) and warm (the
    index is read, nothing is built). Yields both records, the stdout of
    each and the child commands run."""
    cache = str(tmp_path_factory.mktemp("bench_torch_cache"))
    jax_detail = os.path.join(ROOT, "bench_detail.json")
    before = _sha(jax_detail)
    real_run = subprocess.run
    children = []

    def spy(cmd, *a, **kw):
        children.append(list(cmd))
        return real_run(cmd, *a, **kw)

    def no_build(*a, **kw):
        raise AssertionError("the warm run started a build")

    runs = {}
    for name, run, ramp in (("cold", spy, "1"), ("warm", no_build, "0")):
        out = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(out):
            mp.setattr(bench_torch.subprocess, "run", run)
            # the child build on one thread too: beside the other test
            # workers a multi-threaded build runs several times slower
            mp.setenv("OMP_NUM_THREADS", "1")
            runs[name] = bench_torch.main(
                TINY + CPU + ["--cache_dir", cache, "--repeats", "1",
                              "--ramp", ramp])
        runs[name + "_out"] = out.getvalue().strip().splitlines()
    assert _sha(jax_detail) == before
    return {"cache": cache, "children": children, **runs}


def test_main_end_to_end(twin_run):
    cold, warm = twin_run["cold"], twin_run["warm"]
    # the provisional lines, then the headline last
    *prov, last = twin_run["cold_out"]
    assert [json.loads(ln)["provisional"] for ln in prov] == [True, True]
    head = json.loads(last)
    assert "provisional" not in head
    assert {k: v for k, v in head.items() if k != "detail"} == \
        {k: v for k, v in cold.items() if k != "detail"}
    assert head["detail"]["graph_build_secs"] == \
        cold["detail"]["graph_build_secs"]
    assert json.loads(twin_run["warm_out"][-1])["value"] > 0
    (child,) = twin_run["children"]
    assert "--build-only" in child and child[child.index("--device") + 1] \
        == "cpu" and child[child.index("--n_base") + 1] == "3000"
    d = cold["detail"]
    assert d["graph_build_secs"] > 0 and d["device"] == "cpu"
    assert warm["detail"]["graph_build_secs"] == d["graph_build_secs"]
    assert [(r["expand"], r["seeds"], r["L_pq"]) for r in d["graph_rows"]] \
        == list(bench_torch.SEEDED_L_SWEEP)
    assert d["flat"]["recall"] == 1.0 and d["flat_int8"]["recall"] > 0.99
    assert d["classic_graph_row"]["L_pq"] == bench_torch.CLASSIC_L
    assert d["flat"]["qps_w1"] > 0 and d["flat"]["qps_w2"] > 0
    assert len(d["flat"]["qps_trials"]) == 2
    assert d["mode"] in ("flat", "flat_int8", "roargraph")
    # the same index, queries and batches: the warm run's ids are the cold's
    assert [r["recall"] for r in warm["detail"]["graph_rows"]] == \
        [r["recall"] for r in d["graph_rows"]]
    with open(os.path.join(ROOT, bench_torch.DETAIL_FILE)) as f:
        assert json.load(f)["detail"]["graph_rows"] == \
            warm["detail"]["graph_rows"]
    names = os.listdir(twin_run["cache"])
    assert any(n.endswith("_p2e4b4_proj.index") for n in names)
    assert all(n.startswith(("torch_", bench_torch.world_key(3000, 600)))
               for n in names)
    assert {n for n in names if not n.startswith("torch_")} == {
        "t2i1m_v3_3000_600_128_data.npz", "t2i1m_v3_3000_600_128_evalw256.npz"}


def test_main_last_line_is_the_headline(tmp_path, capsys):
    """A fresh cache: the provisional line after the flat rows comes out
    before the build; a failed child build fails the run."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_torch, "_child_argv", lambda args, cache: [
            sys.executable, "-c", "raise SystemExit(3)"])
        with pytest.raises(subprocess.CalledProcessError):
            bench_torch.main(["--n_base", "1000", "--n_train", "200",
                              "--n_eval", "64", "--repeats", "1", "--ramp",
                              "0", "--cache_dir", str(tmp_path)] + CPU)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    prov = json.loads(lines[0])
    assert prov["provisional"] and prov["detail"]["mode"] == "flat"
    assert prov["detail"]["device"] == "cpu"


def test_no_cache_leaves_nothing(tmp_path, monkeypatch, capsys):
    """--no_cache: the run's cache is a temporary directory, removed (the
    build and graph rows are stubbed: only the flat rows run)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(bench_torch, "graph_sweep", lambda *a, **kw: [])
    monkeypatch.setattr(bench_torch, "classic_row", lambda *a, **kw: None)
    monkeypatch.setattr(bench_torch, "load_index", lambda path: (None, 1.0))
    monkeypatch.setattr(bench_torch.subprocess, "run", lambda *a, **kw: None)
    rec = bench_torch.main(["--n_base", "1000", "--n_train", "200",
                            "--n_eval", "64", "--repeats", "1", "--ramp",
                            "0", "--no_cache"] + CPU)
    head = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert head["detail"]["mode"] == rec["detail"]["mode"]
    assert head["detail"]["mode"] in ("flat", "flat_int8")
    assert os.listdir(tmp_path) == []


def test_world_arrays_equal_the_jax_package():
    """The world's cache names are bench.py's: both packages must make the
    same arrays."""
    base, train_q, eval_q = bench_torch.world(None, 3000, 600, 256)
    jb, jt = j_world(3000, 600, bench_torch.DIM, metric="ip", seed=7,
                     **bench.WORLD)
    (je,) = [j_world(1, 256, bench.DIM, metric="ip", seed=7, query_seed=8,
                     **bench.WORLD)[1]]
    np.testing.assert_array_equal(base, jb)
    np.testing.assert_array_equal(train_q, jt)
    np.testing.assert_array_equal(eval_q, je)


def test_flat_ids_equal_the_jax_package():
    base, _, eval_q = bench_torch.world(None, 3000, 600, 256)
    want, _ = JFlat(base, metric="ip", tile=3000).search(eval_q, k=10)
    from mysteryann_tpu_torch.flat import FlatIndex
    got, _ = FlatIndex(base, metric="ip", tile=3000,
                       device="cpu").search(eval_q, k=10)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_fused_rows_near_the_jax_package(twin_run):
    """The JAX package's own build (the same recipe, its own kNN) and its
    FusedSearcher at bits 8: recall@10 within FUSED_RECALL_TOL of the
    twin's rows at two L. Its batches are cut to 1,024 train queries and
    256 phase-D nodes (a phase-D walk on the CPU costs about the same per
    batch at any width, ~28 s a round at 8,192): at 3,000 rows each
    phase-A batch and phase-D round still fits in one batch, so the graph
    is the one the recipe's 8,192 gives."""
    base, train_q, eval_q = bench_torch.world(twin_run["cache"], 3000, 600,
                                              256)
    gt_i = j_knn(eval_q, base, k=10, metric="ip", precision="highest")[1]
    knn = j_knn(train_q, base, k=bench.M_SQ, metric="ip", approx=True)[1]
    cfg = JConfig(M_sq=bench.M_SQ, M_pjbp=bench.M_PJBP, L_pjpq=bench.L_PJPQ,
                  metric="ip", query_batch=1024, search_batch=256,
                  connectivity_passes=2, connectivity_expand=bench.BUILD_EXPAND,
                  connectivity_bits=bench.BUILD_BITS)
    index = j_build(base, train_q, np.asarray(knn), cfg, verbose=False)
    fused = JFused(index, base, max_degree=bench.SEED_MAX_DEGREE,
                   seed_sample=bench.SEED_SAMPLE, bits=8)
    rows = {r["L_pq"]: r for r in twin_run["cold"]["detail"]["graph_rows"]}
    for expand, seeds, L in bench.SEEDED_L_SWEEP:
        if L not in COMPARED_LS:
            continue
        ids = fused.search(eval_q, 10, L, query_batch=8192, expand=expand,
                           seeds=min(seeds, L))[0]
        want = compute_recall(np.asarray(ids), np.asarray(gt_i), 10)
        assert abs(rows[L]["recall"] - want) <= FUSED_RECALL_TOL, (L, want)
