"""The benchmark scripts under scripts/torch_*.py, through their main() at
a tiny size on the CPU (``--device cpu``; they take the card otherwise):
each prints one JSON line with the documented keys, finds what an earlier
script cached, and says so when something it needs is not there. The 50M
script's streamed ground truth is held against a one-shot exact kNN.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from mysteryann_tpu_torch.ops.knn import exact_knn_device

CPU = ["--device", "cpu"]
SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
SCRIPT_NAMES = ["torch_bench_4m_fused", "torch_build_10m", "torch_sweep_10m",
           "torch_bench_10m", "torch_bench_50m", "torch_bench_bipartite",
           "torch_large_paths_check", "torch_regen_1m_cache",
           "torch_probe_build_1m", "torch_probe_frontier_99",
           "torch_sweep_1m_p3"]
TINY_10M = ["--n_base", "2000", "--n_train", "600", "--n_eval", "128",
            "--dim", "32"]
# bench_torch.py's world (128-d) at a tiny size
TINY_1M = ["--n_base", "2000", "--n_train", "600", "--n_eval", "128"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test processes run side by side (pytest-xdist); these tests run
    torch on one thread so its pool does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    """A script imported by path (scripts/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_line(capsys) -> dict:
    """The script's stdout is exactly one line, a JSON object."""
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("name", SCRIPT_NAMES)
def test_script_help(name, capsys):
    with pytest.raises(SystemExit) as e:
        _script(name).main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--device" in out and "--n_base" in out


@pytest.mark.parametrize("name", SCRIPT_NAMES)
def test_script_imports_only_the_port(name):
    with open(os.path.join(SCRIPTS, name + ".py")) as f:
        src = f.read()
    assert "mysteryann_tpu_torch" in src
    for line in src.splitlines():
        words = line.split()
        if words and words[0] in ("import", "from"):
            assert words[1].split(".")[0] not in (
                "jax", "mysteryann_tpu", "bench"), line


@pytest.mark.parametrize("engine", ["classic", "auto"])
def test_bench_4m_fused_tiny(engine, tmp_path, capsys):
    out = _script("torch_bench_4m_fused").main(
        ["--n_base", "2000", "--n_train", "600", "--n_eval", "128",
         "--dim", "32", "--passes", "1", "--engine", engine, "--Ls", "48,64",
         "--query_batch", "128", "--cache_dir", str(tmp_path)] + CPU)
    assert _json_line(capsys) == out
    assert out["scale"] == 2000 and out["device"] == "cpu"
    # on the CPU "auto" keeps the fixed thresholds: a small table is fused
    assert out["engine"] == ("fused" if engine == "auto" else "classic")
    assert out["fold"] == "single" and out["build_secs"] > 0
    assert [r["L_pq"] for r in out["rows"]] == [48, 64]
    assert all(r["recall"] > 0.8 for r in out["rows"])
    assert any(f.endswith(f"_{out['engine']}_proj.index")
               for f in os.listdir(tmp_path))


@pytest.fixture(scope="module")
def cache_10m(tmp_path_factory):
    """The cache directory torch_build_10m.py leaves behind (1 pass)."""
    d = str(tmp_path_factory.mktemp("torch_bench_cache"))
    out = _script("torch_build_10m").main(
        TINY_10M + ["--passes", "1", "--query_batch", "128", "--cache_dir", d]
        + CPU)
    return d, out


def test_build_10m_tiny(cache_10m):
    d, out = cache_10m
    assert out["scale"] == 2000 and out["n_train"] == 600
    assert (out["engine"], out["fold"]) == ("fused", "single")
    assert out["degree"]["zero"] == 0 and out["degree"]["max"] <= 64
    assert set(out["phases_s"]) >= {"build.phaseBC", "build.phaseD"}
    assert [r["mode"] for r in out["rows"]] == [
        f"graph_classic_seeded_L{L}" for L in (100, 150, 250)]
    assert out["rows"][-1]["recall"] > 0.9
    assert out["device"] == "cpu" and out["power_limit"] is None


def test_build_10m_reloads_its_index(cache_10m, capsys):
    d, first = cache_10m
    again = _script("torch_build_10m").main(
        TINY_10M + ["--passes", "1", "--query_batch", "128", "--cache_dir", d,
                    "--serve_engine", "fused"] + CPU)
    assert _json_line(capsys) == again
    assert again["build_secs"] == first["build_secs"]   # read, not rebuilt
    assert again["phases_s"] is None
    assert again["degree"] == first["degree"]
    assert again["rows"][0]["mode"] == "graph_fused_seeded_L100"


def test_sweep_10m_tiny(cache_10m, capsys):
    d, _ = cache_10m
    out = _script("torch_sweep_10m").main(
        TINY_10M + ["--passes", "1", "--Ls", "30", "60", "--seed_samples",
                    "4", "--query_batch", "128", "--cache_dir", d] + CPU)
    assert _json_line(capsys) == out
    assert [r["mode"] for r in out["rows"]] == ["graph_p1_r4_L30",
                                                "graph_p1_r4_L60"]
    assert out["rows"][1]["recall"] >= out["rows"][0]["recall"] > 0.5
    assert out["index"].endswith("_p1_fused_proj.index")


def test_sweep_10m_without_an_index_exits_2(tmp_path):
    with pytest.raises(SystemExit) as e:
        _script("torch_sweep_10m").main(
            TINY_10M + ["--cache_dir", str(tmp_path)] + CPU)
    assert e.value.code == 2


def test_bench_10m_tiny_finds_the_cached_graph(cache_10m, capsys):
    d, _ = cache_10m
    out = _script("torch_bench_10m").main(
        TINY_10M + ["--query_batch", "128", "--n_clusters", "16",
                    "--nprobes", "4", "16", "--cache_dir", d] + CPU)
    assert _json_line(capsys) == out
    modes = [r["mode"] for r in out["rows"]]
    # dim 32: the binned scan needs a multiple of 128 and is skipped
    assert out["skipped"] == ["flat_scan"]
    assert modes[:3] == ["flat_f32", "flat_bf16", "flat_int8"]
    assert "graph_p1_seeded_L100" in modes and "ivf_np16" in modes
    rec = {r["mode"]: r["recall"] for r in out["rows"]}
    assert rec["flat_f32"] == 1.0 and rec["flat_int8"] > 0.9
    assert rec["ivf_np16"] >= rec["ivf_np4"]


def test_bench_10m_only_ivf_and_no_cache(capsys):
    out = _script("torch_bench_10m").main(
        TINY_10M + ["--only-ivf", "--no_cache", "--query_batch", "128",
                    "--n_clusters", "16", "--nprobes", "16"] + CPU)
    assert _json_line(capsys) == out
    assert out["only_ivf"] and [r["mode"] for r in out["rows"]] == ["ivf_np16"]
    assert out["rows"][0]["recall"] > 0.99      # every cluster probed


def test_bench_10m_sharded_fused_tiny(cache_10m, capsys):
    """The cached graph served by 2 gloo ranks (a 1 x 2 mesh): one JSON line
    with one row per L, and nothing else of the sweep."""
    d, _ = cache_10m
    out = _script("torch_bench_10m").main(
        TINY_10M + ["--sharded-fused", "2", "--cache_dir", d] + CPU)
    assert _json_line(capsys) == out
    assert out["sharded_fused"] == 2 and out["device"] == "cpu"
    assert [r["mode"] for r in out["rows"]] == [
        f"sharded_fused_mp2_L{L}" for L in (48, 64, 96, 128)]
    assert all(r["qps"] > 0 for r in out["rows"])
    assert out["rows"][-1]["recall"] > 0.9


def test_bench_10m_sharded_fused_without_an_index_exits_2(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        _script("torch_bench_10m").main(
            TINY_10M + ["--sharded-fused", "2", "--cache_dir",
                        str(tmp_path)] + CPU)
    assert e.value.code == 2
    assert "torch_build_10m.py first" in capsys.readouterr().err


def test_bench_50m_tiny(tmp_path, capsys):
    out = _script("torch_bench_50m").main(
        ["--n_base", "3000", "--n_eval", "128", "--dim", "32", "--tile",
         "1024", "--query_batch", "64", "--qb_ivf", "64", "--nprobes", "4",
         "1000", "--rerank", "20", "--cache_dir", str(tmp_path)] + CPU)
    assert _json_line(capsys) == out
    assert out["scale"] == 3000 and out["gt_secs"] is not None
    modes = [r["mode"] for r in out["rows"]]
    assert modes[-1] == "flat_i8" and modes[0] == "ivf_i8_p4"
    rec = {r["mode"]: r["recall"] for r in out["rows"]}
    # nprobe clamps to n_clusters: every block scanned, int8 + f32 rerank
    assert max(v for m, v in rec.items() if m.startswith("ivf")) > 0.97
    assert rec["flat_i8"] > 0.97
    assert any("_gt_" in f for f in os.listdir(tmp_path))


@pytest.mark.parametrize("n,tile", [(3000, 1024), (2048, 1024), (700, 1024)])
def test_streamed_gt_is_the_exact_knn(n, tile):
    """Clamped tail windows feed their overlap rows in twice; the id-dedup
    merge must leave the one-shot exact top-k, ids distinct and < n."""
    drv = _script("torch_bench_50m")
    spec = drv.make_spec(32, "cpu")
    q = spec.queries(64)
    bd, bi = drv.streamed_gt(spec, q, n, tile)
    wd, wi = exact_knn_device(q, spec.base_tile(0, n), k=drv.K, metric="ip",
                              tile=n, precision="highest")
    np.testing.assert_array_equal(bi.numpy(), wi.numpy())
    np.testing.assert_allclose(bd.numpy(), wd.numpy(), rtol=0, atol=1e-6)
    assert (np.sort(bi.numpy(), axis=1)[:, 1:]
            != np.sort(bi.numpy(), axis=1)[:, :-1]).all()


def test_bench_bipartite_tiny(capsys):
    out = _script("torch_bench_bipartite").main(
        ["--n_base", "1500", "--n_train", "600", "--n_eval", "32", "--dim",
         "16", "--Ls", "10", "20", "--no_cache"] + CPU)
    assert _json_line(capsys) == out
    assert out["scale"] == 1500 and out["two_hop_chunk"] > 0
    assert [r["mode"] for r in out["rows"]] == ["bipartite_two_hop_L10",
                                                "bipartite_two_hop_L20"]
    assert out["rows"][1]["recall"] >= out["rows"][0]["recall"] > 0.5


@pytest.mark.parametrize("engine", ["fused", "classic"])
def test_large_paths_check_tiny(engine, capsys):
    out = _script("torch_large_paths_check").main(
        ["--n_base", "2000", "--n_train", "600", "--dim", "32", "--engine",
         engine] + CPU)
    assert _json_line(capsys) == out
    assert out["bit_identical"] and out["engine"] == engine
    assert out["planned"]["fold"] == "single" and not out["planned"]["large"]
    assert out["forced"]["fold"] == "slab" and out["forced"]["slab_rows"] > 0


def test_bench_4m_fused_flat_tiny(tmp_path, capsys):
    out = _script("torch_bench_4m_fused").main(
        ["--n_base", "2000", "--n_train", "600", "--n_eval", "128",
         "--dim", "32", "--flat", "--cache_dir", str(tmp_path)] + CPU)
    assert _json_line(capsys) == out
    assert out["probe"] == "flat_4m" and out["scale"] == 2000
    assert [r["mode"] for r in out["rows"]] == ["flat_f32", "flat_bf16"]
    rec = {r["mode"]: r["recall"] for r in out["rows"]}
    assert rec["flat_f32"] == 1.0 and rec["flat_bf16"] > 0.99
    assert all(len(r["qps_trials"]) == 5 and len(r["qps_ramp"]) == 2
               for r in out["rows"])
    assert not any("_knn" in f or f.endswith(".index")
                   for f in os.listdir(tmp_path))     # no kNN, no build


@pytest.fixture(scope="module")
def cache_1m(tmp_path_factory):
    """bench_torch.py's tiny cache as torch_regen_1m_cache.py fills it."""
    d = str(tmp_path_factory.mktemp("bench_torch_cache"))
    return d, _script("torch_regen_1m_cache").main(
        TINY_1M + ["--cache_dir", d] + CPU)


def test_regen_1m_cache_fills_what_bench_torch_reads(cache_1m):
    d, out = cache_1m
    bt = _script("torch_regen_1m_cache").bt
    key = bt.world_key(2000, 600)
    assert out["key"] == key and set(out["secs"]) == {"data", "gt", "knn"}
    assert out["files"] == sorted([
        f"{key}_data.npz", f"{key}_evalw128.npz", f"torch_{key}_gtw128.npz",
        f"torch_{key}_knn.npz"])

    def recompute(*a, **kw):
        raise AssertionError("recomputed a cached array")

    with pytest.MonkeyPatch.context() as mp:
        import mysteryann_tpu_torch.io as tio
        import mysteryann_tpu_torch.ops as tops
        mp.setattr(tio, "make_cross_modal", recompute)
        mp.setattr(tops, "exact_knn", recompute)
        base, train_q, eval_q = bt.world(d, 2000, 600, 128)
        gt_i, _ = bt.ground_truth(d, key, eval_q, torch.from_numpy(base))
        knn = bt.build_knn(d, key, train_q, torch.from_numpy(base))
    assert base.shape == (2000, 128) and eval_q.shape == (128, 128)
    assert gt_i.shape == (128, 10) and gt_i.dtype == np.int64
    assert knn.shape == (600, bt.M_SQ)


@pytest.fixture(scope="module")
def index_1m(cache_1m):
    """torch_probe_build_1m.py with bench_torch.py's recipe (p2e4b4)."""
    d, _ = cache_1m
    return d, _script("torch_probe_build_1m").main(
        TINY_1M + ["--Ls", "40,48", "--cache_dir", d] + CPU)


def test_probe_build_1m_tiny(index_1m, capsys):
    d, out = index_1m
    assert out["tag"] == "p2e4b4" and out["build_secs"] > 0
    assert out["index"] == "torch_t2i1m_v3_2000_600_128_64_32_128_p2e4b4" \
        "_proj.index"
    assert [r["L_pq"] for r in out["rows"]] == [40, 48]
    assert all(r["recall"] > 0.9 for r in out["rows"])
    again = _script("torch_probe_build_1m").main(
        TINY_1M + ["--skip_serve", "--cache_dir", d] + CPU)
    assert _json_line(capsys) == again
    assert again["build_secs"] == out["build_secs"] and again["rows"] == []


def test_probe_frontier_99_tiny(index_1m, capsys):
    d, _ = index_1m
    out = _script("torch_probe_frontier_99").main(
        TINY_1M + ["--cache_dir", d] + CPU)
    assert _json_line(capsys) == out
    rows = out["rows"]
    assert rows and rows[0]["config"] == "e4_hi" and rows[0]["L_pq"] == 112
    # the walk stops at the first row past the frontier
    assert rows[-1]["recall"] >= 0.992
    assert all(r["recall"] < 0.992 for r in rows[:-1])


def test_probe_frontier_99_without_an_index_exits_2(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        _script("torch_probe_frontier_99").main(
            TINY_1M + ["--cache_dir", str(tmp_path)] + CPU)
    assert e.value.code == 2
    assert "bench_torch.py" in capsys.readouterr().err


def test_sweep_1m_p3_tiny(cache_1m, capsys):
    d, _ = cache_1m
    out = _script("torch_sweep_1m_p3").main(
        TINY_1M + ["--passes", "1", "--L", "40", "60", "--cache_dir", d]
        + CPU)
    assert _json_line(capsys) == out
    assert out["passes"] == 1 and out["build_secs"] > 0
    assert out["degree"]["zero"] == 0
    assert [r["L"] for r in out["rows"]] == [40, 60]
    assert out["rows"][1]["recall"] >= out["rows"][0]["recall"] > 0.8
    assert out["best_at_95"] in out["rows"] + [None]
    assert any(f.endswith("_p1_proj.index") for f in os.listdir(d))
