"""The port's reference-baseline scripts end to end on the CPU
(``--device cpu --threads 1``, tiny worlds, a temporary cache and work
directory): scripts/torch_run_baseline_1m.py, torch_run_baseline_4m.py and
torch_calibrate_world.py run the tracked ``baseline/bench_reference`` on
inputs the port made and exported.

Checked: the exported fbin / ibin are byte-identical to what the JAX
package's `write_fbin` / `write_knn_ibin` write for the same arrays; the
port's ground-truth ids equal the JAX `exact_knn`'s (ids up to ties at the
k-th distance, distances exactly) and its train kNN too (ids up to ties);
the reference's rows are parsed and ``crossing_L`` is the first row at or
above the target; ``baseline/`` is byte for byte the same after the runs;
the reference binary's failures end a script with their code
(scripts/torch_reference.py).
"""

import hashlib
import importlib.util
import json
import os
import shutil
import stat
import sys

import numpy as np
import pytest
import torch

from mysteryann_tpu.io import write_fbin as j_write_fbin
from mysteryann_tpu.io.formats import write_knn_ibin as j_write_knn_ibin
from mysteryann_tpu.ops import exact_knn as j_exact_knn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
BASELINE = os.path.join(ROOT, "baseline")
sys.path[:0] = [ROOT, SCRIPTS]

import torch_reference as ref  # noqa: E402

CPU = ["--device", "cpu", "--threads", "1"]
NEW_SCRIPTS = ["torch_reference", "torch_run_baseline_1m",
               "torch_run_baseline_4m", "torch_calibrate_world",
               "torch_probe_variance", "torch_probe_l_monotone"]


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


def _tree_digest(root):
    """Paths, modes and contents of every file under ``root``."""
    h = hashlib.sha256()
    for d, dirs, files in sorted(os.walk(root)):
        dirs.sort()
        for f in sorted(files):
            p = os.path.join(d, f)
            h.update(os.path.relpath(p, root).encode())
            h.update(str(os.stat(p).st_mode).encode())
            with open(p, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def _npz(cache, name):
    with np.load(os.path.join(cache, name + ".npz")) as z:
        return [z[k] for k in z.files]


def _assert_exports_equal_jax(wd, names, arrays, tmp_path):
    """Each export against the JAX package's writer on the same array."""
    for key, arr in arrays.items():
        ref_path = str(tmp_path / f"jax_{key}")
        if key in ("knn", "gt"):
            j_write_knn_ibin(ref_path, np.asarray(arr).astype(np.int32))
        else:
            j_write_fbin(ref_path, arr)
        with open(os.path.join(wd, names[key]), "rb") as a, \
                open(ref_path, "rb") as b:
            assert a.read() == b.read(), key


def _assert_ids_up_to_ties(ids, want_ids, want_d):
    """Per row, the ids strictly inside the k-th distance are the same set;
    ids at the k-th distance may differ (a tie)."""
    for a, b, d in zip(ids, want_ids, want_d):
        inner = d != d[-1]
        assert set(a[inner]) == set(b[inner])
        assert set(a[inner]) <= set(a)


def _assert_gt_equals_jax(gt_i, gt_d, eval_q, base):
    jd, ji = j_exact_knn(eval_q, base, k=10, metric="ip", query_batch=8192,
                         base_tile=131072, precision="highest")
    np.testing.assert_array_equal(gt_d, jd)          # distances exactly
    _assert_ids_up_to_ties(gt_i, ji, jd)


def _assert_result(out, target=0.95):
    rows = out["rows"]
    assert rows and all(set(r) == {"L_pq", "qps", "recall"} for r in rows)
    assert all(r["qps"] > 0 and 0 <= r["recall"] <= 1 for r in rows)
    first = next((r for r in rows if r["recall"] >= target), None)
    assert out["crossing_L"] == (first["L_pq"] if first else None)
    assert out["crossing_qps"] == (first["qps"] if first else None)


def test_run_baseline_1m_end_to_end(tmp_path, capsys):
    before = _tree_digest(BASELINE)
    cache, wd = str(tmp_path / "cache"), str(tmp_path / "work")
    drv = _script("torch_run_baseline_1m")
    out = drv.main(["--n_base", "3000", "--n_train", "600", "--n_eval",
                    "256", "--Ls", "10,50,100", "--cache_dir", cache,
                    "--workdir", wd] + CPU)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    _assert_result(out)
    assert [r["L_pq"] for r in out["rows"]] == [10, 50, 100]
    assert out["rows"][-1]["recall"] > 0.9 and out["build_secs"] > 0
    assert out["binary"] == "baseline/bench_reference"
    assert out["threads"] == 1 and out["nproc"] == os.cpu_count()

    bt = drv.bt
    key = bt.world_key(3000, 600)
    base, train = _npz(cache, key + "_data")
    (eval_q,) = _npz(cache, f"{key}_evalw256")
    gt_i, gt_d = _npz(cache, f"torch_{key}_gtw256")
    (knn,) = _npz(cache, f"torch_{key}_knn")
    _assert_exports_equal_jax(wd, drv.NAMES, {
        "base": base, "train": train, "knn": knn, "eval": eval_q,
        "gt": gt_i}, tmp_path)
    _assert_gt_equals_jax(gt_i, gt_d, eval_q, base)
    jd, ji = j_exact_knn(train, base, k=bt.M_SQ, metric="ip",
                         query_batch=8192, base_tile=131072, approx=True)
    _assert_ids_up_to_ties(knn, ji, jd)

    # a second run reuses the reference index and its build time
    index_p = os.path.join(wd, "ref1m.index")
    mtime = os.stat(index_p).st_mtime_ns
    again = drv.main(["--n_base", "3000", "--n_train", "600", "--n_eval",
                      "256", "--Ls", "50", "--cache_dir", cache,
                      "--workdir", wd] + CPU)
    assert os.stat(index_p).st_mtime_ns == mtime
    assert again["build_secs"] == out["build_secs"]
    assert again["rows"][0]["recall"] == out["rows"][1]["recall"]
    assert _tree_digest(BASELINE) == before


def test_run_baseline_4m_end_to_end(tmp_path, capsys):
    before = _tree_digest(BASELINE)
    cache = str(tmp_path / "cache")
    drv = _script("torch_run_baseline_4m")
    tiny = ["--n_base", "3000", "--n_train", "600", "--n_eval", "256",
            "--dim", "32", "--cache_dir", cache]
    assert drv.main(tiny + ["--prep-only"] + CPU) == {}
    wd = os.path.join(cache, "baseline_4m")
    assert sorted(os.listdir(wd)) == sorted(drv.NAMES.values())
    assert capsys.readouterr().out == ""
    out = drv.main(tiny + ["--Ls", "10,50"] + CPU)
    _assert_result(out)
    assert out["scale"] == 3000 and out["build_secs"] > 0

    key = "torch_t2i4m_v3_3000_32"
    base, train, eval_q = _npz(cache, f"{key}_all600_256")
    gt_i, gt_d = _npz(cache, f"{key}_graph600_gt256")
    (knn,) = _npz(cache, f"{key}_graph600_knn")
    assert knn.dtype == np.int32 and knn.shape == (600, 64)
    _assert_exports_equal_jax(wd, drv.NAMES, {
        "base": base, "train": train, "knn": knn, "eval": eval_q,
        "gt": gt_i}, tmp_path)
    _assert_gt_equals_jax(gt_i, gt_d, eval_q, base)
    # torch_bench_4m_fused.py finds the same arrays under its keys
    b4 = _script("torch_bench_4m_fused")
    assert np.array_equal(b4.make_world(3000, 600, 256, 32)[0], base)
    assert _tree_digest(BASELINE) == before


def test_calibrate_world_end_to_end(tmp_path, capsys):
    before = _tree_digest(BASELINE)
    cache = str(tmp_path / "cache")
    drv = _script("torch_calibrate_world")
    argv = ["--n_base", "3000", "--n_train", "600", "--n_eval", "256",
            "--dim", "32", "--n_concepts", "200", "--intrinsic_dim", "16",
            "--M_sq", "16", "--M_pjbp", "8", "--L_pjpq", "32", "--Ls",
            "10,20,50", "--target", "0.9", "--cache_dir", cache] + CPU
    out = drv.main(argv)
    assert json.loads(capsys.readouterr().out) == out
    assert set(out) == {"world", "scale", "rows", "crossing_L",
                        "crossing_qps", "target"}
    _assert_result(out, target=0.9)
    assert [r["L_pq"] for r in out["rows"]] == [10, 20, 50]
    assert out["rows"][-1]["recall"] > 0.9

    args = type("A", (), dict(n_base=3000, n_train=600, dim=32,
                              n_concepts=200, intrinsic_dim=16, noise=0.85,
                              seed=7))
    key = drv.world_key(args)
    base, train = _npz(cache, key + "_data")
    (eval_q,) = _npz(cache, f"{key}_evalw256")
    gt_i, gt_d = _npz(cache, f"torch_{key}_gtw256")
    (knn,) = _npz(cache, f"torch_{key}_knn16")
    wd = os.path.join(cache, "calibrate_world", key)
    _assert_exports_equal_jax(wd, drv.NAMES, {
        "base": base, "train": train, "knn": knn, "eval": eval_q,
        "gt": gt_i}, tmp_path)
    _assert_gt_equals_jax(gt_i, gt_d, eval_q, base)
    assert _tree_digest(BASELINE) == before


def test_calibrate_world_recognises_bench_v3():
    drv = _script("torch_calibrate_world")
    ap_args = dict(n_base=1_000_000, n_train=200_000, dim=128,
                   n_concepts=20_000, intrinsic_dim=48, noise=0.85, seed=7,
                   n_eval=32768)
    assert drv.is_bench_v3(type("A", (), ap_args))
    assert not drv.is_bench_v3(type("A", (), {**ap_args, "noise": 0.8}))


OUTPUT = """load meta from file: x points_num: 3000 dim: 32
L_pq,QPS,recall
10,123249.1,0.8699
50,42721.2,0.9910
1,2,3,4
"""


def test_parse_rows_and_crossing():
    rows = ref.parse_rows(OUTPUT)
    assert rows == [{"L_pq": 10, "qps": 123249.1, "recall": 0.8699},
                    {"L_pq": 50, "qps": 42721.2, "recall": 0.991}]
    assert ref.crossing(rows, 0.95) == rows[1]
    assert ref.crossing(rows, 0.8699) == rows[0]
    assert ref.crossing(rows, 0.999) is None


def test_tracked_binary_is_used_as_it_is(tmp_path):
    assert ref.reference_binary(build_dir=str(tmp_path)) == os.path.join(
        BASELINE, "bench_reference")
    assert os.listdir(tmp_path) == []


def test_missing_binary_without_sources_says_so(tmp_path):
    """A baseline directory without the binary and without the reference
    sources its Makefile names: the build fails with a message, and
    nothing is written there."""
    fake = tmp_path / "baseline"
    fake.mkdir()
    shutil.copytree(os.path.join(BASELINE, "shim"), fake / "shim")
    shutil.copy(os.path.join(BASELINE, "bench_reference.cpp"), fake)
    with open(os.path.join(BASELINE, "Makefile")) as f:
        mk = f.read()
    # the copy names a reference tree that is not there
    mk = "\n".join(f"REF := {tmp_path / 'no_reference'}"
                   if ln.startswith("REF ") else ln for ln in mk.splitlines())
    (fake / "Makefile").write_text(mk + "\n")
    before = sorted(os.listdir(fake))
    with pytest.raises(ref.ReferenceError) as e:
        ref.reference_binary(str(fake), str(tmp_path / "build"))
    assert "reference sources" in str(e.value) and e.value.code != 0
    assert sorted(os.listdir(fake)) == before


def test_a_binary_that_cannot_start_ends_with_its_code(tmp_path, capsys):
    exe = tmp_path / "bench_reference"
    exe.write_text("#!/bin/sh\nkill -ILL $$\n")
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    with pytest.raises(ref.ReferenceError) as e:
        ref.search(str(exe), {k: "x" for k in ("base", "eval", "gt")}, "i",
                   10, 1, "10")
    assert e.value.code == 128 + 4 and "SIGILL" in str(e.value)
    with pytest.raises(SystemExit) as ex:
        ref.exit_on_failure(lambda: ref.search(
            str(exe), {k: "x" for k in ("base", "eval", "gt")}, "i", 10, 1,
            "10"))
    assert ex.value.code == 132
    assert "error:" in capsys.readouterr().err


@pytest.mark.parametrize("name", NEW_SCRIPTS)
def test_script_imports_only_the_port(name):
    with open(os.path.join(SCRIPTS, name + ".py")) as f:
        src = f.read()
    assert "mysteryann_tpu_torch" in src
    for line in src.splitlines():
        words = line.split()
        if words and words[0] in ("import", "from"):
            assert words[1].split(".")[0] not in (
                "jax", "mysteryann_tpu", "bench"), line


@pytest.mark.parametrize("name", ["torch_run_baseline_1m",
                                  "torch_run_baseline_4m",
                                  "torch_calibrate_world"])
def test_script_needs_a_card_without_device_cpu(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        _script(name).main(["--cache_dir", str(tmp_path)])
    assert e.value.code == 2
