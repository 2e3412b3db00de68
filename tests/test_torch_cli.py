"""Port CLIs and file formats, end to end through their main()
entries, mirroring tests/test_cli.py at its sizes. The port's CLIs take
the card unless given ``--device cpu``, so here every call passes it
(``CPU``); the JAX CLIs run on the CPU through ``JAX_PLATFORMS=cpu``.

Files the port writes are read back by the JAX package's readers; written
from the same arrays they are byte-identical to the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

from mysteryann_tpu import io as jio
from mysteryann_tpu.cli import build_bipartite as j_build_bipartite
from mysteryann_tpu.cli import build_ivf as j_build_ivf
from mysteryann_tpu.cli import build_roargraph as j_build_roargraph
from mysteryann_tpu.cli import compute_gt as j_compute_gt
from mysteryann_tpu.cli import export_fbin as j_export_fbin
from mysteryann_tpu.cli import prepare_data as j_prepare_data
from mysteryann_tpu.cli import search_bipartite as j_search_bipartite
from mysteryann_tpu.cli import search_ivf as j_search_ivf
from mysteryann_tpu.cli import search_roargraph as j_search_roargraph
from mysteryann_tpu.ops import exact_knn as j_knn
from mysteryann_tpu_torch import io as tio
from mysteryann_tpu_torch.cli import (build_bipartite, build_ivf,
                                      build_roargraph, compute_gt,
                                      export_fbin, prepare_data,
                                      search_bipartite, search_flat,
                                      search_ivf, search_roargraph)

CPU = ["--device", "cpu"]   # the port's counterpart of JAX_PLATFORMS=cpu


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test processes run side by side (pytest-xdist); torch's own thread
    pool on top of them oversubscribes the cores, and its parallel ops then
    wait on each other. These tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_clidata")
    base, train_q = tio.make_cross_modal(1200, 800, 24, metric="ip", seed=31)
    _, eval_q = tio.make_cross_modal(10, 100, 24, metric="ip", seed=32)
    tio.write_fbin(str(d / "base.fbin"), base)
    tio.write_fbin(str(d / "train.fbin"), train_q)
    tio.write_fbin(str(d / "eval.fbin"), eval_q)
    return d


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_formats_byte_identical_and_cross_readable(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((37, 24)).astype(np.float32)
    ids = rng.integers(0, 1000, size=(37, 10)).astype(np.uint32)
    dists = rng.standard_normal((37, 10)).astype(np.float32)
    for name, t_write, j_write, args in (
            ("v.fbin", tio.write_fbin, jio.write_fbin, (x,)),
            ("v.ibin", tio.write_ibin, jio.write_ibin, (ids,)),
            ("knn.ibin", tio.write_knn_ibin, jio.write_knn_ibin, (ids,)),
            ("gt.bin", tio.write_gt_with_dist, jio.write_gt_with_dist,
             (ids, dists))):
        t_write(str(tmp_path / f"t_{name}"), *args)
        j_write(str(tmp_path / f"j_{name}"), *args)
        assert _bytes(tmp_path / f"t_{name}") == _bytes(tmp_path / f"j_{name}")
    np.testing.assert_array_equal(jio.read_fbin(str(tmp_path / "t_v.fbin")), x)
    np.testing.assert_array_equal(jio.read_ibin(str(tmp_path / "t_v.ibin")),
                                  ids)
    got_i, got_d = jio.read_gt_with_dist(str(tmp_path / "t_gt.bin"))
    np.testing.assert_array_equal(got_i, ids)
    np.testing.assert_array_equal(got_d, dists)
    assert tio.read_meta(str(tmp_path / "j_v.fbin")) == (37, 24)
    np.testing.assert_array_equal(
        tio.read_knn_ibin(str(tmp_path / "j_knn.ibin"), expected_k=10), ids)
    np.testing.assert_array_equal(tio.data_align(x), jio.data_align(x))


def test_format_size_checks(tmp_path):
    p = str(tmp_path / "trunc.fbin")
    tio.write_fbin(p, np.ones((4, 8), np.float32))
    with open(p, "r+b") as f:
        f.truncate(8 + 4 * 8 * 4 - 4)
    with pytest.raises(ValueError, match="header"):
        tio.read_fbin(p)
    k = str(tmp_path / "k.ibin")
    tio.write_knn_ibin(k, np.zeros((3, 4), np.uint32))
    with pytest.raises(ValueError, match="M_sq"):
        tio.read_knn_ibin(k, expected_k=8)
    with pytest.raises(ValueError, match="2-D"):
        tio.write_fbin(p, np.ones(3, np.float32))


def test_compute_gt_cli(data_dir):
    rc = compute_gt.main([
        "--base_data_path", str(data_dir / "base.fbin"),
        "--query_path", str(data_dir / "train.fbin"),
        "--k", "16", "--dist", "ip", "--format", "knn",
        "--out_path", str(data_dir / "train_base.ibin"), *CPU,
    ])
    assert rc == 0
    knn = jio.read_knn_ibin(str(data_dir / "train_base.ibin"), expected_k=16)
    assert knn.shape == (800, 16)
    rc = compute_gt.main([
        "--base_data_path", str(data_dir / "base.fbin"),
        "--query_path", str(data_dir / "eval.fbin"),
        "--k", "10", "--dist", "ip", "--format", "gt",
        "--out_path", str(data_dir / "gt.bin"), *CPU,
    ])
    assert rc == 0
    ids, dists = jio.read_gt_with_dist(str(data_dir / "gt.bin"))
    assert ids.shape == (100, 10)
    # the JAX package's CLI on the same files: same ids, f32 dists
    # within summation order
    rc = j_compute_gt.main([
        "--base_data_path", str(data_dir / "base.fbin"),
        "--query_path", str(data_dir / "eval.fbin"),
        "--k", "10", "--dist", "ip", "--format", "gt",
        "--out_path", str(data_dir / "gt_jax.bin"),
    ])
    assert rc == 0
    j_ids, j_dists = jio.read_gt_with_dist(str(data_dir / "gt_jax.bin"))
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_allclose(dists, j_dists, rtol=1e-5, atol=1e-6)


def test_build_and_search_roargraph_cli(data_dir, capsys):
    rc = build_roargraph.main([
        "--base_data_path", str(data_dir / "base.fbin"),
        "--sampled_query_data_path", str(data_dir / "train.fbin"),
        "--learn_base_nn_path", str(data_dir / "train_base.ibin"),
        "--projection_index_save_path", str(data_dir / "proj.index"),
        "--M_sq", "16", "--M_pjbp", "8", "--L_pjpq", "32",
        "--dist", "ip", "--query_batch", "256", "--search_batch", "256",
        *CPU,
    ])
    assert rc == 0
    assert os.path.exists(str(data_dir / "proj.index.meta.json"))
    rc = search_roargraph.main([
        "--base_data_path", str(data_dir / "base.fbin"),
        "--projection_index_save_path", str(data_dir / "proj.index"),
        "--query_path", str(data_dir / "eval.fbin"),
        "--gt_path", str(data_dir / "gt.bin"),
        "--k", "10", "--L_pq", "32", "64",
        "--query_batch", "100", "--expand", "2",
        "--csv_path", str(data_dir / "out.csv"), *CPU,
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "QPS" in out and "recall" in out
    csv_text = (data_dir / "out.csv").read_text().strip().splitlines()
    assert len(csv_text) == 3  # header + 2 rows
    recall = float(csv_text[-1].split(",")[4])
    assert recall > 0.7


def test_search_roargraph_seeded(data_dir, capsys):
    rc = search_roargraph.main([
        "--base_data_path", str(data_dir / "base.fbin"),
        "--projection_index_save_path", str(data_dir / "proj.index"),
        "--query_path", str(data_dir / "eval.fbin"),
        "--gt_path", str(data_dir / "gt.bin"),
        "--k", "10", "--L_pq", "8", "64", "--query_batch", "100",
        "--seeds", "8", "--seed_sample", "4", *CPU,
    ])
    assert rc == 0
    rows = [ln for ln in capsys.readouterr().out.strip().splitlines()
            if ln.lstrip()[:2].isdigit()]
    assert len(rows) == 1                     # L=8 < k is skipped
    assert float(rows[-1].split()[4]) > 0.7


def _search_argv(data_dir, *flags):
    return ["--base_data_path", str(data_dir / "base.fbin"),
            "--projection_index_save_path", str(data_dir / "proj.index"),
            "--query_path", str(data_dir / "eval.fbin"),
            "--gt_path", str(data_dir / "gt.bin"), "--k", "10",
            "--query_batch", "100", *flags]


def _rows(out: str):
    return [ln.split() for ln in out.strip().splitlines()
            if ln.lstrip()[:2].isdigit()]


@pytest.mark.parametrize("flags", [["--engine", "fused"], ["--bits", "4"]])
def test_search_roargraph_fused_not_ported(data_dir, capsys, flags):
    """Both flags behave as in the JAX package's CLI (the port once refused
    them): ``--engine fused`` searches, and ``--bits 4`` with the classic
    engine exits 2 with the JAX CLI's message."""
    argv = _search_argv(data_dir, "--L_pq", "32", *flags)
    if flags[0] == "--engine":
        assert search_roargraph.main(argv + CPU) == 0
        rows = _rows(capsys.readouterr().out)
        assert len(rows) == 1 and float(rows[0][4]) > 0.7
        return
    for cli, extra in ((search_roargraph, CPU), (j_search_roargraph, [])):
        with pytest.raises(SystemExit) as e:
            cli.main(argv + extra)
        assert e.value.code == 2
        assert "--bits applies to --engine fused only" in \
            capsys.readouterr().err


@pytest.mark.parametrize("bits", ["8", "4"])
def test_search_roargraph_fused_seeded_matches_jax(data_dir, capsys, bits):
    """Seeded fused search through both packages' CLIs on the same index:
    recall@10 within 0.01 (float sums in another order may move a
    traversal tie)."""
    argv = _search_argv(data_dir, "--engine", "fused", "--bits", bits,
                        "--seeds", "16", "--seed_sample", "4", "--expand",
                        "2", "--L_pq", "48")
    assert search_roargraph.main(argv + CPU) == 0
    t_rows = _rows(capsys.readouterr().out)
    assert j_search_roargraph.main(argv) == 0
    j_rows = _rows(capsys.readouterr().out)
    assert len(t_rows) == len(j_rows) == 1
    t_rec, j_rec = float(t_rows[0][4]), float(j_rows[0][4])
    assert t_rec > 0.8 and abs(t_rec - j_rec) <= 0.01, (t_rec, j_rec)


def test_build_roargraph_cli_default_engine_matches_jax(tmp_path):
    """With no engine flag both build CLIs resolve "auto" alike (fused at
    this size) and, on dyadic data, save the same index bytes."""
    rng = np.random.default_rng(6)
    base = (rng.integers(-64, 65, size=(1200, 24)) / 64).astype(np.float32)
    train = (rng.integers(-64, 65, size=(500, 24)) / 64).astype(np.float32)
    _, knn = j_knn(train, base, k=16, metric="ip", precision="highest")
    tio.write_fbin(str(tmp_path / "base.fbin"), base)
    tio.write_fbin(str(tmp_path / "train.fbin"), train)
    tio.write_knn_ibin(str(tmp_path / "knn.ibin"), knn.astype(np.uint32))
    for name, cli, extra in (("port", build_roargraph, CPU),
                             ("jax", j_build_roargraph, [])):
        assert cli.main([
            "--base_data_path", str(tmp_path / "base.fbin"),
            "--sampled_query_data_path", str(tmp_path / "train.fbin"),
            "--learn_base_nn_path", str(tmp_path / "knn.ibin"),
            "--projection_index_save_path", str(tmp_path / f"{name}.index"),
            "--M_sq", "16", "--M_pjbp", "8", "--L_pjpq", "32",
            "--dist", "ip", "--query_batch", "256", "--search_batch", "256",
            *extra,
        ]) == 0
    for suffix in ("", ".meta.json"):
        assert _bytes(tmp_path / f"port.index{suffix}") == \
            _bytes(tmp_path / f"jax.index{suffix}"), suffix


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_search_flat_cli(data_dir, capsys, precision):
    csv_path = data_dir / f"flat_{precision}.csv"
    rc = search_flat.main([
        "--base_data_path", str(data_dir / "base.fbin"),
        "--query_path", str(data_dir / "eval.fbin"),
        "--gt_path", str(data_dir / "gt.bin"),
        "--k", "10", "--dist", "ip", "--query_batch", "100",
        "--tile", "512", "--precision", precision,
        "--csv_path", str(csv_path), *CPU,
    ])
    assert rc == 0
    out = capsys.readouterr().out
    recall = float(out.strip().splitlines()[-1].split()[4])
    assert recall > 0.99
    assert len(csv_path.read_text().strip().splitlines()) == 2


def _no_card(monkeypatch):
    """Make this process see no CUDA device, whatever the machine has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("cli,argv", [
    (compute_gt, ["--base_data_path", "base.fbin", "--query_path",
                  "eval.fbin", "--k", "10", "--out_path", "x.bin"]),
    (search_flat, ["--base_data_path", "base.fbin", "--query_path",
                   "eval.fbin", "--gt_path", "gt.bin"]),
    (build_bipartite, ["--base_data_path", "base.fbin",
                       "--sampled_query_data_path", "train.fbin",
                       "--bipartite_index_save_path", "b.index"]),
    (search_bipartite, ["--base_data_path", "base.fbin", "--query_path",
                        "eval.fbin", "--gt_path", "gt.bin",
                        "--bipartite_index_save_path", "b.index"]),
    (build_ivf, ["--base_data_path", "base.fbin", "--index_save_path",
                 "ivf.npz"]),
    (search_ivf, ["--index_path", "ivf.npz", "--query_path", "eval.fbin",
                  "--gt_path", "gt.bin"]),
])
def test_cli_without_a_card_exits_with_the_message(data_dir, capsys,
                                                   monkeypatch, cli, argv):
    """Without --device the CLIs take the card; with none they exit 2 and
    say how to run on the CPU, before reading any file."""
    _no_card(monkeypatch)
    with pytest.raises(SystemExit) as e:
        cli.main([str(data_dir / a) if a.endswith((".fbin", ".bin")) else a
                  for a in argv])
    assert e.value.code == 2
    assert "pass --device cpu" in capsys.readouterr().err


def test_cli_device_cpu_runs_without_a_card(data_dir, capsys, monkeypatch):
    _no_card(monkeypatch)
    assert search_flat.main([
        "--base_data_path", str(data_dir / "base.fbin"),
        "--query_path", str(data_dir / "eval.fbin"),
        "--gt_path", str(data_dir / "gt.bin"), "--k", "10",
        "--query_batch", "100", "--precision", "f32", *CPU]) == 0
    assert float(capsys.readouterr().out.strip().splitlines()[-1]
                 .split()[4]) > 0.99


def _dyadic_world(tmp_path, n=900, nq=2700, d=16, seed=8):
    """Dyadic base / train / eval .fbin files, the exact train kNN (k=12)
    and the eval ground truth, shared by both packages' CLIs."""
    rng = np.random.default_rng(seed)
    base = (rng.integers(-64, 65, size=(n, d)) / 64).astype(np.float32)
    train = (rng.integers(-64, 65, size=(nq, d)) / 64).astype(np.float32)
    evalq = (rng.integers(-64, 65, size=(64, d)) / 64).astype(np.float32)
    _, knn = j_knn(train, base, k=12, metric="ip", precision="highest")
    gt_d, gt_i = j_knn(evalq, base, k=10, metric="ip", precision="highest")
    paths = {name: str(tmp_path / f"{name}.fbin")
             for name in ("base", "train", "eval")}
    for name, arr in (("base", base), ("train", train), ("eval", evalq)):
        tio.write_fbin(paths[name], arr)
    paths["knn"] = str(tmp_path / "knn.ibin")
    tio.write_knn_ibin(paths["knn"], knn.astype(np.uint32))
    paths["gt"] = str(tmp_path / "gt.bin")
    tio.write_gt_with_dist(paths["gt"], gt_i.astype(np.uint32), gt_d)
    return paths


def _quality_cols(rows):
    """(L_pq, avg_cmps, recall, rderr, avg_hops) of each result row — all
    but QPS and latency, which are times."""
    return [(r[0], r[2], r[4], r[5], r[6]) for r in rows]


def test_bipartite_clis_match_jax(tmp_path, capsys):
    """Both packages' bipartite CLIs on the same dyadic files: the same
    index bytes, and the same recall, rderr, cmps and hops per L."""
    paths = _dyadic_world(tmp_path)
    for name, cli, extra in (("port", build_bipartite, CPU),
                             ("jax", j_build_bipartite, [])):
        assert cli.main([
            "--base_data_path", paths["base"],
            "--sampled_query_data_path", paths["train"],
            "--learn_base_nn_path", paths["knn"],
            "--bipartite_index_save_path", str(tmp_path / f"{name}.bip"),
            "--M_sq", "12", "--M_pjbp", "12", "--base_row_cap", "16",
            "--dist", "ip", *extra]) == 0
    for suffix in ("", ".meta.json"):
        assert _bytes(tmp_path / f"port.bip{suffix}") == \
            _bytes(tmp_path / f"jax.bip{suffix}"), suffix
    rows = {}
    for name, cli, extra in (("port", search_bipartite, CPU),
                             ("jax", j_search_bipartite, [])):
        capsys.readouterr()
        assert cli.main([
            "--base_data_path", paths["base"], "--query_path", paths["eval"],
            "--gt_path", paths["gt"],
            "--bipartite_index_save_path", str(tmp_path / "port.bip"),
            "--k", "10", "--L_pq", "8", "32", "64", "--query_batch", "64",
            "--seed", "2", *extra]) == 0
        rows[name] = _rows(capsys.readouterr().out)
    assert len(rows["port"]) == 2                 # L=8 < k is skipped
    assert _quality_cols(rows["port"]) == _quality_cols(rows["jax"])
    assert float(rows["port"][-1][4]) > 0.6


def test_ivf_clis_match_jax(tmp_path, capsys):
    """build_ivf in each package, then search_ivf of each index in the
    other package: the same recall, rderr and cmps per nprobe."""
    rng = np.random.default_rng(9)
    base = rng.standard_normal((3000, 24)).astype(np.float32)
    evalq = rng.standard_normal((100, 24)).astype(np.float32)
    gt_d, gt_i = j_knn(evalq, base, k=10, metric="ip", precision="highest")
    tio.write_fbin(str(tmp_path / "base.fbin"), base)
    tio.write_fbin(str(tmp_path / "eval.fbin"), evalq)
    tio.write_gt_with_dist(str(tmp_path / "gt.bin"), gt_i.astype(np.uint32),
                           gt_d)
    for name, cli, extra in (("port", build_ivf, CPU), ("jax", j_build_ivf,
                                                        [])):
        assert cli.main([
            "--base_data_path", str(tmp_path / "base.fbin"),
            "--index_save_path", str(tmp_path / f"{name}.npz"),
            "--n_clusters", "24", "--kmeans_iters", "3", "--store", "int8",
            *extra]) == 0
    rows = {}
    for name, cli, extra, index in (("port", search_ivf, CPU, "jax"),
                                    ("jax", j_search_ivf, [], "port")):
        capsys.readouterr()
        assert cli.main([
            "--index_path", str(tmp_path / f"{index}.npz"),
            "--base_data_path", str(tmp_path / "base.fbin"),
            "--query_path", str(tmp_path / "eval.fbin"),
            "--gt_path", str(tmp_path / "gt.bin"), "--k", "10",
            "--nprobe", "2", "8", "64", "--rerank", "20",
            "--query_batch", "100", *extra]) == 0
        rows[name] = [ln.split() for ln in capsys.readouterr().out
                      .splitlines() if ln.split()[:1] and
                      ln.split()[0].isdigit()]
    assert len(rows["port"]) == 2                 # nprobe 64 > 24 skipped
    assert _quality_cols(rows["port"]) == _quality_cols(rows["jax"])
    assert float(rows["port"][-1][4]) > 0.7
    # the metric is baked into the index: both CLIs refuse an override
    for cli, extra in ((search_ivf, CPU), (j_search_ivf, [])):
        with pytest.raises(SystemExit) as e:
            cli.main(["--index_path", str(tmp_path / "port.npz"),
                      "--query_path", str(tmp_path / "eval.fbin"),
                      "--gt_path", str(tmp_path / "gt.bin"),
                      "--dist", "l2", *extra])
        assert e.value.code == 2
        assert "conflicts with the index" in capsys.readouterr().err


def test_data_clis_match_jax(tmp_path, capsys):
    assert prepare_data.main(["--list"]) == 0
    port_out = capsys.readouterr().out
    assert j_prepare_data.main(["--list"]) == 0
    assert port_out == capsys.readouterr().out
    assert "t2i-10M" in port_out and "webvid-2.5M" in port_out
    rng = np.random.default_rng(4)
    npys = []
    for i, n in enumerate((5, 9)):
        npys.append(str(tmp_path / f"v{i}.npy"))
        np.save(npys[-1], rng.normal(size=(n, 8)))
    for flags in (["--pool_videos"], ["--normalize"], []):
        for name, cli in (("port", export_fbin), ("jax", j_export_fbin)):
            assert cli.main(["--npy", *npys, "--out",
                             str(tmp_path / f"{name}.fbin"), *flags]) == 0
        assert _bytes(tmp_path / "port.fbin") == \
            _bytes(tmp_path / "jax.fbin"), flags
    assert tio.read_fbin(str(tmp_path / "port.fbin")).shape == (14, 8)
