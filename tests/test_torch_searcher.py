"""Port Searcher and data generator against the JAX package, and the port's
import without jax.

The Searcher test loads one index file, written by the JAX package, into
both packages and searches dyadic queries (integers / 64: every distance
exact in float32), so the outputs must be identical.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mysteryann_tpu.graph import RoarGraphIndex as JIndex
from mysteryann_tpu.graph import build_roargraph as j_build
from mysteryann_tpu.io import make_cross_modal as j_make_cross_modal
from mysteryann_tpu.ops import exact_knn as j_knn
from mysteryann_tpu.ops.distances import Metric as JMetric
from mysteryann_tpu.search import Searcher as JSearcher
from mysteryann_tpu.search.seeding import make_seed_sample as j_sample
from mysteryann_tpu.search.seeding import seed_scan as j_seed_scan
from mysteryann_tpu.utils.params import BuildConfig as JConfig
import mysteryann_tpu_torch as port
from mysteryann_tpu_torch.search.seeding import make_seed_sample, seed_scan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    rng = np.random.default_rng(21)
    base = (rng.integers(-64, 65, size=(1000, 16)) / 64).astype(np.float32)
    train = (rng.integers(-64, 65, size=(300, 16)) / 64).astype(np.float32)
    queries = (rng.integers(-64, 65, size=(50, 16)) / 64).astype(np.float32)
    _, knn = j_knn(train, base, k=16, metric="ip", precision="highest")
    cfg = JConfig(M_sq=16, M_pjbp=8, L_pjpq=32, metric="ip",
                  query_batch=256, search_batch=256, connectivity_iters=2,
                  connectivity_engine="classic")
    path = str(tmp_path_factory.mktemp("index") / "proj.index")
    j_build(base, train, knn, cfg, verbose=False).save(path)
    return base, queries, JIndex.load(path), port.RoarGraphIndex.load(path)


@pytest.mark.parametrize("visited_mode,expand", [("bitmask", 1),
                                                 ("pool", 2),
                                                 ("merge", 4)])
def test_searcher_identical_on_loaded_index(loaded, visited_mode, expand):
    base, queries, j_index, t_index = loaded
    kw = dict(k=10, L=40, query_batch=16, expand=expand,
              visited_mode=visited_mode)   # 50 queries: a short last batch
    want = JSearcher(j_index, base).search(queries, **kw)
    got = port.Searcher(t_index, base, device="cpu").search(queries, **kw)
    for name, w, g in zip(("ids", "dists", "cmps", "hops"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_searcher_benchmark_row(loaded):
    base, queries, _, t_index = loaded
    row = port.Searcher(t_index, base, device="cpu").benchmark(
        queries, k=10, L=40, query_batch=32, visited_mode="pool", expand=2)
    assert row["ids"].shape == (50, 10) and row["qps"] > 0
    assert row["avg_hops"] > 0 and row["avg_cmps"] > 0
    want = JSearcher(loaded[2], base).search(queries, k=10, L=40,
                                             query_batch=32,
                                             visited_mode="pool", expand=2)
    np.testing.assert_array_equal(row["ids"], want[0])


def test_seed_scan_matches():
    rng = np.random.default_rng(5)
    base = rng.standard_normal((2000, 32)).astype(np.float32)
    q = rng.standard_normal((40, 32)).astype(np.float32)
    for metric in ("ip", "l2"):
        j_ids, j_d = j_seed_scan(*j_sample(jnp.asarray(base), 4),
                                 jnp.asarray(q), n_seeds=16,
                                 metric=JMetric.parse(metric))
        t_ids, t_d = seed_scan(*make_seed_sample(torch.from_numpy(base), 4),
                               torch.from_numpy(q), n_seeds=16,
                               metric=metric)
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), rtol=1e-5,
                                   atol=1e-5)


def test_searcher_seeded_search_runs(loaded):
    base, queries, _, t_index = loaded
    s = port.Searcher(t_index, base, seed_sample=2, device="cpu")
    ids, dists, cmps, hops = s.search(queries, k=10, L=40, seeds=8)
    assert ids.shape == (50, 10) and np.isfinite(dists).all()
    with pytest.raises(ValueError):
        port.Searcher(t_index, base, device="cpu").search(
            queries, k=10, L=40, seeds=8)


@pytest.mark.parametrize("kw", [
    dict(n_base=500, n_query=120, dim=48, seed=11),
    dict(n_base=300, n_query=64, dim=128, n_concepts=2000, intrinsic_dim=48,
         noise=0.85, seed=7, query_seed=8),
    dict(n_base=200, n_query=50, dim=32, metric="l2", seed=3),
])
def test_make_cross_modal_bit_identical(kw):
    jb, jq = j_make_cross_modal(**kw)
    tb, tq = port.make_cross_modal(**kw)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tq, jq)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import mysteryann_tpu_torch\n"
        "import mysteryann_tpu_torch.graph.roargraph\n"
        "import mysteryann_tpu_torch.search.searcher\n"
        "bad = [m for m in sys.modules if m == 'jax' and sys.modules[m]\n"
        "       or m.split('.')[0] == 'mysteryann_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
