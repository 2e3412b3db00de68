"""The port's ShardedIVF against the JAX package's, case for case.

Counterparts of tests/test_sharded_ivf.py. Each index is built once (the
port's IVFIndex on the CPU) and its parts feed three things: the JAX
package's ShardedIVF on the conftest's 8-device virtual mesh, the port's
ShardedIVF in 8 gloo ranks spawned once for the module by
``parallel.launch``, and the port's single-device IVFIndex.search.
Tolerances: f32 distances within 1e-5 and ids >= 0.99 (ties may permute);
int8 recall within 0.02 of the single-device index. The JAX probe choice
(``approx_min_k``) has its own tie order on the CPU; the port's is exact.
"""

import numpy as np
import pytest

from mysteryann_tpu.io import make_cross_modal
from mysteryann_tpu.ivf import IVFIndex as JIVF
from mysteryann_tpu.ops import exact_knn
from mysteryann_tpu.parallel import make_mesh as jmake_mesh
from mysteryann_tpu.parallel.sharded_ivf import ShardedIVF as JSharded
from mysteryann_tpu.utils.metrics import compute_recall
from mysteryann_tpu_torch.ivf import IVFIndex
from mysteryann_tpu_torch.parallel import launch

SPAWN_TIMEOUT_S = 300
K, NPROBE = 10, 32
INDEXES = {  # name -> (base scale, n_clusters, kmeans_iters, store)
    "f32": (1.0, 120, 4, "f32"),
    "int8_117": (1.0, 117, 4, "int8"),   # not divisible by mp
    "int8_a": (1.0, 120, 3, "int8"),
    "int8_b": (7.0, 120, 3, "int8"),
}


def _parts(idx) -> dict:
    return {"centroids": idx.centroids.numpy(), "blocks": idx.blocks.numpy(),
            "block_ids": idx.block_ids.numpy(), "n_base": idx.n_base,
            "metric": "ip", "gscale": idx.gscale}


@pytest.fixture(scope="module")
def world():
    base, q = make_cross_modal(20000, 512, 32, metric="ip", seed=77)
    _, gt = exact_knn(q, base, k=10, metric="ip", precision="highest")
    w = {"queries": q, "gt": gt}
    for name, (scale, nc, iters, store) in INDEXES.items():
        w[name] = _parts(IVFIndex(base * np.float32(scale), metric="ip",
                                  n_clusters=nc, kmeans_iters=iters,
                                  store=store, device="cpu"))
    return w


@pytest.fixture(scope="module")
def ranks(world):
    from torch_parallel_ranks import ranks_agree
    cases = [{"name": name, "kind": "ivf", "world": "ivf", "dp": 2,
              "mp": 4, "index": name, "opts": {"k": K, "nprobe": NPROBE}}
             for name in INDEXES]
    out = launch.run("torch_parallel_ranks:run_cases", 8,
                     ({"ivf": world}, cases), timeout=SPAWN_TIMEOUT_S)
    assert ranks_agree(out)
    return out[0]


def _jax(world, name):
    idx = JIVF.from_parts(**world[name])
    ids, d = JSharded(jmake_mesh(dp=2, mp=4), idx).search(
        world["queries"], k=K, nprobe=NPROBE)
    return ids, d


def _single(world, name):
    idx = IVFIndex.from_parts(**world[name], device="cpu")
    return idx.search(world["queries"], k=K, nprobe=NPROBE, query_batch=512)


def _ids_agree(a, b, da, db):
    """Share of equal ids, counting a swap inside a run of equal
    distances as equal (ids compared as sets where scores tie)."""
    same = a == b
    for i, j in zip(*np.nonzero(~same)):
        tie = da[i] == da[i, j]
        same[i, j] = set(a[i][tie]) == set(b[i][db[i] == db[i, j]])
    return same.mean()


def test_sharded_matches_single_device_f32(world, ranks):
    got = ranks["f32"]
    ids_1, d_1 = _single(world, "f32")
    ids_j, d_j = _jax(world, "f32")
    for ids, d in ((ids_1, d_1), (ids_j, d_j)):
        # same clusters scanned, exact f32 distances -> same curves
        np.testing.assert_allclose(got["dists"], d, rtol=1e-5, atol=1e-5)
        assert (got["ids"] == ids).mean() > 0.99   # ties may permute
    assert got["n_clusters"] == 120


def test_sharded_int8_recall_and_padding(world, ranks):
    got = ranks["int8_117"]
    assert got["n_clusters"] % 4 == 0 and got["nc_real"] == 117
    r = compute_recall(got["ids"].astype(np.int64), world["gt"], 10)
    assert r > 0.90, f"sharded int8 recall {r}"
    ids_1, d_1 = _single(world, "int8_117")
    r1 = compute_recall(ids_1.astype(np.int64), world["gt"], 10)
    assert abs(r - r1) < 0.02, (r, r1)
    ids_j, d_j = _jax(world, "int8_117")
    rj = compute_recall(ids_j.astype(np.int64), world["gt"], 10)
    assert abs(r - rj) < 0.02, (r, rj)
    # raw s32 scores tie often: ids as sets within equal scores
    assert _ids_agree(got["ids"], ids_1, got["dists"], d_1) > 0.99


def test_sharded_int8_distinct_gscales_not_cross_cached(world, ranks):
    # two same-shape int8 indexes with different global scales: scaling
    # the corpus by 7 scales IP distances by 7 (a shared compiled function
    # in the JAX package, a mixed-up scale here, would break the ratio)
    assert world["int8_a"]["gscale"] != world["int8_b"]["gscale"]
    da, db = ranks["int8_a"]["dists"], ranks["int8_b"]["dists"]
    np.testing.assert_allclose(db, da * 7.0, rtol=0.05, atol=0.05)
    _, ja = _jax(world, "int8_a")
    _, jb = _jax(world, "int8_b")
    np.testing.assert_allclose(da, ja, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(db, jb, rtol=1e-5, atol=1e-5)
