"""Port IVF index against the JAX package's ``ivf.py`` on the same inputs.

Dyadic data (integers / 64) makes the k-means sums exact in both packages,
so centroids compare bit for bit; the Gaussian world's builds match too
(same centroids, block table and block ids). Search results are compared on
Gaussian data, which has no f32 distance ties: ids exactly, distances
within rtol 1e-5 / atol 2e-5 (f32 sums in another order). The int8 scan's
raw s32 scores do tie, and the JAX package selects with ``approx_min_k``
(exact on its CPU backend, with its own tie order) while the port selects
exactly, ties to the lower index: there the distances compare exactly and
the ids as sets, below each row's k-th distance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mysteryann_tpu import ivf as jivf
from mysteryann_tpu.ops.distances import Metric as JM
from mysteryann_tpu_torch import ivf as tivf
from mysteryann_tpu_torch.ops.distances import Metric as TM

RTOL, ATOL = 1e-5, 2e-5
N, D, NC = 4000, 32, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((256, D)).astype(np.float32)
    return base, q


@pytest.fixture(scope="module")
def pair(world):
    """(JAX index, port index) per (store, metric), built once."""
    base, _ = world
    cache = {}

    def get(store, metric):
        if (store, metric) not in cache:
            kw = dict(n_clusters=NC, kmeans_iters=3, store=store,
                      keep_f32=True)
            cache[store, metric] = (
                jivf.IVFIndex(base, metric, **kw),
                tivf.IVFIndex(base, metric, device="cpu", **kw))
        return cache[store, metric]
    return get


def test_ivf_group_matches():
    rng = np.random.default_rng(1)
    B, p, nc, qmax = 200, 6, 40, 16
    top_c = rng.integers(0, nc + 1, size=(B, p)).astype(np.int32)
    top_c[:50] = rng.integers(0, 3, size=(50, p))  # hot clusters: drops
    j = jivf._ivf_group(jnp.asarray(top_c), nc, qmax)
    t = tivf._ivf_group(torch.from_numpy(top_c), nc, qmax)
    assert not np.asarray(j[2]).all()              # some probes dropped
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("iters,metric", [(1, "ip"), (3, "ip"), (2, "l2")])
def test_kmeans_dyadic_bit_identical(iters, metric):
    rng = np.random.default_rng(2)
    x = (rng.integers(-64, 65, size=(3000, 24)) / 64).astype(np.float32)
    cj = jivf._kmeans(jnp.asarray(x), 32, JM.parse(metric), iters, 7,
                      chunk=1024)
    ct = tivf._kmeans(torch.from_numpy(x), 32, TM.parse(metric), iters, 7,
                      chunk=1024)
    np.testing.assert_array_equal(ct, cj)


def test_capacity_place_matches():
    rng = np.random.default_rng(3)
    cand = rng.integers(0, 20, size=(2000, 4)).astype(np.int32)
    cand[:600, 0] = 0                               # overflow cluster 0
    for cap in (60, 100, 150):
        a = jivf._capacity_place(cand, 20, cap)
        b = tivf._capacity_place(cand, 20, cap)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    # a cap too small for everyone grows
    assert tivf._capacity_place(cand, 20, 50)[2] > 50


@pytest.mark.parametrize("store,metric", [("f32", "ip"), ("f32", "l2"),
                                          ("int8", "ip")])
def test_build_matches(pair, store, metric):
    j, t = pair(store, metric)
    assert (t.cap, t.n_clusters, t.store) == (j.cap, j.n_clusters, j.store)
    assert t.gscale == j.gscale
    np.testing.assert_array_equal(t.centroids.numpy(), np.asarray(j.centroids))
    np.testing.assert_array_equal(t.block_ids.numpy(), np.asarray(j.block_ids))
    np.testing.assert_array_equal(t.blocks.numpy(), np.asarray(j.blocks))


@pytest.mark.parametrize("store,metric,kw", [
    ("f32", "ip", dict(nprobe=4)),
    ("f32", "ip", dict(nprobe=8, rerank=20)),
    ("f32", "ip", dict(nprobe=4, grouped=False)),
    ("f32", "l2", dict(nprobe=4)),
    ("f32", "l2", dict(nprobe=4, grouped=False)),
    ("int8", "ip", dict(nprobe=4)),
    ("int8", "ip", dict(nprobe=8, rerank=20)),
])
def test_search_matches(pair, world, store, metric, kw):
    _, q = world
    j, t = pair(store, metric)
    ia, da = j.search(q, k=10, query_batch=128, **kw)
    ib, db = t.search(q, k=10, query_batch=128, **kw)
    if store == "int8" and not kw.get("rerank"):
        _assert_same_up_to_ties(ib, db, ia, da)
        return
    np.testing.assert_array_equal(ib, ia)
    np.testing.assert_allclose(db, da, rtol=RTOL, atol=ATOL)


def _assert_same_up_to_ties(ib, db, ia, da):
    """Equal distances; equal id sets among the entries strictly closer
    than each row's k-th distance (ties at the boundary may pick either)."""
    np.testing.assert_array_equal(db, da)
    for r in range(ia.shape[0]):
        inner = da[r] < da[r, -1]
        assert set(ib[r][inner]) == set(ia[r][inner]), r


def test_grouped_matches_ungrouped_and_drops_padding(pair, world):
    _, q = world
    _, t = pair("f32", "ip")
    ig, dg = t.search(q[:200], k=10, nprobe=NC, query_batch=128)
    iu, du = t.search(q[:200], k=10, nprobe=NC, query_batch=128,
                      grouped=False)
    np.testing.assert_array_equal(ig, iu)
    np.testing.assert_allclose(dg, du, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="grouped"):
        pair("int8", "ip")[1].search(q, k=10, grouped=False)


@pytest.mark.parametrize("store", ["f32", "int8"])
def test_save_in_one_load_in_other(pair, world, store, tmp_path):
    base, q = world
    j, t = pair(store, "ip")
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    t.save(pt)
    j.save(pj)
    from_t = jivf.IVFIndex.load(pt, base=base)
    from_j = tivf.IVFIndex.load(pj, base=base, device="cpu")
    assert (from_j.store, from_j.cap) == (store, t.cap)
    kw = dict(k=10, nprobe=8, query_batch=128, rerank=20)
    ia, da = from_t.search(q, **kw)
    ib, db = from_j.search(q, **kw)
    np.testing.assert_array_equal(ib, ia)
    np.testing.assert_allclose(db, da, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="rerank"):
        tivf.IVFIndex.load(pj, device="cpu").search(q, **kw)


@pytest.mark.parametrize("fill", ["scatter", "stripes"])
def test_streaming_build_matches(world, fill):
    base, q = world
    base_j, base_t = jnp.asarray(base), torch.from_numpy(base)
    kw = dict(metric="ip", n_clusters=NC, kmeans_iters=3,
              kmeans_sample=N, tile=1536)
    if fill == "stripes":
        j = jivf.build_ivf_streaming(
            lambda s, w: jax.lax.dynamic_slice_in_dim(base_j, s, w, 0), N, D,
            rows_fn=lambda i: jnp.take(base_j, i, axis=0), **kw)
        t = tivf.build_ivf_streaming(
            lambda s, w: base_t[s: s + w], N, D,
            rows_fn=lambda i: base_t[i.long()], **kw)
    else:
        j = jivf.build_ivf_streaming(
            lambda s, w: jax.lax.dynamic_slice_in_dim(base_j, s, w, 0), N, D,
            **kw)
        t = tivf.build_ivf_streaming(lambda s, w: base_t[s: s + w], N, D,
                                     **kw)
    ids = t.block_ids.numpy()
    np.testing.assert_array_equal(ids, np.asarray(j.block_ids))
    np.testing.assert_array_equal(t.blocks.numpy(), np.asarray(j.blocks))
    assert t.gscale == j.gscale
    stored = ids[ids < N]
    assert stored.size == N and np.unique(stored).size == N
    ia, da = j.search(q, k=10, nprobe=8, query_batch=128)
    ib, db = t.search(q, k=10, nprobe=8, query_batch=128)
    np.testing.assert_array_equal(ib, ia)
    np.testing.assert_allclose(db, da, rtol=RTOL, atol=ATOL)


def test_streaming_assign_cache_shared(world, tmp_path):
    """Either package reuses the other's assignment cache file."""
    base, _ = world
    base_t = torch.from_numpy(base)
    kw = dict(metric="ip", n_clusters=NC, kmeans_iters=2, kmeans_sample=N,
              tile=2048, assign_cache=str(tmp_path / "c"))
    t1 = tivf.build_ivf_streaming(lambda s, w: base_t[s: s + w], N, D, **kw)
    assert len(list(tmp_path.iterdir())) == 1
    base_j = jnp.asarray(base)
    j = jivf.build_ivf_streaming(
        lambda s, w: jax.lax.dynamic_slice_in_dim(base_j, s, w, 0), N, D,
        **kw)
    assert len(list(tmp_path.iterdir())) == 1      # a hit, no new file
    np.testing.assert_array_equal(t1.block_ids.numpy(),
                                  np.asarray(j.block_ids))


def test_benchmark_and_free(pair, world):
    _, q = world
    _, t = pair("f32", "ip")
    r = t.benchmark(q, k=5, nprobe=4, query_batch=128)
    assert r["qps"] > 0 and r["nprobe"] == 4 and r["ids"].shape == (256, 5)
    assert r["avg_cmps"] == 4 * t.cap + NC
    parts = tivf.IVFIndex.from_parts(t.centroids, t.blocks, t.block_ids,
                                     n_base=t.n_base, metric="ip")
    parts.free()
    assert parts.blocks is None and parts.centroids is None
