"""Port distances, multi-key sorts and exact kNN against the JAX package.

Dyadic inputs (small integers / 8) make every dot product exact in float32
whatever the summation order, so ids and distances compare bit for bit, and
the many ties they create exercise the (distance, index) tie-breaks.
Gaussian inputs compare distances within 1e-5 relative (float32 summation
order differs between XLA's CPU backend and PyTorch).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mysteryann_tpu.ops import distances as jd
from mysteryann_tpu.ops import knn as jk
from mysteryann_tpu_torch.ops import distances as td
from mysteryann_tpu_torch.ops import knn as tk
from mysteryann_tpu_torch.ops.sort import sort_multi, topk_smallest

METRICS = ["l2", "ip", "cosine"]


def _dyadic(rng, shape, lim=8):
    return (rng.integers(-lim, lim + 1, size=shape) / 8).astype(np.float32)


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_and_point_dist(metric):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((37, 24)).astype(np.float32)
    b = rng.standard_normal((53, 24)).astype(np.float32)
    if metric == "cosine":   # both packages expect pre-normalized inputs
        q = np.array(jd.normalize_rows(jnp.asarray(q)))
        b = np.array(jd.normalize_rows(jnp.asarray(b)))
    want = np.asarray(jd.pairwise_dist(jnp.asarray(q), jnp.asarray(b),
                                       metric=jd.Metric.parse(metric),
                                       precision="highest"))
    got = td.pairwise_dist(torch.from_numpy(q), torch.from_numpy(b),
                           metric=metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want_p = np.asarray(jd.point_dist(jnp.asarray(q), jnp.asarray(b[:37]),
                                      metric=jd.Metric.parse(metric)))
    got_p = td.point_dist(torch.from_numpy(q), torch.from_numpy(b[:37]),
                          metric=metric).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-5)


def test_normalize_and_prepare_vectors():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((20, 16)).astype(np.float32)
    x[3] = 0.0   # the eps clamp
    want = np.asarray(jd.normalize_rows(jnp.asarray(x)))
    got = td.prepare_vectors(x, "cosine").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert td.prepare_vectors(x, "ip").dtype == torch.float32


@pytest.mark.parametrize("num_keys", [1, 2, 3])
def test_sort_multi_matches_lax_sort(num_keys):
    rng = np.random.default_rng(num_keys)
    d = _dyadic(rng, (16, 40), lim=3)
    d[0, :4] = [0.0, -0.0, -0.0, 0.0]          # -0.0 sorts equal to 0.0
    d[1, :3] = np.inf
    ids = rng.integers(0, 6, size=(16, 40)).astype(np.int32)
    flag = rng.random((16, 40)) < 0.5
    perm = np.broadcast_to(np.arange(40, dtype=np.int32), (16, 40)).copy()
    ops = (d, ids, flag, perm)[: max(num_keys, 2) + 1]
    want = jax.lax.sort(tuple(jnp.asarray(o) for o in ops), dimension=-1,
                        num_keys=num_keys)
    got = sort_multi(tuple(torch.from_numpy(o) for o in ops), num_keys)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_topk_smallest_ties_lowest_index_first():
    rng = np.random.default_rng(4)
    x = _dyadic(rng, (32, 300), lim=2)
    neg, pos = jax.lax.top_k(-jnp.asarray(x), 20)
    vals, idx = topk_smallest(torch.from_numpy(x), 20)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))


def test_merge_topk_matches():
    rng = np.random.default_rng(6)
    bd = np.sort(_dyadic(rng, (8, 10), lim=2), axis=1)
    bi = rng.integers(0, 100, size=(8, 10)).astype(np.int32)
    t_d = _dyadic(rng, (8, 10), lim=2)
    t_i = rng.integers(100, 200, size=(8, 10)).astype(np.int32)
    want = jk._merge_topk((jnp.asarray(bd), jnp.asarray(bi)),
                          jnp.asarray(t_d), jnp.asarray(t_i), 10)
    got = tk._merge_topk((torch.from_numpy(bd), torch.from_numpy(bi)),
                         torch.from_numpy(t_d), torch.from_numpy(t_i), 10)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("base_tile", [300, 65536])
def test_exact_knn_dyadic_bit_identical(metric, base_tile):
    rng = np.random.default_rng(7)
    base = _dyadic(rng, (1000, 16), lim=4)
    q = _dyadic(rng, (70, 16), lim=4)
    jdist, jids = jk.exact_knn(q, base, k=12, metric=metric, query_batch=32,
                               base_tile=base_tile, precision="highest")
    tdist, tids = tk.exact_knn(q, base, k=12, metric=metric, query_batch=32,
                               base_tile=base_tile)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tdist, jdist)


def test_exact_knn_cosine_and_ground_truth():
    rng = np.random.default_rng(8)
    base = rng.standard_normal((800, 24)).astype(np.float32)
    q = rng.standard_normal((50, 24)).astype(np.float32)
    jdist, jids = jk.exact_knn(q, base, k=10, metric="cosine",
                               precision="highest")
    tdist, tids = tk.exact_knn(q, base, k=10, metric="cosine")
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tdist, jdist, rtol=1e-5, atol=1e-6)
    gi, gd = jk.compute_ground_truth(q, base, 10, metric="l2")
    ti, tdd = tk.compute_ground_truth(q, base, 10, metric="l2")
    assert ti.dtype == np.uint32
    np.testing.assert_array_equal(ti, gi)
    np.testing.assert_allclose(tdd, gd, rtol=1e-5, atol=1e-5)
