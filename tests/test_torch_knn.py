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
    got = td.prepare_vectors(x, "cosine", device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert td.prepare_vectors(x, "ip", device="cpu").dtype == torch.float32


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
                               base_tile=base_tile, device="cpu")
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tdist, jdist)


def test_exact_knn_cosine_and_ground_truth():
    rng = np.random.default_rng(8)
    base = rng.standard_normal((800, 24)).astype(np.float32)
    q = rng.standard_normal((50, 24)).astype(np.float32)
    jdist, jids = jk.exact_knn(q, base, k=10, metric="cosine",
                               precision="highest")
    tdist, tids = tk.exact_knn(q, base, k=10, metric="cosine", device="cpu")
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tdist, jdist, rtol=1e-5, atol=1e-6)
    gi, gd = jk.compute_ground_truth(q, base, 10, metric="l2")
    ti, tdd = tk.compute_ground_truth(q, base, 10, metric="l2", device="cpu")
    assert ti.dtype == np.uint32
    np.testing.assert_array_equal(ti, gi)
    np.testing.assert_allclose(tdd, gd, rtol=1e-5, atol=1e-5)


# -- bf16 operands, int8 scans -------------------------------------------


def _bf16_pair(rng, nq, nb, d):
    """bf16 query and base blocks as (jax arrays, torch tensors) holding
    the same values."""
    q = jnp.asarray(rng.standard_normal((nq, d)).astype(np.float32),
                    jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((nb, d)).astype(np.float32),
                    jnp.bfloat16)
    tq = torch.from_numpy(np.array(q.astype(jnp.float32))).to(torch.bfloat16)
    tb = torch.from_numpy(np.array(b.astype(jnp.float32))).to(torch.bfloat16)
    return q, b, tq, tb


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_dist_bf16_operands_f32_scores(metric):
    """bf16 × bf16 scores come out in f32, as ``preferred_element_type=
    float32`` makes them; L2 norms are formed as the compiled JAX function
    forms them (f32 products, f32 sum, one bf16 rounding). Tolerance: f32
    summation order only — 1e-6 of the largest |score| (every score is a
    128-term f32 sum bounded by it)."""
    rng = np.random.default_rng(21)
    q, b, tq, tb = _bf16_pair(rng, 64, 300, 128)
    want = np.asarray(jd.pairwise_dist(q, b, metric=jd.Metric.parse(metric)))
    got = td.pairwise_dist(tq, tb, metric=metric)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * scale)


def test_quantize_int8_bit_identical():
    rng = np.random.default_rng(22)
    x = rng.standard_normal((200, 48)).astype(np.float32) * 3
    x[5] = 0.0                                  # the 1e-30 scale floor
    x[7, 3] = x[7].max() * 0.5 + 1e-3           # rounding near .5 steps
    for jf, tf in ((jk.quantize_rows_int8, tk.quantize_rows_int8),
                   (jk.quantize_global_int8, tk.quantize_global_int8)):
        wq, ws = jf(jnp.asarray(x))
        gq, gs = tf(torch.from_numpy(x))
        assert gq.dtype == torch.int8 and gs.dtype == torch.float32
        np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def _untied(scores: np.ndarray, k: int) -> bool:
    """No two of each row's k+1 smallest scores are equal, so the top-k is
    one set in one order whatever the tie rule."""
    head = np.sort(scores, axis=1)[:, :k + 1]
    return bool(np.all(np.diff(head, axis=1) > 0))


@pytest.mark.parametrize("tile", [333, 262144])
def test_int8_global_knn_matches(tile):
    rng = np.random.default_rng(23)
    base = rng.standard_normal((1500, 64)).astype(np.float32)
    q = rng.standard_normal((40, 64)).astype(np.float32)
    b_i8, _ = jk.quantize_global_int8(jnp.asarray(base))
    q_i8, _ = jk.quantize_rows_int8(jnp.asarray(q))
    s32 = np.asarray(q_i8, np.int64) @ np.asarray(b_i8, np.int64).T
    assert _untied(-s32, 10)
    wd, wi = jk.int8_global_knn_device(q_i8, b_i8, k=10, tile=tile)
    gd, gi = tk.int8_global_knn_device(
        torch.from_numpy(np.asarray(q_i8)), torch.from_numpy(np.asarray(b_i8)),
        k=10, tile=tile)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))   # exact s32


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_int8_knn_matches(metric):
    """Row-scale int8 scan: the rescale keeps the JAX package's elementwise
    order, so IP scores are bit-identical; L2 adds ||q||² summed in another
    order — 1e-6 relative."""
    rng = np.random.default_rng(24)
    base = rng.standard_normal((1200, 48)).astype(np.float32)
    q = rng.standard_normal((30, 48)).astype(np.float32)
    b_i8, b_s = jk.quantize_rows_int8(jnp.asarray(base))
    norm = (jnp.sum(jnp.asarray(base) ** 2, axis=1) if metric == "l2"
            else None)
    m = jd.Metric.parse(metric)
    wd, wi = jk.int8_knn_device(jnp.asarray(q), b_i8, b_s, k=10, metric=m,
                                tile=500, base_norm=norm)
    t_norm = torch.from_numpy(np.asarray(norm)) if norm is not None else None
    gd, gi = tk.int8_knn_device(
        torch.from_numpy(q), torch.from_numpy(np.asarray(b_i8)),
        torch.from_numpy(np.asarray(b_s)), k=10, metric=metric, tile=500,
        base_norm=t_norm)
    wd = np.asarray(wd)
    assert np.all(np.diff(wd, axis=1) > 0)      # no score ties in the head
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    if metric == "ip":
        np.testing.assert_array_equal(gd.numpy(), wd)
    else:
        np.testing.assert_allclose(gd.numpy(), wd, rtol=1e-6)


def test_int8_knn_l2_needs_norm_and_exact_dim():
    q = torch.zeros((4, 16))
    b_i8 = torch.zeros((10, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="base_norm"):
        tk.int8_knn_device(q, b_i8, torch.ones(10), k=3, metric="l2")
    # the CPU's f32 route is exact only while int8 sums fit 24 bits
    wide = torch.zeros((4, 2048), dtype=torch.int8)
    with pytest.raises(ValueError, match="exact"):
        tk.int8_global_knn_device(wide, wide, k=2)


ENTRY_POINTS = ["prepare_vectors", "exact_knn", "FlatIndex",
                "make_scan_table"]


def _call(name, x, **kw):
    """One port entry point that places an array itself, on ``x``; returns
    the tensor it placed (numpy results for exact_knn)."""
    from mysteryann_tpu_torch.flat import FlatIndex
    from mysteryann_tpu_torch.ops.scan import make_scan_table
    if name == "prepare_vectors":
        return td.prepare_vectors(x, "ip", **kw)
    if name == "exact_knn":
        return tk.exact_knn(x, x, k=2, **kw)
    if name == "FlatIndex":
        return FlatIndex(x, "ip", **kw).base
    return make_scan_table(x, **kw)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_array_without_device_needs_a_card(name):
    """The port runs on the card unless asked: an array with no device
    goes to CUDA, and without a card the call raises, never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the array goes to it")
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        _call(name, np.ones((8, 16), np.float32))


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_array_with_device_cpu_runs_on_the_cpu(name):
    out = _call(name, np.ones((8, 16), np.float32), device="cpu")
    if isinstance(out, torch.Tensor):
        assert out.device.type == "cpu"


def test_tensor_input_keeps_its_device():
    x = torch.ones((8, 16))
    assert td.prepare_vectors(x, "ip").device == x.device
