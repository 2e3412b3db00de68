"""Port fused neighbour-block engine against the JAX package.

- Dyadic data (integers / 64): the packed table (after
  ``fused_table_from_jax`` strips the TPU row padding), the unpacked
  scores, the bitonic merge and ``_fused_beam``'s ids, dists, cmps, hops
  and history must be bit-identical; each package's own table feeds its own
  beam.
- make_cross_modal data: the recall checks of tests/test_fused.py on a
  graph the port built, and the port's recall against the JAX package's
  FusedSearcher on the same graph.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mysteryann_tpu.graph import RoarGraphIndex as JIndex
from mysteryann_tpu.graph.adjacency import PaddedGraph as JGraph
from mysteryann_tpu.graph.roargraph import _repack_changed as j_repack
from mysteryann_tpu.search import fused as jf
from mysteryann_tpu.utils.metrics import compute_recall
import mysteryann_tpu_torch as port
from mysteryann_tpu_torch.graph.roargraph import _repack_changed as t_repack
from mysteryann_tpu_torch.ops.distances import Metric
from mysteryann_tpu_torch.search import fused as tf

N, D, B = 1500, 32, 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test processes run side by side (pytest-xdist); torch's own thread
    pool on top of them oversubscribes the cores, and its parallel ops then
    wait on each other. These tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dyadic(rng, shape):
    return (rng.integers(-64, 65, size=shape) / 64).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    """Dyadic base and queries over a random adjacency (sentinel N padding,
    M=12, so the pack pads M to 16), and both packages' tables at both
    widths."""
    rng = np.random.default_rng(5)
    base, queries = _dyadic(rng, (N, D)), _dyadic(rng, (B, D))
    nb = rng.integers(0, N, size=(N, 12)).astype(np.int32)
    nb[rng.random((N, 12)) < 0.2] = N
    tables = {}
    for bits in (8, 4):
        jt, jm = jf.pack_neighbor_table(jnp.asarray(base), nb, chunk=512,
                                        bits=bits)
        tt, tm = tf.pack_neighbor_table(torch.from_numpy(base), nb,
                                        chunk=700, bits=bits)
        assert jm == tm == 16
        tables[bits] = (jt, tt)
    return base, queries, nb, tables


@pytest.mark.parametrize("bits", [8, 4])
def test_table_bit_identical(world, bits):
    base, _, nb, tables = world
    jt, tt = tables[bits]
    want = tf.fused_table_from_jax(np.asarray(jt), N, 16, D, bits,
                                   device="cpu")
    assert tt.shape == (N + 1, tf._row_bytes(16, D, bits))
    assert tt.dtype == torch.uint8
    np.testing.assert_array_equal(tt.numpy(), want.numpy())
    # the sentinel row: zero values and scales, every id invalid (N+1)
    qb = 16 * D * bits // 8
    assert not tt[N, : qb + 64].any()
    ids = tt[N, qb + 64:].contiguous().view(torch.int32)
    assert (ids == N + 1).all()
    # padded columns and sentinel neighbours carry id N+1 and scale 0
    row_ids = tt[:N, qb + 64:].contiguous().view(torch.int32).numpy()
    want_ids = np.where(nb < N, nb, N + 1)
    np.testing.assert_array_equal(row_ids[:, :12], want_ids)
    assert (row_ids[:, 12:] == N + 1).all()


def test_table_row_alignment():
    # the serving and build rows of the 1M configuration: whole 16-byte
    # words, so the gather kernel moves them as uint4
    assert tf._row_bytes(48, 128, 8) == 6528
    assert tf._row_bytes(64, 128, 4) == 4608
    for M, d, bits in ((48, 128, 8), (64, 128, 4), (16, 8, 8), (16, 16, 4)):
        assert tf._row_bytes(M, d, bits) % 128 == 0


def test_table_into_recycles_buffer(world):
    base, _, nb, tables = world
    _, tt = tables[8]
    buf = torch.zeros_like(tt)
    out, _ = tf.pack_neighbor_table(torch.from_numpy(base),
                                    torch.from_numpy(nb), into=buf, bits=8)
    assert out.data_ptr() == buf.data_ptr()
    assert torch.equal(out, tt)
    # a table of another shape is not reused
    other, _ = tf.pack_neighbor_table(torch.from_numpy(base), nb,
                                      into=torch.zeros((3, 3), dtype=torch.uint8))
    assert other.shape == tt.shape


def test_pack_validation_errors():
    with pytest.raises(ValueError, match="dim % 16"):
        tf.pack_neighbor_table(torch.zeros((64, 24)),
                               np.zeros((64, 16), np.int32), bits=4)
    with pytest.raises(ValueError, match="dim % 8"):
        tf.pack_neighbor_table(torch.zeros((64, 12)),
                               np.zeros((64, 16), np.int32), bits=8)
    with pytest.raises(ValueError, match="bits"):
        tf.pack_neighbor_table(torch.zeros((64, 32)),
                               np.zeros((64, 16), np.int32), bits=2)
    with pytest.raises(ValueError, match="rows"):
        tf.fused_table_from_jax(np.zeros((5, 8, 128), np.uint8), 5, 16, 32,
                                device="cpu")


@pytest.mark.parametrize("bits,metric", [(8, "ip"), (4, "ip"), (8, "l2"),
                                         (4, "l2")])
def test_score_packed_rows(world, bits, metric):
    """Bit-identical on dyadic data: every product of a quantized value
    with a query entry, and their sums, are exact, and each package rounds
    ``ip_q · scale`` once."""
    base, queries, _, tables = world
    jt, tt = tables[bits]
    rng = np.random.default_rng(1)
    e = 2
    cur = rng.integers(0, N + 1, size=(B * e,)).astype(np.int32)
    m = Metric.parse(metric)
    qj = jnp.asarray(queries)
    q_sq = jnp.sum(qj * qj, axis=1, keepdims=True)
    jd, ji = jf._score_packed_rows(
        qj, jnp.take(jt, jnp.asarray(cur), axis=0), jf.Metric(m.value),
        q_sq if metric == "l2" else None, B=B, F=e * 16, M=16, d=D,
        bits=bits, expand=e)
    qt = torch.from_numpy(queries)
    td, ti = tf._score_packed_rows(
        qt, tt[torch.from_numpy(cur).long()], m,
        torch.sum(qt * qt, 1, keepdim=True) if metric == "l2" else None,
        B=B, F=e * 16, M=16, d=D, bits=bits, expand=e)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_nibble_sign_extension():
    x = torch.arange(16, dtype=torch.uint8)
    want = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, -8, -7, -6, -5, -4, -3, -2,
                         -1], dtype=torch.float32)
    assert torch.equal(tf._nibbles(x), want)
    # the JAX package's (x << 4) >> 4 on int8 gives the same values
    xi = np.arange(16, dtype=np.uint8).view(np.int8)
    jv = jnp.right_shift(jnp.left_shift(jnp.asarray(xi), jnp.int8(4)),
                         jnp.int8(4))
    np.testing.assert_array_equal(np.asarray(jv).astype(np.float32),
                                  want.numpy())


def test_bitonic_merge_triple():
    rng = np.random.default_rng(4)
    Bm, L, Fn = 16, 24, 20
    P = 1 << (L + Fn - 1).bit_length()
    # a sorted pool with ties on distance, +inf padding, new entries
    # sorted descending — the layout _fused_beam builds
    pd = np.sort(rng.integers(0, 20, size=(Bm, L)).astype(np.float32), 1)
    pi = rng.permutation(1000)[: Bm * L].reshape(Bm, L).astype(np.int32)
    o = np.lexsort((pi, pd), axis=1)
    pd, pi = np.take_along_axis(pd, o, 1), np.take_along_axis(pi, o, 1)
    nd = rng.integers(0, 20, size=(Bm, Fn)).astype(np.float32)
    ni = rng.integers(1000, 2000, size=(Bm, Fn)).astype(np.int32)
    o = np.lexsort((ni, nd), axis=1)[:, ::-1]
    nd, ni = np.take_along_axis(nd, o, 1), np.take_along_axis(ni, o, 1)
    pe = rng.random((Bm, L)) < 0.5
    ne = rng.random((Bm, Fn)) < 0.5
    pad = P - L - Fn
    d = np.concatenate([pd, np.full((Bm, pad), np.inf, np.float32), nd], 1)
    i = np.concatenate([pi, np.full((Bm, pad), 5000, np.int32), ni], 1)
    e = np.concatenate([pe, np.ones((Bm, pad), bool), ne], 1)
    want = jax.jit(jf._bitonic_merge_triple, static_argnums=3)(
        jnp.asarray(d), jnp.asarray(i), jnp.asarray(e), L)
    got = tf._bitonic_merge_triple(torch.from_numpy(d), torch.from_numpy(i),
                                   torch.from_numpy(e), L)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.diff(got[0].numpy(), axis=1) >= 0).all()


def _run_beam(world, bits, seeded, **kw):
    base, queries, _, tables = world
    jt, tt = tables[bits]
    m = Metric.parse(kw.pop("metric", "ip"))
    ep = 7
    seeds = {}
    if seeded:
        rng = np.random.default_rng(8)
        sid = np.stack([rng.choice(N, 6, replace=False) for _ in range(B)])
        sid = sid.astype(np.int32)
        sd = -np.einsum("bd,bsd->bs", queries, base[sid]).astype(np.float32)
        if m == Metric.L2:
            sd = ((queries[:, None, :] - base[sid]) ** 2).sum(-1)
            sd = sd.astype(np.float32)
        seeds = dict(seed_ids=sid, seed_d=sd)
    common = dict(k=8, metric=m, max_hops=kw.pop("max_hops", 4 * 24 + 32),
                  n_base=N, M=16, d=D, bits=bits, L=kw.pop("L", 24), **kw)
    j = jf._fused_beam(
        jt, jnp.asarray(base), jnp.asarray([ep], jnp.int32),
        jnp.asarray(queries), **{k: jnp.asarray(v) for k, v in seeds.items()},
        **{**common, "metric": jf.Metric(m.value)})
    t = tf._fused_beam(
        tt, torch.from_numpy(base), torch.tensor([ep], dtype=torch.int32),
        torch.from_numpy(queries),
        **{k: torch.from_numpy(v) for k, v in seeds.items()}, **common)
    return j, t


def _assert_same(j, t):
    assert len(j) == len(t)
    for name, jv, tv in zip(("ids", "dists", "cmps", "hops", "hist"), j, t):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                      err_msg=name)


@pytest.mark.parametrize("mode,expand,exit_f,seeded,bits,H", [
    ("merge", 1, None, False, 8, 0),
    ("merge", 4, 0.5, True, 8, 72),
    ("merge", 4, None, False, 4, 72),
    ("pool", 1, 0.5, True, 8, 0),
    ("pool", 4, None, False, 8, 72),
    ("bitmask", 1, None, True, 4, 72),
    ("bitmask", 4, 0.5, False, 8, 0),
])
def test_fused_beam_identical(world, mode, expand, exit_f, seeded, bits, H):
    j, t = _run_beam(world, bits, seeded, visited_mode=mode, expand=expand,
                     exit_f=exit_f, collect_expanded=H)
    _assert_same(j, t)
    assert (t[3].numpy() > 0).all()


@pytest.mark.parametrize("mode", ["merge", "bitmask"])
def test_fused_beam_l2(world, mode):
    j, t = _run_beam(world, 8, True, metric="l2", visited_mode=mode,
                     expand=2)
    _assert_same(j, t)


def test_fused_beam_max_hops_and_rerank(world):
    j, t = _run_beam(world, 8, False, visited_mode="merge", expand=2,
                     max_hops=5, collect_expanded=16, rerank=20)
    _assert_same(j, t)
    # capped: the entry point alone in step 1, then two pops in each of
    # the 4 steps left
    assert (t[3].numpy() == 9).all()


def _split_fns(world, bits, metric, mp):
    """``fused_lockstep``'s two functions as ``mp`` row shards of the table
    and base would give them: each shard scores the picks it owns, the
    others add -0.0 (or 0 to ``id + 1``), as ``parallel.ShardedFusedSearcher``
    sums them over its ranks."""
    base, queries, _, tables = world
    table, tb, q = tables[bits][1], torch.from_numpy(base), \
        torch.from_numpy(queries)
    q_sq = torch.sum(q * q, 1, keepdim=True) if metric == Metric.L2 else None
    sn = -(-N // mp)

    def step(cur):
        nd_t = torch.full((B, cur.shape[1] * 16), -0.0)
        nb_t = torch.zeros((B, cur.shape[1] * 16), dtype=torch.int32)
        for j in range(mp):
            mine = (cur >= j * sn) & (cur < min(N, (j + 1) * sn))
            rows = table[torch.where(mine, cur, N).reshape(-1).long()]
            nd, nb = tf._score_packed_rows(
                q, rows, metric, q_sq, B=B, F=cur.shape[1] * 16, M=16, d=D,
                bits=bits, expand=cur.shape[1])
            own = mine.repeat_interleave(16, dim=1)
            nd_t = nd_t + torch.where(own, nd, -0.0)
            nb_t = nb_t + torch.where(own, nb + 1, 0)
        nb_t = nb_t - 1
        return nd_t, torch.where(nb_t >= 0, nb_t, N + 1)

    def exact(ids):
        vecs = tb[torch.clamp(ids, max=N - 1).long()]
        return tf._exact_dists(q, vecs, metric, q_sq)

    return q, step, exact


@pytest.mark.parametrize("mode,expand,seeded,bits,metric", [
    ("merge", 1, False, 8, "ip"),
    ("merge", 4, True, 4, "ip"),
    ("merge", 2, False, 8, "l2"),
    ("pool", 4, False, 8, "ip"),
    ("bitmask", 2, True, 8, "l2"),
])
def test_fused_lockstep_with_caller_rows(world, mode, expand, seeded, bits,
                                         metric):
    """The factored loop fed by row fetches from 3 shards gives the
    single-card engine's results, bit for bit (the single card's own are
    pinned against the JAX package above)."""
    _, t = _run_beam(world, bits, seeded, visited_mode=mode, expand=expand,
                     metric=metric, collect_expanded=40)
    m = Metric.parse(metric)
    q, step, exact = _split_fns(world, bits, m, mp=3)
    seeds = {}
    if seeded:
        rng = np.random.default_rng(8)
        sid = np.stack([rng.choice(N, 6, replace=False) for _ in range(B)])
        sid = torch.from_numpy(sid.astype(np.int32))
        seeds = dict(seed_ids=sid, seed_d=exact(sid))
    got = tf.fused_lockstep(
        q, torch.tensor([7], dtype=torch.int32), step, exact, k=8, L=24,
        metric=m, max_hops=4 * 24 + 32, n_base=N, M=16, bits=bits,
        visited_mode=mode, expand=expand, collect_expanded=40, **seeds)
    for name, g, w in zip(("ids", "dists", "cmps", "hops", "hist"), got, t):
        assert torch.equal(g, w), name


def test_fused_beam_validation(world):
    with pytest.raises(ValueError, match="visited_mode"):
        _run_beam(world, 8, False, visited_mode="nope")


@pytest.mark.parametrize("bits", [8, 4])
def test_repack_changed_bit_identical(bits):
    """Scatter-repacking only changed supply rows gives the table a full
    repack gives, in both packages (mirrors tests/test_fused.py)."""
    rng = np.random.default_rng(5)
    n, d, W = 512, 128, 32
    base = _dyadic(rng, (n, d))
    sup0 = rng.integers(0, n + 1, size=(n, W)).astype(np.int32)
    table, Mt = tf.pack_neighbor_table(torch.from_numpy(base),
                                       torch.from_numpy(sup0), bits=bits)
    sup1 = sup0.copy()
    changed = np.asarray([0, 3, 17, 100, n - 1], np.int32)
    sup1[changed] = rng.integers(0, n + 1, size=(changed.size, W))
    full, _ = tf.pack_neighbor_table(torch.from_numpy(base),
                                     torch.from_numpy(sup1), bits=bits)
    inc = t_repack(table.clone(), torch.from_numpy(base),
                   torch.from_numpy(sup1), changed, n, Mt, d, bits, blk=4)
    assert torch.equal(inc, full)
    # and the JAX package's incremental table, stripped of its padding
    jt, _ = jf.pack_neighbor_table(jnp.asarray(base), jnp.asarray(sup0),
                                   bits=bits)
    j_inc = j_repack(jt, jnp.asarray(base), jnp.asarray(sup1), changed, n,
                     Mt, d, bits, blk=4)
    np.testing.assert_array_equal(
        inc.numpy(),
        tf.fused_table_from_jax(np.asarray(j_inc), n, Mt, d, bits,
                                device="cpu").numpy())


# --- make_cross_modal recall (mirrors tests/test_fused.py) -----------------


@pytest.fixture(scope="module")
def built():
    base, train_q = port.make_cross_modal(4000, 1500, 48, metric="ip",
                                          seed=11)
    _, eval_q = port.make_cross_modal(10, 300, 48, metric="ip", seed=99)
    _, knn = port.exact_knn(train_q, base, k=32, metric="ip", device="cpu")
    cfg = port.BuildConfig(M_sq=32, M_pjbp=12, L_pjpq=64, metric="ip",
                           query_batch=512, search_batch=512,
                           connectivity_iters=4)
    index = port.build_roargraph(base, train_q, knn, cfg, verbose=False,
                                 device="cpu")
    _, gt = port.exact_knn(eval_q, base, k=10, metric="ip", device="cpu")
    return base, eval_q, index, gt


def test_fused_recall_close_to_f32(built):
    base, eval_q, index, gt = built
    ids_a, *_ = port.Searcher(index, base, device="cpu").search(
        eval_q, k=10, L=128, query_batch=300, visited_mode="pool")
    fs = port.FusedSearcher(index, base, device="cpu")
    ids_b, dists_b, cmps, hops = fs.search(eval_q, k=10, L=128,
                                           query_batch=300)
    ra, rb = compute_recall(ids_a, gt, 10), compute_recall(ids_b, gt, 10)
    assert rb > ra - 0.03, f"fused {rb} vs f32 {ra}"
    assert np.all(np.diff(dists_b, axis=1) >= -1e-5)  # reranked exact order
    assert np.all(cmps > 0) and np.all(hops > 0)


def test_fused_recall_matches_jax_searcher(built):
    """The JAX package's FusedSearcher on the same graph: recall within
    0.01 (the make_cross_modal floats make the einsum orders differ)."""
    base, eval_q, index, gt = built
    jidx = JIndex(graph=JGraph(neighbors=index.graph.neighbors,
                               ep=index.graph.ep), metric=jf.Metric.IP, dim=48)
    kw = dict(k=10, L=64, query_batch=300, seeds=16, expand=2)
    j_ids, *_ = jf.FusedSearcher(jidx, base, seed_sample=8).search(eval_q,
                                                                   **kw)
    t_ids, *_ = port.FusedSearcher(index, base, seed_sample=8,
                                   device="cpu").search(eval_q, **kw)
    rj, rt = compute_recall(j_ids, gt, 10), compute_recall(t_ids, gt, 10)
    assert abs(rt - rj) <= 0.01, (rt, rj)


def test_fused_seeded_search(built):
    base, eval_q, index, gt = built
    fused = port.FusedSearcher(index, base, seed_sample=8, device="cpu")
    ids, dists, *_ = fused.search(eval_q, k=10, L=64, query_batch=300,
                                  seeds=16)
    plain, *_ = fused.search(eval_q, k=10, L=64, query_batch=300)
    rs, rp = compute_recall(ids, gt, 10), compute_recall(plain, gt, 10)
    assert rs > rp - 0.02, f"seeded {rs} vs medoid {rp}"
    assert np.all(np.diff(dists, axis=1) >= -1e-5)


def test_fused_seed_validation(built):
    base, eval_q, index, _ = built
    plain = port.FusedSearcher(index, base, device="cpu")  # no sample kept
    with pytest.raises(ValueError, match="seed_sample"):
        plain.search(eval_q[:4], k=5, L=32, seeds=8)
    seeded = port.FusedSearcher(index, base, seed_sample=8, device="cpu")
    with pytest.raises(ValueError, match="seeds"):
        seeded.search(eval_q[:4], k=5, L=32, seeds=64)  # seeds > L
    with pytest.raises(ValueError, match="k"):
        plain.search(eval_q[:4], k=40, L=32)  # k > L: pool holds only L


def test_fused_early_exit_trades_hops_for_recall(built):
    base, eval_q, index, gt = built
    fused = port.FusedSearcher(index, base, seed_sample=8, device="cpu")
    full = fused.search(eval_q, k=10, L=96, query_batch=300, seeds=16)
    fast = fused.search(eval_q, k=10, L=96, query_batch=300, seeds=16,
                        exit_f=0.5)
    assert float(fast[3].mean()) < float(full[3].mean())  # fewer hops
    assert compute_recall(fast[0], gt, 10) > compute_recall(full[0], gt,
                                                            10) - 0.1


def test_fused_dists_are_exact(built):
    base, eval_q, index, _ = built
    ids, dists, *_ = port.FusedSearcher(index, base, device="cpu").search(
        eval_q[:50], k=5, L=64, query_batch=50)
    qn = eval_q[:50] / np.linalg.norm(eval_q[:50], axis=1, keepdims=True)
    bn = base / np.linalg.norm(base, axis=1, keepdims=True)
    want = -(qn[:, None, :] * bn[ids]).sum(-1)
    np.testing.assert_allclose(dists, want, rtol=1e-4, atol=1e-4)


def test_fused_int4_recall_close_to_int8(built):
    base, eval_q, index, gt = built
    f8 = port.FusedSearcher(index, base, seed_sample=8, device="cpu")
    f4 = port.FusedSearcher(index, base, seed_sample=8, bits=4, device="cpu")
    a, _, *_ = f8.search(eval_q, k=10, L=96, query_batch=300, seeds=16)
    b, db, *_ = f4.search(eval_q, k=10, L=96, query_batch=300, seeds=16)
    ra, rb = compute_recall(a, gt, 10), compute_recall(b, gt, 10)
    assert rb > ra - 0.03, f"int4 {rb} vs int8 {ra}"
    assert np.all(np.diff(db, axis=1) >= -1e-5)


def test_fused_pool_mode_matches_merge(built):
    base, eval_q, index, gt = built
    fused = port.FusedSearcher(index, base, seed_sample=8, device="cpu")
    a = fused.search(eval_q, k=10, L=96, query_batch=300, seeds=16,
                     visited_mode="merge")
    b = fused.search(eval_q, k=10, L=96, query_batch=300, seeds=16,
                     visited_mode="pool")
    assert abs(compute_recall(a[0], gt, 10)
               - compute_recall(b[0], gt, 10)) < 0.01


def test_fused_searcher_column_pad_and_max_degree(built):
    """d=20 is not 8- or 16-aligned: the searcher zero-pads columns (no
    distance changes); max_degree keeps the closest neighbours."""
    base, eval_q, index, gt = built
    b20, q20 = base[:, :20], eval_q[:, :20]
    idx20 = port.RoarGraphIndex.from_numpy(index.graph.neighbors,
                                           index.graph.ep, "ip", 20)
    for bits in (8, 4):
        fs = port.FusedSearcher(idx20, b20, bits=bits, max_degree=16,
                                device="cpu")
        assert fs.d == (24 if bits == 8 else 32) and fs.M == 16
        ids, dists, *_ = fs.search(q20[:20], k=5, L=32)
        want = -(q20[:20, None, :] * b20[ids]).sum(-1)
        np.testing.assert_allclose(dists, want, rtol=1e-5, atol=1e-5)


def test_fused_benchmark_row_and_device_out(built):
    base, eval_q, index, _ = built
    fs = port.FusedSearcher(index, base, seed_sample=8, device="cpu")
    r = fs.benchmark(eval_q, k=10, L=48, query_batch=128, seeds=16,
                     expand=2)
    assert r["ids"].shape == (300, 10) and r["ids"].dtype == np.int32
    assert r["qps"] > 0 and r["avg_hops"] > 0 and r["avg_cmps"] > 0
    out = fs.search(eval_q, k=10, L=48, query_batch=128, seeds=16, expand=2,
                    device_out=True)
    assert all(isinstance(o, torch.Tensor) for o in out)
    np.testing.assert_array_equal(out[0].numpy(), r["ids"])


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_seed_scan_tiled_equals_whole(monkeypatch, metric):
    """The tiled sample scan selects what one whole-sample block selects,
    ties included (coarse data: many equal scores across tile borders)."""
    from mysteryann_tpu_torch.ops import knn
    from mysteryann_tpu_torch.search.seeding import make_seed_sample, seed_scan
    rng = np.random.default_rng(3)
    base = torch.from_numpy((rng.integers(-2, 3, size=(6000, 16)) / 2)
                            .astype(np.float32))
    q = torch.from_numpy((rng.integers(-2, 3, size=(40, 16)) / 2)
                         .astype(np.float32))
    samp = make_seed_sample(base, 2)
    whole = seed_scan(*samp, q, n_seeds=24, metric=metric)
    monkeypatch.setattr(knn, "_CPU_BLOCK_BYTES", 40 * 48 * 300)
    tiled = seed_scan(*samp, q, n_seeds=24, metric=metric)
    for a, b in zip(whole, tiled):
        assert torch.equal(a, b)
