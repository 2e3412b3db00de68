"""Port fused score product + k-selection (``ops/score_select.py``, kernel
K3f behind it on the card) against the JAX package.

The JAX package fuses a bf16 product with an f32 result into its selection
in two places: the seed scan (``search/seeding.seed_scan``, ``approx_min_k``)
and the exact kNN of bf16 operands (``ops/knn.exact_knn_device``,
``FlatIndex(precision="bf16")``). On the CPU the port's ``score_topk`` takes
the plain version, ``score_topk_ref`` (the f32 matmul of the bf16 values,
the metric, ``topk_smallest_ref``): on dyadic data (every product and sum
exact) it equals the JAX functions bit for bit, ids and values; on Gaussian
data the ids are equal and the values within 1e-5 relative (f32 summation
order).

The kernel's launch plan (``_plan``: query tile, queue and buffer widths,
ring stages, the column split) and its routes are pure Python and pinned
here, as is the tolerance helper ``check_tolerance`` that holds the kernel
against its plain version on the card. The kernel runs only on a CUDA
device: those tests are marked ``cuda`` and skip without one; the machine
with the card has no jax, so this file imports the JAX package only inside
the tests that use it; there the ``cuda`` tests run with

    python -m pytest --noconftest -m cuda tests/test_torch_score_select.py
"""

import re

import numpy as np
import pytest
import torch

from mysteryann_tpu_torch.ops import knn as tk
from mysteryann_tpu_torch.ops import score_select as ss
from mysteryann_tpu_torch.ops.distances import squared_norms
from mysteryann_tpu_torch.ops.select import DeviceInfo
from mysteryann_tpu_torch.search import seeding
from mysteryann_tpu_torch.search.seeding import make_seed_sample, seed_scan

H100_SMS = 132


@pytest.fixture
def jax_mods():
    """(jnp, the JAX package's seeding, knn and distances modules)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from mysteryann_tpu.ops import distances as jd
    from mysteryann_tpu.ops import knn as jk
    from mysteryann_tpu.search import seeding as js
    return jnp, js, jk, jd


def _data(rng, shape, dyadic, metric):
    if dyadic:
        x = (rng.integers(-8, 9, size=shape) / 8).astype(np.float32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    if metric == "cosine" and not dyadic:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


# ------------------------- the plain version vs JAX -------------------------


@pytest.mark.parametrize("metric", ["ip", "cosine", "l2"])
@pytest.mark.parametrize("d", [32, 100, 128])
@pytest.mark.parametrize("B", [1, 40, 257])
def test_ref_matches_jax_seed_scan(jax_mods, metric, d, B):
    """The seed scan (sample n = 1,001 rows: not a multiple of 128) through
    the port's ``seed_scan``, which on the CPU is ``score_topk_ref``:
    dyadic data bit for bit (values; each id holds its value, since
    ``approx_min_k`` may pick other members of a tie), Gaussian data within
    f32 summation order."""
    jnp, js, _, jd = jax_mods
    rng = np.random.default_rng(d * 1000 + B)
    for dyadic in (True, False):
        base = _data(rng, (2001, d), dyadic, metric)
        q = _data(rng, (B, d), dyadic, metric)
        want_i, want_d = js.seed_scan(*js.make_seed_sample(jnp.asarray(base),
                                                           2),
                                      jnp.asarray(q), n_seeds=24,
                                      metric=jd.Metric.parse(metric))
        got_i, got_d = seed_scan(*make_seed_sample(torch.from_numpy(base), 2),
                                 torch.from_numpy(q), n_seeds=24,
                                 metric=metric)
        if dyadic:
            np.testing.assert_array_equal(got_d.numpy().view(np.uint32),
                                          np.asarray(want_d).view(np.uint32))
            # approx_min_k on the CPU may pick other members of an exact
            # tie: each id must hold its distance
            samp = base[::2]
            qb = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
            ip = np.einsum("bd,bkd->bk", qb.astype(np.float64),
                           samp[got_i.numpy() // 2].astype(np.float64))
            if metric == "l2":
                dist = np.maximum(
                    (q.astype(np.float64) ** 2).sum(1)[:, None] - 2 * ip
                    + (samp[got_i.numpy() // 2].astype(np.float64) ** 2
                       ).sum(-1), 0)
            else:
                dist = -ip
            np.testing.assert_array_equal(dist.astype(np.float32),
                                          got_d.numpy())
        else:
            # f32 sums in another order: ids equal wherever the JAX
            # distances are untied at 1e-5 relative
            w_d = np.asarray(want_d)
            np.testing.assert_allclose(got_d.numpy(), w_d, rtol=1e-5,
                                       atol=1e-5)
            gap = np.diff(w_d, axis=1) > 1e-5 * np.maximum(
                1.0, np.abs(w_d[:, 1:]))
            untied = np.ones_like(w_d, bool)
            untied[:, 1:] &= gap
            untied[:, :-1] &= gap
            np.testing.assert_array_equal(got_i.numpy()[untied],
                                          np.asarray(want_i)[untied])
            assert untied.mean() > 0.9


@pytest.mark.parametrize("metric", ["ip", "cosine", "l2"])
def test_ref_matches_jax_exact_knn_bf16(jax_mods, metric):
    """``score_topk_ref`` against the JAX package's ``exact_knn_device`` on
    bf16 operands (``lax.top_k`` tiles: ties to the lower index), dyadic:
    bit for bit, ids and values, at several tiles."""
    jnp, _, jk, jd = jax_mods
    rng = np.random.default_rng(9)
    base = _data(rng, (3001, 64), True, metric)
    q = _data(rng, (50, 64), True, metric)
    jb, jq = jnp.asarray(base, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16)
    want_d, want_i = jk.exact_knn_device(jq, jb, 20,
                                         metric=jd.Metric.parse(metric),
                                         tile=1024)
    tb = torch.from_numpy(base).to(torch.bfloat16)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    q_sq = t_sq = None
    if metric == "l2":
        q_sq, t_sq = squared_norms(tq).float(), squared_norms(tb).float()
    for tile in (None, 1024, 700):
        got_d, got_i = ss.score_topk_ref(tq, tb, 20, metric, q_sq, t_sq,
                                         tile=tile)
        assert got_i.dtype == torch.int64
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_d.numpy().view(np.uint32),
                                      np.asarray(want_d).view(np.uint32))


@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
def test_flat_bf16_goes_through_score_topk(jax_mods, monkeypatch, metric):
    """``FlatIndex(precision="bf16")`` reaches ``score_topk`` (with the bf16
    norms for l2) and returns the JAX ``FlatIndex``'s ids and distances."""
    from mysteryann_tpu.flat import FlatIndex as JFlat
    from mysteryann_tpu_torch.flat import FlatIndex as TFlat

    rng = np.random.default_rng(4)
    base = _data(rng, (2000, 64), False, metric)
    q = _data(rng, (70, 64), False, metric)
    calls = []
    real = ss.score_topk

    def spy(q_, t_, k, metric_, q_sq=None, t_sq=None, tile=None):
        calls.append((q_.dtype, t_.dtype, k, q_sq is not None))
        return real(q_, t_, k, metric_, q_sq, t_sq, tile)

    monkeypatch.setattr(ss, "score_topk", spy)
    want_i, want_d = JFlat(base, metric=metric, tile=512,
                           precision="bf16").search(q, k=10, query_batch=32)
    got_i, got_d = TFlat(base, metric=metric, tile=512, precision="bf16",
                         device="cpu").search(q, k=10, query_batch=32)
    # the f32 rerank's sums in another order: ids equal wherever the JAX
    # distances are untied at 1e-5 relative
    w_d = np.asarray(want_d)
    np.testing.assert_allclose(got_d, w_d, rtol=1e-5, atol=1e-6)
    gap = np.diff(w_d, axis=1) > 1e-5 * np.maximum(1.0, np.abs(w_d[:, 1:]))
    untied = np.ones_like(w_d, bool)
    untied[:, 1:] &= gap
    untied[:, :-1] &= gap
    np.testing.assert_array_equal(got_i[untied], np.asarray(want_i)[untied])
    assert untied.mean() > 0.9
    assert calls and all(c[:3] == (torch.bfloat16, torch.bfloat16, 20)
                         for c in calls)
    assert all(c[3] == (metric == "l2") for c in calls)


def test_f32_knn_keeps_the_unfused_path(monkeypatch):
    """f32 operands (the exact kNN, GT, flat f32) never reach the fused
    call, nor do bf16 calls with k past the table."""
    monkeypatch.setattr(ss, "score_topk", None)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((300, 16)).astype(np.float32))
    d, i = tk.exact_knn_device(x[:10], x, 5)
    assert i.dtype == torch.int32 and i.shape == (10, 5)
    d, i = tk.exact_knn_device(x[:10].to(torch.bfloat16),
                               x[:4].to(torch.bfloat16), 5)
    assert i.shape == (10, 5) and (i[:, 4] == -1).all()


def test_seed_scan_calls_score_topk(monkeypatch):
    """``seed_scan`` is one ``score_topk`` call on the bf16 query, with the
    unrounded query's norm for l2."""
    calls = []
    real = ss.score_topk

    def spy(q_, t_, k, metric_, q_sq=None, t_sq=None, tile=None):
        calls.append((q_.dtype, k, q_sq))
        return real(q_, t_, k, metric_, q_sq, t_sq, tile)

    monkeypatch.setattr(seeding, "score_topk", spy)
    rng = np.random.default_rng(1)
    base = torch.from_numpy(rng.standard_normal((900, 24)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((7, 24)).astype(np.float32))
    ids, _ = seed_scan(*make_seed_sample(base, 3), q, n_seeds=9, metric="l2")
    assert ids.shape == (7, 9) and ids.dtype == torch.int32
    (dt, k, q_sq), = calls
    assert dt == torch.bfloat16 and k == 9
    assert torch.equal(q_sq, torch.sum(q * q, dim=1))


# ------------------------------- the plan --------------------------------


@pytest.mark.parametrize("B,n,d,k,want", [
    # (consumers, queue, stages, tiles, splits, split_cols)
    (8192, 500_000, 128, 48, (2, 64, 5, 64, 2, 250_112)),    # the seed scan
    (8192, 1_000_000, 128, 20, (2, 32, 7, 64, 2, 500_096)),  # flat bf16
    # the T2I-10M flat cell: 8 stages, two whole steps of a 16-column tail
    # and 24-key buffers
    (8192, 10_000_000, 200, 20, (2, 32, 8, 64, 2, 5_000_064)),
    (1, 500_000, 128, 48, (1, 64, 8, 1, 131, 3840)),         # B = 1
    (64, 500_000, 128, 48, (1, 64, 8, 1, 131, 3840)),
    (65, 500_000, 128, 48, (2, 64, 5, 1, 131, 3840)),
    (8192, 250_000, 128, 16, (2, 32, 7, 64, 2, 125_056)),    # a build batch
    (2048, 500_000, 128, 40, (2, 64, 5, 16, 8, 62_592)),
    # a queue of 256 keys: 64 queries a block
    (8192, 500_000, 128, 129, (1, 256, 3, 128, 1, 500_096)),
    (8192, 500_000, 128, 256, (1, 256, 3, 128, 1, 500_096)),
    (8192, 500_000, 512, 48, (1, 64, 6, 128, 1, 500_096)),   # wide rows
    (300, 2000, 100, 10, (2, 32, 7, 3, 16, 128)),
    (4, 1000, 32, 256, (1, 256, 4, 1, 2, 512)),   # the last share >= k
    # tables under a step, batches under a tile, d under a box
    (3, 1, 128, 1, (1, 32, 8, 1, 1, 128)),
    (40, 50, 32, 48, (1, 64, 8, 1, 1, 128)),
    (1, 127, 100, 100, (1, 128, 7, 1, 1, 128)),
    (130, 127, 16, 127, (2, 128, 2, 2, 1, 128)),
])
def test_plan(B, n, d, k, want):
    p = ss._plan(B, n, d, k, H100_SMS)
    assert p[:6] == want
    chunks = -(-d // ss.KC)
    assert p.smem == ss.smem_bytes(chunks, p.consumers, p.queue, p.stages,
                                   p.tail_cols, p.buf)
    assert p.smem <= ss.SMEM_LIMIT and p.queue >= k
    # a narrow last box holds the last dimensions; the ring whole steps
    assert d - ss.KC * (chunks - 1) <= p.tail_cols
    assert p.tail_cols == ss.KC or p.stages % chunks == 0
    assert p.prefilter == (p.queue <= ss.PREFILTER_QUEUE and
                           p.split_cols // ss.NT >= ss.PREFILTER_STEPS)
    # a narrower box or buffer only under the pre-filter, and only where the
    # full ones leave a shallower ring
    full = min(ss.MAX_STAGES, (ss.SMEM_LIMIT - ss.smem_bytes(
        chunks, p.consumers, p.queue, 0)) // ss.T_BYTES)
    assert p.stages >= full
    assert (p.tail_cols, p.buf) == (ss.KC, ss.BUF) or (
        p.prefilter and p.stages > full)
    assert p.split_cols % ss.NT == 0
    assert (p.splits - 1) * p.split_cols < n <= p.splits * p.split_cols
    assert n - (p.splits - 1) * p.split_cols >= k
    assert p.tiles * 64 * p.consumers >= B


@pytest.mark.parametrize("B,n,d,k,consumers", [
    (8192, 10_000_000, 200, 20, 2),      # two consumer warpgroups
    (8192, 500_000, 128, 48, 2),
    (65, 500_000, 128, 48, 2),
    (64, 500_000, 128, 48, 1),           # B <= 64: one warpgroup
    (1, 500_000, 200, 20, 1),
    (8192, 500_000, 128, 129, 1),        # a queue of 256
    (8192, 500_000, 512, 48, 1),         # rows too wide for two
    (8192, 500_000, 512, 20, 1),         # as with 32-key buffers
    (8192, 500_000, 96, 100, 1),         # as with a full last box
    (8192, 500_000, 256, 48, 2),
])
def test_plan_warpgroups(B, n, d, k, consumers):
    """Two consumer warpgroups where two stages of 128 queries fit with
    full boxes and 32-key buffers, as without the pre-filter; the narrower
    last box and 24-key buffers of long shares only deepen the ring (at d =
    512, k 20, two warpgroups would fit two stages with 24-key buffers,
    against one warpgroup's 7: the plan keeps one). No option chooses."""
    p = ss._plan(B, n, d, k, H100_SMS)
    assert p.consumers == consumers


@pytest.mark.parametrize("d,kslices,tail_cols", [
    (200, 13, 16), (128, 8, 64), (100, 8, 64), (129, 12, 64), (16, 4, 64),
    (32, 4, 64), (160, 12, 64), (64, 4, 64), (1, 4, 64), (96, 6, 32),
])
def test_plan_kslices(d, kslices, tail_cols):
    """On a long share (the pre-filter's) the last chunk's box is 16 or 32
    columns wide where its k-slices fit one and the ring of whole steps is
    deeper for it, and a warpgroup then issues only the ceil(tail / 16)
    k-slices of it that hold dimensions; a full last box is issued whole (at
    d = 129 and 160 whole steps hold 6 stages, a full box as many; at d <=
    64 a full box already holds 8). A short share issues every box whole."""
    p = ss._plan(8192, 1_000_000, d, 20, H100_SMS)
    assert p.prefilter
    chunks = -(-d // ss.KC)
    assert p.kslices == kslices
    assert p.tail_cols == tail_cols
    if tail_cols < ss.KC:
        assert kslices == 4 * (chunks - 1) + ss.tail_slices(d)
    else:
        assert kslices == 4 * chunks
    short = ss._plan(8192, 100_000, d, 20, H100_SMS)
    assert not short.prefilter and short.tail_cols == ss.KC
    assert short.kslices == 4 * chunks


def test_plan_t2i_ring_holds_two_steps():
    """At the flat cell's shape the ring holds two whole steps, from the
    16-column tail and 24-key buffers; 32-key buffers leave one whole step
    of narrow boxes or 5 full stages (1.25 steps), the base ring."""
    p = ss._plan(8192, 10_000_000, 200, 20, H100_SMS)
    assert (p.stages, p.tail_cols, p.buf) == (2 * 4, 16, ss.SMALL_BUF)
    assert ss.smem_bytes(4, 2, 32, 8, 16, 24) == p.smem <= ss.SMEM_LIMIT
    assert ss.smem_bytes(4, 2, 32, 8, 16, 32) > ss.SMEM_LIMIT
    assert ss.smem_bytes(4, 2, 32, 5) <= ss.SMEM_LIMIT
    assert ss.smem_bytes(4, 2, 32, 6) > ss.SMEM_LIMIT


@pytest.mark.parametrize("B,n,d,k,prefilter", [
    (8192, 10_000_000, 200, 20, True),   # 39,063 steps a share
    (8192, 1_000_000, 128, 20, True),    # 3,907
    (8192, 500_000, 128, 48, False),     # 1,954: the seed scan
    (8192, 250_000, 128, 16, False),     # 977: a build batch
    (1, 500_000, 128, 48, False),        # 30
    (8192, 10_000_000, 200, 64, True),   # a queue of 64
    (8192, 10_000_000, 200, 100, False),  # a queue of 128: the base loop
])
def test_plan_prefilter(B, n, d, k, prefilter):
    """The per-step maximum ends quiet ip steps where a block's share is
    long enough for its queues to settle, at queues up to 64."""
    assert ss._plan(B, n, d, k, H100_SMS).prefilter == prefilter


def test_plan_takes_the_kernels_instances():
    """Every plan over a grid of shapes maps to one of the kernel's ten
    instances, each of them is reached, and a plan without the pre-filter
    is the base loop's (full boxes, 32-key buffers)."""
    src = open(ss.SOURCE).read()
    body = src[src.index("int launch_plan("):]
    body = body[:body.index("\n}\n")]
    made = set(re.findall(r"launch<(\d), (\d), (BUF|SMALL_BUF), (true|false)>",
                          body))
    assert len(made) == 10
    reached = set()
    for B in (1, 64, 65, 1024, 8192, 20_000):
        for n in (1000, 250_000, 600_011, 10_000_000):
            for d in (16, 32, 96, 100, 128, 200, 512):
                for k in (10, 20, 48, 64, 100, 200):
                    p = ss._plan(B, n, d, k, H100_SMS)
                    if p is None:
                        continue
                    if not p.prefilter:
                        assert (p.tail_cols, p.buf) == (ss.KC, ss.BUF)
                    tailk = 4 if p.tail_cols == ss.KC else p.tail_cols // 16
                    buf = "SMALL_BUF" if p.buf == ss.SMALL_BUF else "BUF"
                    inst = (str(p.queue // 32), str(tailk), buf,
                            "true" if p.prefilter else "false")
                    assert inst in made, (B, n, d, k, p)
                    reached.add(inst)
    assert reached == made


def test_plan_split_fills_the_card():
    """Small batches split the columns so about one block an SM runs."""
    for B in (1, 100, 1000, 4096, 8192, 16384):
        p = ss._plan(B, 500_000, 128, 48, H100_SMS)
        assert p.tiles * p.splits <= max(H100_SMS, p.tiles)
        assert p.tiles * p.splits > H100_SMS // 2 or p.tiles >= H100_SMS


@pytest.mark.parametrize("B,n,d,k", [
    (8192, 500_000, 128, 257),     # past the warp queue: unfused
    (8192, 100, 128, 101),         # k past the table
    (8192, 100, 128, 0),
    (10, 1 << 31, 128, 10),        # past TMA's int32 rows
    (10, 10_000, 8192, 256),       # no room for the query tile
    (10, 10_000, 1024, 256),
])
def test_plan_refuses(B, n, d, k):
    assert ss._plan(B, n, d, k, H100_SMS) is None


def test_plan_last_share_holds_k():
    p = ss._plan(1, 5000, 128, 200, H100_SMS)
    assert n_last(p, 5000) >= 200 and p.splits > 1


def n_last(p, n):
    return n - (p.splits - 1) * p.split_cols


def test_routes():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert ss._route(cpu, None) == "plain"
    assert ss._route(cpu, ss._plan(8192, 500_000, 128, 48, 132)) == "plain"
    assert ss._route(cuda, ss._plan(8192, 500_000, 128, 48, 132)) == "k3f"
    assert ss._route(cuda, ss._plan(8192, 500_000, 128, 300, 132)) == \
        "unfused"
    with pytest.raises(ValueError, match="no score-select kernel"):
        ss._route(torch.device("meta"), None)


def test_cpu_route_is_the_plain_version(monkeypatch):
    """A CPU tensor takes ``score_topk_ref``; the kernel's wrapper and plan
    are never reached."""
    monkeypatch.setattr(ss, "_score_topk_cuda", None)
    monkeypatch.setattr(ss, "plan_for", None)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((400, 16)).astype(np.float32))
    qb, tb = q.to(torch.bfloat16), t.to(torch.bfloat16)
    for k in (1, 48, 256, 300, 400):
        got = ss.score_topk(qb, tb, k, "ip")
        want = ss.score_topk_ref(qb, tb, k, "ip")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_argument_checks():
    z = torch.zeros((4, 16), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        ss.score_topk(z.float(), z, 2, "ip")
    with pytest.raises(ValueError, match="misfit"):
        ss.score_topk(z, z[:, :8], 2, "ip")
    with pytest.raises(ValueError, match="l2 needs"):
        ss.score_topk(z, z, 2, "l2")


def test_padded_dim():
    assert [ss.padded_dim(d) for d in (1, 32, 64, 100, 128, 129, 200)] == \
        [8, 32, 64, 104, 128, 136, 200]


@pytest.mark.parametrize("d", [1, 32, 100, 128, 129])
def test_aligned_rows(d):
    """A table whose rows start 16 bytes apart is kept as it is; any other
    becomes a [:, :d] view of a zero-padded copy, equal in value."""
    x = torch.arange(7 * d, dtype=torch.float32).reshape(7, d).to(
        torch.bfloat16)
    a = ss.aligned_rows(x)
    assert torch.equal(a, x) and a.shape == x.shape
    assert a.stride(0) == ss.padded_dim(d) and a.stride(1) == 1
    assert (a.data_ptr() == x.data_ptr()) == (d % 8 == 0)
    if d % 8:
        full = torch.empty(0, dtype=a.dtype).set_(
            a.untyped_storage(), 0, (7, ss.padded_dim(d)))
        assert not full[:, d:].any()
    assert ss.aligned_rows(a) is a


def test_tables_are_made_aligned():
    """The seed sample and ``FlatIndex``'s bf16 copy are made once with
    rows 16 bytes apart, so a fused call copies no table."""
    from mysteryann_tpu_torch.flat import FlatIndex as TFlat
    rng = np.random.default_rng(6)
    base = torch.from_numpy(rng.standard_normal((300, 100)).astype(
        np.float32))
    samp, _, _ = make_seed_sample(base, 3)
    assert ss._is_aligned(samp) and samp.stride(0) == 104
    assert torch.equal(samp, base[::3].to(torch.bfloat16))
    flat = TFlat(base.numpy(), metric="ip", precision="bf16", device="cpu")
    assert ss._is_aligned(flat.base_bf16)
    assert torch.equal(flat.base_bf16, flat.base.to(torch.bfloat16))


def test_unfused_route_is_counted(monkeypatch):
    """A call that takes the unfused route adds one to
    ``unfused_launches`` and none to ``launches``."""
    monkeypatch.setattr(ss, "_route", lambda device, plan: "unfused")
    ss.reset_launches()
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((400, 16)).astype(np.float32))
    qb, tb = q.to(torch.bfloat16), t.to(torch.bfloat16)
    got = ss.score_topk(qb, tb, 12, "ip")
    want = ss.score_topk_ref(qb, tb, 12, "ip")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ss.unfused_launches == 1 and ss.launches == 0


def test_source_agrees_with_the_wrapper():
    """csrc/score_select.cu's argument layout and constants are the
    wrapper's."""
    src = open(ss.SOURCE).read()
    fields = re.search(r"enum Arg \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"^\s*(k\w+)", fields, re.M)
    assert names[-1] == "kArgs" and len(names) - 1 == 23
    assert len(ss._pack_args(*range(23))) == 23 * 8
    assert names[8:11] == ["kD", "kLdQ", "kLdT"]
    assert names[18:23] == ["kStages", "kTailCols", "kBuf", "kPrefilter",
                            "kStream"]
    assert f"NT = {ss.NT};" in src and "KC = kBoxCols;" in src
    assert f"MAX_STAGES = {ss.MAX_STAGES};" in src
    assert f"SMEM_LIMIT = {ss.SMEM_LIMIT};" in src
    assert "SMEM_SLACK = 1024 + 8 * (2 * MAX_STAGES + 1);" in src
    assert ss.SMEM_SLACK == 1024 + 8 * (2 * ss.MAX_STAGES + 1)
    assert f"BUF = {ss.BUF};" in src and f"SMALL_BUF = {ss.SMALL_BUF};" in src
    # the box, the buffer and the pre-filter are an instance's: no branch
    # around a wgmma, and no pre-filter block in the base loop
    assert "template <int KPL, int TAILK, int BUF, bool PRE>" in src
    assert all(f"launch<{q}, 4, BUF, false>" in src for q in (1, 2, 4, 8))
    assert all(f"launch<1, {t}, SMALL_BUF, true>" in src for t in (1, 2))
    assert "STAGE_WARP = 32 * STAGE + 64;" in src and "STAGE = 4;" in src
    assert ss.STAGE_WARP == 32 * 4 + 64
    assert '#include "k3_queue.cuh"' in src
    hdr = open(ss.SOURCE.replace("score_select.cu", "hopper_tma.cuh")).read()
    assert f"kBoxCols = {ss.KC};" in hdr


def test_reset_launches():
    ss.launches, ss.unfused_launches = 4, 3
    assert ss.reset_launches() == 4
    assert ss.launches == 0 and ss.unfused_launches == 0


# ------------------------------ the tolerance ------------------------------


def _tol_case(metric, B=60, n=900, d=40, k=16, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    qb, tb = q.to(torch.bfloat16), t.to(torch.bfloat16)
    q_sq = t_sq = None
    if metric == "l2":
        q_sq, t_sq = torch.sum(q * q, 1), torch.sum(t * t, 1)
    want = ss.score_topk_ref(qb, tb, k, metric, q_sq, t_sq)
    return qb, tb, q_sq, t_sq, want


def _eps(qb, tb, cols, metric, q_sq, t_sq):
    return ss._exact(qb, tb, cols, ss.Metric.parse(metric), q_sq, t_sq)[1]


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_tolerance_accepts_the_plain_version(metric):
    qb, tb, q_sq, t_sq, want = _tol_case(metric)
    r = ss.check_tolerance(qb, tb, metric, want, want, q_sq, t_sq, rows=17)
    assert r["ok"], r["why"]
    assert r["max_abs_err"] == 0.0 and r["ids_differ"] == 0
    assert 0 < r["max_err_over_eps"] < 1


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_tolerance_accepts_values_moved_within_eps(metric):
    qb, tb, q_sq, t_sq, want = _tol_case(metric)
    eps = _eps(qb, tb, want[1], metric, q_sq, t_sq)
    ex = ss._exact(qb, tb, want[1], ss.Metric.parse(metric), q_sq, t_sq)[0]
    # half an ε off the f64 distance, in f32: still within ε
    moved = (ex + 0.5 * eps * torch.where(torch.arange(16) % 2 == 0, 1, -1)
             ).float()
    r = ss.check_tolerance(qb, tb, metric, (moved, want[1]), want, q_sq,
                           t_sq)
    # the moved values may reorder near-equal neighbours: only the value
    # bound is asserted here
    assert "farther than" not in r["why"]
    assert r["max_abs_err"] > 0


def test_tolerance_refuses_a_value_off_by_more_than_eps():
    qb, tb, q_sq, t_sq, want = _tol_case("ip")
    eps = _eps(qb, tb, want[1], "ip", q_sq, t_sq)
    bad = want[0].clone()
    bad[3, 5] += float(4 * eps[3, 5]) + 1e-6
    r = ss.check_tolerance(qb, tb, "ip", (bad, want[1]), want)
    assert not r["ok"] and "farther than" in r["why"]


def test_tolerance_accepts_a_swap_at_a_near_tie():
    """A column that ties with the plain k-th one may take its place."""
    qb, tb, _, _, _ = _tol_case("ip", B=1, n=50, d=8, k=5)
    tb = tb.clone()
    tb[7] = tb[3]                       # columns 3 and 7 score the same
    full = ss.score_topk_ref(qb, tb, 50, "ip")
    k = full[1][0].tolist().index(3) + 1      # 3 the k-th, 7 just past it
    assert int(full[1][0, k]) == 7
    want = (full[0][:, :k], full[1][:, :k])
    ids = want[1].clone()
    ids[0, k - 1] = 7
    r = ss.check_tolerance(qb, tb, "ip", (want[0], ids), want)
    assert r["ok"], r["why"]
    assert r["ids_differ"] == 2


def test_tolerance_refuses_a_far_column():
    qb, tb, q_sq, t_sq, want = _tol_case("ip", k=10)
    ids = want[1].clone()
    ids[0, 9] = int(ss.score_topk_ref(qb[:1], tb, 900, "ip")[1][0, -1])
    vals = want[0].clone()
    ex = ss._exact(qb, tb, ids, ss.Metric.IP, None, None)[0]
    vals[0, 9] = float(ex[0, 9])
    r = ss.check_tolerance(qb, tb, "ip", (vals, ids), want)
    assert not r["ok"]


def test_tolerance_refuses_a_row_out_of_order():
    qb, tb, q_sq, t_sq, want = _tol_case("ip")
    vals, ids = want[0].clone(), want[1].clone()
    vals[2, [4, 5]] = vals[2, [5, 4]]
    ids[2, [4, 5]] = ids[2, [5, 4]]
    r = ss.check_tolerance(qb, tb, "ip", (vals, ids), want)
    assert not r["ok"] and "ascending" in r["why"]


# ------------------------------- on the card -------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernel has no CPU mode")
    return torch.device("cuda", 0)


def _card_case(dev, B, n, d, metric, dyadic, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if dyadic:
        q = torch.randint(-8, 9, (B, d), generator=g, device=dev) / 8
        t = torch.randint(-8, 9, (n, d), generator=g, device=dev) / 8
    else:
        q = torch.randn((B, d), generator=g, device=dev)
        t = torch.randn((n, d), generator=g, device=dev)
    q_sq = t_sq = None
    if metric == "l2":
        q_sq, t_sq = torch.sum(q * q, 1), torch.sum(t * t, 1)
    return q.to(torch.bfloat16), t.to(torch.bfloat16), q_sq, t_sq


CARD_SHAPES = [(1024, 100_003, 128, 48, "ip"), (257, 20_011, 100, 10, "l2"),
               (1, 50_000, 128, 48, "ip"), (40, 5000, 32, 256, "cosine"),
               (300, 3001, 128, 129, "l2"), (8192, 30_000, 128, 20, "ip"),
               (70, 777, 200, 64, "ip"),
               # d = 200 past one tile (a 16-column tail, 24- and 32-key
               # buffers), one warpgroup with that tail, and two with a
               # 32-column tail (d = 32)
               (1024, 100_003, 200, 20, "ip"), (300, 20_011, 200, 48, "l2"),
               (40, 5000, 200, 200, "cosine"), (300, 9000, 32, 48, "ip"),
               # long shares (the pre-filter): a 16- and a 32-column tail
               # at queues of 32 (24-key buffers) and 64, and full boxes
               (8192, 600_011, 200, 20, "ip"), (8192, 600_011, 200, 48, "l2"),
               (8192, 600_011, 96, 20, "ip"), (8192, 600_011, 96, 48, "l2"),
               (8192, 600_011, 128, 20, "cosine"),
               (8192, 600_011, 128, 48, "ip"),
               # a table under a step, a batch under a tile, d under a box
               (3, 1, 128, 1, "ip"), (40, 50, 32, 48, "l2"),
               (1, 127, 100, 100, "cosine"), (130, 127, 16, 127, "ip")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,d,k,metric", CARD_SHAPES)
def test_kernel_within_tolerance(cuda_device, B, n, d, k, metric):
    q, t, q_sq, t_sq = _card_case(cuda_device, B, n, d, metric, False, n)
    before = ss.launches
    got = ss.score_topk(q, t, k, metric, q_sq, t_sq)
    want = ss.score_topk_ref(q, t, k, metric, q_sq, t_sq)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    r = ss.check_tolerance(q, t, metric, got, want, q_sq, t_sq)
    assert r["ok"], r


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,d,k,metric", CARD_SHAPES)
def test_kernel_bits_on_dyadic_data(cuda_device, B, n, d, k, metric):
    """Dyadic operands: every product and sum is exact in f32, in any order,
    so the kernel equals the plain version bit for bit, ties included."""
    q, t, q_sq, t_sq = _card_case(cuda_device, B, n, d, metric, True, k)
    got = ss.score_topk(q, t, k, metric, q_sq, t_sq)
    want = ss.score_topk_ref(q, t, k, metric, q_sq, t_sq)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(128, 200_000), (200, 600_011)])
def test_kernel_deterministic_across_batch_and_split(cuda_device,
                                                     monkeypatch, d, n):
    """A query's result has the same bits alone (one warpgroup), in a batch
    of 8,192 (two), on a card of another SM count (another split) and on a
    second run; at d = 200 the batch's long shares take the pre-filter and
    a 16-column last box, and the query alone the base loop."""
    q, t, _, _ = _card_case(cuda_device, 8192, n, d, "ip", False, 5)
    full = ss.score_topk(q, t, 48, "ip")
    again = ss.score_topk(q, t, 48, "ip")
    assert torch.equal(full[0], again[0]) and torch.equal(full[1], again[1])
    for r in (0, 4097, 8191):
        one = ss.score_topk(q[r:r + 1], t, 48, "ip")
        assert torch.equal(one[0], full[0][r:r + 1])
        assert torch.equal(one[1], full[1][r:r + 1])
    for sms in (7, 500):
        monkeypatch.setattr(ss, "device_info",
                            lambda index, s=sms: DeviceInfo(s))
        other = ss.score_topk(q[:300], t, 48, "ip")
        assert torch.equal(other[0], full[0][:300])
        assert torch.equal(other[1], full[1][:300])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 128])
def test_kernel_reads_a_pitched_table_in_place(cuda_device, d):
    """A table made by ``aligned_rows`` (rows a padded pitch apart) and a
    strided batch are read in place, with the bits of contiguous ones."""
    q, t, _, _ = _card_case(cuda_device, 300, 20_000, d, "ip", False, d)
    want = ss.score_topk(q, t, 32, "ip")
    tp = ss.aligned_rows(t)
    wide = torch.zeros((300, 2 * d + 8), dtype=q.dtype, device=q.device)
    wide[:, 8:8 + d] = q
    got = ss.score_topk(wide[:, 8:8 + d], tp, 32, "ip")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
