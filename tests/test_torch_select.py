"""Port k-selection (``ops/sort.topk_smallest``, kernel K3 behind it on the
card) against the JAX package's selections.

The JAX package selects with ``jax.lax.top_k`` (exact, lowest index first
among ties) and with ``jax.lax.approx_min_k``, the TPU's partial-reduce,
which its CPU backend runs exactly. On the CPU the port's wrapper takes the
plain version, ``topk_smallest_ref`` (``torch.topk`` of the composite
(order image, column) key). The tolerance is exact everywhere: equal value
bits and equal indices, with two documented exceptions:

- ``lax.top_k`` orders ``-0.0`` before ``+0.0`` (the total order); the port
  treats the two as equal, as ``lax.sort`` and an IEEE comparison do, so on
  rows that mix them the reference is ``lax.top_k`` of the row with its
  zeros made ``+0.0`` (the indices), the values being the row's own bits;
- ``approx_min_k`` on the CPU picks other members of an exact tie: there
  the values are compared bit for bit and each index must hold its value.

The launch plan (``select._plan``: route, queue width, warps per row, the
wide route's sort length, row cache and scratch, and the refusal of
another dtype) is pure Python and pinned here. The kernel runs only on a CUDA device: those
tests are marked ``cuda`` and skip without one. The machine with the card
has no jax, so this file imports the JAX package only inside the tests that
use it; there the ``cuda`` tests run with

    python -m pytest --noconftest -m cuda tests/test_torch_select.py
"""

import re

import numpy as np
import pytest
import torch

from mysteryann_tpu_torch.ops import knn as tk
from mysteryann_tpu_torch.ops import select as ts
from mysteryann_tpu_torch.ops import sort
from mysteryann_tpu_torch.ops.sort import topk_smallest, topk_smallest_ref

H100 = ts.DeviceInfo(132)


@pytest.fixture
def jax_sel():
    """(jnp, lax) of the JAX package's CPU backend."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    return jnp, jax.lax


def _ties(rng, shape, lim=3):
    """Integer scores in [-lim, lim] as f32: every row full of exact ties."""
    return rng.integers(-lim, lim + 1, size=shape).astype(np.float32)


def _s32_scores(rng, shape, d=16):
    """Negated int8 · int8 products as f32, the int8 scans' raw scores."""
    q = rng.integers(-127, 128, size=(shape[0], d)).astype(np.int64)
    b = rng.integers(-3, 4, size=(shape[1], d)).astype(np.int64)
    return (-(q @ b.T)).astype(np.float32)


def _signed_zeros(rng, shape):
    """Rows mixing +0.0 and -0.0, a fifth of the entries 1-3 above them."""
    x = np.where(rng.random(shape) < 0.5, np.float32(0.0), np.float32(-0.0))
    x = x.astype(np.float32)
    pick = rng.random(shape) < 0.2
    x[pick] = rng.integers(1, 4, size=shape).astype(np.float32)[pick]
    return x


def _inf_rows(rng, shape):
    """Gaussian rows, some all +inf (the IVF mask, flat padding), some
    +inf past a point."""
    x = rng.standard_normal(shape).astype(np.float32)
    x[::3] = np.inf
    x[1::3, shape[1] // 2:] = np.inf
    return x


CASES = {
    "ties": lambda rng: _ties(rng, (24, 300)),
    "s32": lambda rng: _s32_scores(rng, (16, 500)),
    "inf_rows": lambda rng: _inf_rows(rng, (12, 200)),
    "gauss": lambda rng: rng.standard_normal((8, 1000)).astype(np.float32),
}


def _check_bits(got, want_v, want_i):
    vals, idx = got
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy().view(np.uint32),
                                  np.asarray(want_v).view(np.uint32))


@pytest.mark.parametrize("fn", [topk_smallest_ref, topk_smallest],
                         ids=["ref", "routed"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("k", [1, 10, 40, 64])
def test_matches_lax_top_k(jax_sel, fn, case, k):
    jnp, lax = jax_sel
    x = CASES[case](np.random.default_rng(k))
    neg, pos = lax.top_k(-jnp.asarray(x), k)
    _check_bits(fn(torch.from_numpy(x), k), -np.asarray(neg), pos)


@pytest.mark.parametrize("k", [1, 7, 20, 256])
def test_n_equals_k(jax_sel, k):
    jnp, lax = jax_sel
    x = _ties(np.random.default_rng(k), (5, k), lim=2)
    neg, pos = lax.top_k(-jnp.asarray(x), k)
    _check_bits(topk_smallest(torch.from_numpy(x), k), -np.asarray(neg), pos)


@pytest.mark.parametrize("k", [1, 10, 40])
def test_signed_zeros_tie_to_lower_column(jax_sel, k):
    """Mixed ±0.0: the indices of ``-lax.top_k(-(x + 0.0))`` (zeros made
    +0.0, so the two tie), the values the row's own bits (signs kept)."""
    jnp, lax = jax_sel
    x = _signed_zeros(np.random.default_rng(k), (16, 200))
    _, pos = lax.top_k(-jnp.asarray(x + np.float32(0.0)), k)
    want_v = np.take_along_axis(x, np.asarray(pos), axis=1)
    got = topk_smallest(torch.from_numpy(x), k)
    _check_bits(got, want_v, pos)
    signs = np.signbit(got[0].numpy())
    assert signs.any() and not signs.all()


def test_signed_zeros_differ_from_lax_top_k_order(jax_sel):
    """Where one row holds +0.0 then -0.0, ``lax.top_k`` (total order)
    returns the -0.0 first; the port keeps column order."""
    jnp, lax = jax_sel
    x = np.array([[0.0, -0.0, 1.0]], np.float32)
    _, pos = lax.top_k(-jnp.asarray(x), 2)
    assert np.asarray(pos).tolist() == [[1, 0]]
    assert topk_smallest(torch.from_numpy(x), 2)[1].tolist() == [[0, 1]]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("k", [10, 48])
def test_matches_approx_min_k(jax_sel, case, k):
    """Against ``approx_min_k`` as the JAX package's CPU backend runs it:
    values bit for bit; indices equal on tie-free rows; on rows with ties
    every index distinct and holding its value."""
    jnp, lax = jax_sel
    x = CASES[case](np.random.default_rng(100 + k))
    want_v, want_i = (np.asarray(a) for a in
                      lax.approx_min_k(jnp.asarray(x), k))
    vals, idx = topk_smallest(torch.from_numpy(x), k)
    np.testing.assert_array_equal(vals.numpy().view(np.uint32),
                                  want_v.view(np.uint32))
    idx = idx.numpy()
    for r in range(x.shape[0]):
        if len(np.unique(x[r])) == x.shape[1]:
            np.testing.assert_array_equal(idx[r], want_i[r])
        assert len(set(idx[r])) == k
        np.testing.assert_array_equal(x[r, idx[r]].view(np.uint32),
                                      vals.numpy()[r].view(np.uint32))
    if case == "gauss":
        np.testing.assert_array_equal(idx, want_i)


@pytest.mark.parametrize("view", ["col_slice", "col_step", "rows_step",
                                  "chunk_3d", "transposed"])
def test_non_contiguous_rows(jax_sel, view):
    """Row-strided and non-unit-stride views select as their contiguous
    copies do, and as ``lax.top_k`` on those copies."""
    jnp, lax = jax_sel
    rng = np.random.default_rng(7)
    base = torch.from_numpy(_ties(rng, (24, 640)))
    x = {"col_slice": base[:, 40:540],
         "col_step": base[:, ::2],
         "rows_step": base[::3],
         "chunk_3d": base.view(4, 6, 640)[:, :, :500],
         "transposed": base.t()}[view]
    k = 20
    neg, pos = lax.top_k(-jnp.asarray(x.contiguous().numpy()), k)
    got = topk_smallest(x, k)
    _check_bits(got, -np.asarray(neg), pos)
    want = topk_smallest_ref(x.contiguous(), k)
    assert torch.equal(got[1], want[1])


def test_int32_selects_on_the_integer(jax_sel):
    jnp, lax = jax_sel
    x = np.random.default_rng(3).integers(-1000, 1000, size=(9, 400),
                                          dtype=np.int32)
    neg, pos = lax.top_k(-jnp.asarray(x), 40)
    _check_bits(topk_smallest(torch.from_numpy(x), 40), -np.asarray(neg), pos)


def test_wide_k_on_the_cpu(jax_sel):
    jnp, lax = jax_sel
    x = _ties(np.random.default_rng(5), (6, 2000))
    neg, pos = lax.top_k(-jnp.asarray(x), 300)
    _check_bits(topk_smallest(torch.from_numpy(x), 300), -np.asarray(neg), pos)


# ------------------------------- the plan --------------------------------


def test_cpu_route_is_the_plain_version(monkeypatch):
    """A CPU tensor takes ``topk_smallest_ref`` and never the kernel's
    wrapper, whatever k and dtype."""
    calls = []
    ref = sort.topk_smallest_ref
    monkeypatch.setattr(sort, "topk_smallest_ref",
                        lambda x, k: calls.append(k) or ref(x, k))
    monkeypatch.setattr(ts, "topk_smallest_cuda", None)
    x = torch.arange(12000, 0, -1, dtype=torch.float32).view(1, -1)
    for k, dt in ((10, torch.float32), (9000, torch.float32),
                  (5, torch.int32)):
        vals, idx = sort.topk_smallest(x.to(dt), k)
        assert idx[0, 0] == 11999 and vals.dtype == dt
    assert calls == [10, 9000, 5]


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64,
                                   torch.bfloat16, torch.int64])
def test_plan_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="float32"):
        ts._plan(10, 4096, 8192, dtype, 4096, H100)


def test_plan_refuses_k_past_the_block_queue():
    """No k past the old block queue's 8,192 is refused: the wide route
    takes every k <= n, sorting through global scratch past
    SMEM_SORT_KEYS (the 50M world's gate: k = 14,142 of 14,142)."""
    p = ts._plan(8192, 10_000, 4, torch.float32, 10_000, H100)
    assert (p.route, p.queue, p.scratch) == ("wide", 8192, 0)
    p = ts._plan(8193, 10_000, 4, torch.float32, 10_000, H100)
    assert (p.route, p.queue, p.scratch) == ("wide", 16384, 2 * 4 * 16384)
    p = ts._plan(14142, 14142, 64, torch.float32, 14142, H100)
    assert (p.route, p.queue, p.cache, p.scratch) == (
        "wide", 16384, True, 2 * 64 * 16384)


@pytest.mark.parametrize("k,kpl", [(1, 1), (10, 1), (32, 1), (33, 2), (48, 2),
                                   (64, 2), (65, 4), (128, 4), (129, 8),
                                   (256, 8)])
def test_plan_queue_width(k, kpl):
    p = ts._plan(k, 500_000, 8192, torch.float32, 500_000, H100)
    assert (p.route, p.queue, p.cache, p.scratch, p.copy) == (
        "k3", 32 * kpl, False, 0, False)
    assert p.queue >= k


@pytest.mark.parametrize("k,n,sort,cache,scratch", [
    (257, 2000, 512, True, 0), (300, 2000, 512, True, 0),
    (512, 2000, 512, True, 0), (513, 2000, 1024, True, 0),
    (2000, 2000, 2048, True, 0), (2049, 6324, 4096, True, 0),
    (6324, 6324, 8192, True, 0), (8192, 8192, 8192, True, 0),
    (300, 40_000, 512, True, 0), (300, 60_000, 512, False, 0),
    (8192, 40_000, 8192, False, 0), (8193, 20_000, 16384, True, 2 * 1024 * 16384),
    (14142, 60_000, 16384, False, 2 * 1024 * 16384)])
def test_plan_block_queue(k, n, sort, cache, scratch):
    """The wide route: a block a row sorting the least power of two from
    512 keys that holds k, the row cached in shared memory when it fits
    beside the sort buffer, global scratch past 8,192 keys."""
    p = ts._plan(k, n, 1024, torch.float32, n, H100)
    assert p == ts.Plan("wide", False, sort, cache, scratch, 1, 1024, 256)
    in_smem = 8 * sort if sort <= ts.SMEM_SORT_KEYS else 0
    assert (in_smem + 4 * n <= ts.WIDE_SMEM) == cache


@pytest.mark.parametrize("k,route", [(1, "k3"), (256, "k3"), (257, "wide"),
                                     (2000, "wide"), (8192, "wide"),
                                     (8193, "wide"), (14142, "wide")])
def test_plan_routes(k, route):
    assert ts._plan(k, 20_000, 8192, torch.float32, 20_000,
                    H100).route == route


def test_plan_copies_only_unaddressable_rows():
    assert not ts._plan(20, 800, 131072, torch.float32, 800, H100).copy
    assert not ts._plan(20, 500, 64, torch.float32, 640, H100).copy
    assert ts._plan(20, 500, 64, torch.float32, None, H100).copy
    assert ts._plan(300, 500, 64, torch.float32, None, H100).copy


@pytest.mark.parametrize("rows,n,w,grid,threads", [
    (8192, 500_000, 1, 2048, 128),     # the seed scan: a warp a row
    (131072, 800, 1, 32768, 128),      # 16 IVF steps of 8,192 rows
    (4096, 65536, 2, 4096, 64),        # a kNN tile of 4,096 queries
    (4, 1_000_000, 8, 4, 256),         # few long rows: a block a row
    (3, 20_000, 4, 3, 128),            # shares of >= MIN_COLS_PER_WARP
    (5, 1000, 1, 2, 128),              # short rows stay a warp each
])
def test_plan_warps_per_row(rows, n, w, grid, threads):
    p = ts._plan(40, n, rows, torch.float32, n, H100)
    assert (p.warps_per_row, p.grid, p.threads) == (w, grid, threads)
    assert p.threads <= 256 and p.threads % (32 * p.warps_per_row) == 0


def test_rows_view_strides():
    base = torch.zeros((24, 640))
    x2, s = ts._rows_view(base[:, 40:540])
    assert (x2.shape, s) == ((24, 500), 640)
    assert ts._rows_view(base[:, ::2]) == (None, None)
    x2, s = ts._rows_view(base.view(4, 6, 640)[:, :, :500])
    assert (x2.shape, s) == ((24, 500), 640)
    x2, s = ts._rows_view(base.view(4, 6, 640)[:, ::2, :500])
    assert (x2.shape, s) == ((12, 500), 1280)
    assert ts._rows_view(base.view(4, 6, 640)[:, :4, :500]) == (None, None)
    x2, s = ts._rows_view(torch.zeros(77))
    assert (x2.shape, s) == ((1, 77), 77)


def test_source_agrees_with_the_wrapper():
    """csrc/select.cu's argument layout and constants are the wrapper's."""
    src = open(ts.SOURCE).read()
    fields = re.search(r"enum Arg \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"^\s*(k\w+)", fields, re.M)
    assert names[-1] == "kArgs" and len(names) - 1 == 14
    assert len(ts._pack_args(*range(14))) == 14 * 8
    assert "kMaxThreads = 256;" in src and ts.MAX_WARPS_PER_ROW * 32 == 256
    assert ts.MAX_K == 32 * 8
    assert f"kWideThreads = {ts.WIDE_THREADS};" in src
    assert f"kMinSort = {ts.WIDE_MIN_SORT};" in src
    assert f"kSmemSort = {ts.SMEM_SORT_KEYS};" in src
    assert f"kWideSmem = {ts.WIDE_SMEM >> 10} << 10;" in src
    assert '#include "k3_queue.cuh"' in src


def test_reset_launches():
    ts.launches, ts.wide_launches = 5, 2
    assert ts.reset_launches() == 5
    assert (ts.launches, ts.wide_launches) == (0, 0)


def test_cuda_entry_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="no select kernel"):
        ts.topk_smallest_cuda(torch.zeros((2, 10)), 3)


# -------------------- the tiled scans at either reckoning -------------------


# the selection's bytes an element on the CPU (the composite key) and on
# the card (K3: none)
RECKONINGS = {"cpu": 32, "cuda": 0}


@pytest.mark.parametrize("reckoning", sorted(RECKONINGS))
def test_tiled_topk_independent_of_the_tile(jax_sel, monkeypatch, reckoning):
    """``_tiled_topk`` at the tile the card's reckoning gives and at the one
    the CPU's gives: the same bits as one untiled selection, and as
    ``lax.top_k`` of the whole block."""
    jnp, lax = jax_sel
    rng = np.random.default_rng(11)
    B, nb, k = 64, 5000, 40
    scores = torch.from_numpy(_ties(rng, (B, nb), lim=6))
    monkeypatch.setattr(tk, "_CPU_BLOCK_BYTES", 600 * B * 48)
    monkeypatch.setattr(tk, "selection_bytes",
                        lambda device: RECKONINGS[reckoning])
    tile = tk._tile_rows(B, nb, torch.device("cpu"))
    assert tile == (600 if reckoning == "cpu" else 1800)
    calls = []

    def score_tile(t0, t1):
        calls.append(t1 - t0)
        return scores[:, t0:t1]

    d, i = tk._tiled_topk(score_tile, B, nb, k, nb, torch.device("cpu"))
    assert max(calls) == tile and len(calls) == -(-nb // tile)
    neg, pos = lax.top_k(-jnp.asarray(scores.numpy()), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(d.numpy().view(np.uint32),
                                  (-np.asarray(neg)).view(np.uint32))


def test_selection_bytes_by_device():
    for dev in ("cpu", "cuda"):
        assert sort.selection_bytes(torch.device(dev)) == RECKONINGS[dev]
    assert tk._TILE_BYTES_PER_ELEM + RECKONINGS["cpu"] == 48
    assert tk._tile_rows(10, 10**9, torch.device("cpu")) == \
        tk._CPU_BLOCK_BYTES // (10 * 48)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_exact_knn_matches_jax_at_both_reckonings(jax_sel, monkeypatch,
                                                  metric):
    """The slice end to end: the port's exact kNN, its scan tiled by
    either reckoning, against the JAX package's ``exact_knn`` (``lax.top_k``
    tiles) bit for bit on dyadic data (exact distances), and against its
    ``approx=True`` path (``approx_min_k`` tiles): distances bit for bit,
    ids equal on every row whose k + 1 best distances are distinct."""
    from mysteryann_tpu.ops import knn as jk

    rng = np.random.default_rng(21)
    base = (rng.integers(-64, 65, size=(3000, 32)) / 64).astype(np.float32)
    q = (rng.integers(-64, 65, size=(40, 32)) / 64).astype(np.float32)
    want_d, want_i = jk.exact_knn(q, base, 16, metric=metric,
                                  base_tile=3000)
    appr_d, appr_i = jk.exact_knn(q, base, 16, metric=metric,
                                  base_tile=3000, approx=True)
    head_d, _ = jk.exact_knn(q, base, 17, metric=metric, base_tile=3000)
    distinct = np.array([len(np.unique(r)) == 17 for r in head_d])
    assert distinct.any()
    monkeypatch.setattr(tk, "_CPU_BLOCK_BYTES", 256 * 40 * 48)
    for bytes_ in RECKONINGS.values():
        monkeypatch.setattr(tk, "selection_bytes",
                            lambda device, b=bytes_: b)
        d, i = tk.exact_knn(q, base, 16, metric=metric, device="cpu")
        np.testing.assert_array_equal(i, np.asarray(want_i))
        np.testing.assert_array_equal(d.view(np.uint32),
                                      np.asarray(want_d).view(np.uint32))
        np.testing.assert_array_equal(d.view(np.uint32),
                                      np.asarray(appr_d).view(np.uint32))
        np.testing.assert_array_equal(i[distinct],
                                      np.asarray(appr_i)[distinct])


# ------------------------------- on the card -------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the select kernel has no CPU mode")
    return torch.device("cuda", 0)


def _card_cases(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    gauss = torch.randn((8192, 4096), generator=g, device=dev)
    ties = torch.randint(-3, 4, (512, 3000), generator=g, device=dev).float()
    zeros = torch.where(torch.rand((64, 700), generator=g, device=dev) < 0.5,
                        0.0, -0.0)
    infs = torch.full((40, 800), float("inf"), device=dev)
    infs[1::2, :300] = torch.randn((20, 300), generator=g, device=dev)
    wide = torch.randn((96, 1100), generator=g, device=dev)
    return {
        "bins_8192x4096": gauss,
        "ties": ties,
        "signed_zeros": zeros,
        "inf_rows": infs,
        "col_slice": wide[:, 50:1050],
        "chunk_3d": wide.view(8, 12, 1100)[:, :, :800],
        "col_step": wide[:, ::2],
        "few_long_rows": torch.randn((3, 1_000_000), generator=g, device=dev),
        "short_rows": torch.randn((1000, 17), generator=g, device=dev),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 17, 32, 33, 40, 64, 100, 256, 257,
                               600, 2000, 4096, 8192, 8193])
def test_kernel_matches_plain(cuda_device, k):
    for name, x in _card_cases(cuda_device).items():
        kk = min(k, x.shape[-1])
        before = ts.launches
        got = topk_smallest(x, kk)
        want = topk_smallest_ref(x, kk)
        torch.cuda.synchronize()
        assert ts.launches == before + 1, name
        assert torch.equal(got[1], want[1]), (name, kk)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32)), (name, kk)


@pytest.mark.cuda
def test_kernel_n_equals_k(cuda_device):
    for k in (1, 32, 64, 200, 256, 257, 2000, 6324, 8192, 8193, 14142):
        x = torch.randint(-2, 3, (77, k), device=cuda_device).float()
        got, want = topk_smallest(x, k), topk_smallest_ref(x, k)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,k", [
    (8192, 2000, 300), (1024, 2000, 2000), (256, 6324, 6324),
    (64, 20_000, 14_142), (64, 20_000, 257), (16, 70_000, 600),
    (8, 70_000, 9000), (3, 1_000_000, 8193)])
def test_wide_route_bits(cuda_device, rows, n, k):
    """The wide route at the paths' shapes (the probe choice at nprobe 300,
    the 1M, 10M and 50M gates), rows past the shared-memory cache and
    sorts through global scratch: bit for bit on Gaussian and on tied
    rows."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(k)
    for x in (torch.randn((rows, n), generator=g, device=cuda_device),
              torch.randint(-4, 5, (rows, n), generator=g,
                            device=cuda_device).float()):
        got, want = topk_smallest(x, k), topk_smallest_ref(x, k)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.cuda
def test_wide_route_counted(cuda_device):
    x = torch.randn((64, 3000), device=cuda_device)
    ts.reset_launches()
    got = topk_smallest(x, 300)
    assert (ts.launches, ts.wide_launches) == (1, 1)
    assert torch.equal(got[1], topk_smallest_ref(x, 300)[1])


@pytest.mark.cuda
def test_kernel_refuses(cuda_device):
    """int32 scores raise; k past the old block queue's 8,192 is answered."""
    x = torch.randint(-50, 50, (30, 2000), device=cuda_device,
                      dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        topk_smallest(x, 10)
    y = torch.randn((2, 9000), device=cuda_device)
    got, want = topk_smallest(y, 8193), topk_smallest_ref(y, 8193)
    assert torch.equal(got[1], want[1])
