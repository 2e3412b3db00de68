"""Port binned scan (K2) against the JAX package's Pallas scan.

The JAX side runs its kernel in interpret mode, as tests/test_scan.py does;
the port's CPU path is its plain version (``binned_scan_ref``). On dyadic
data (integers / 8) every bf16 value and every f32 sum is exact, so the
scan's (dists, j) compare bit for bit, the lowest-j tie rule included. The
top-k over bins is compared on Gaussian data, where bin maxima are
distinct: the JAX package's ``approx_min_k`` does not order exact ties by
index on the CPU. The kernel itself runs only on a CUDA device: that test
is marked ``cuda`` and skips without one; on the card (no jax there):

    python -m pytest --noconftest -m cuda tests/test_torch_scan.py
"""

import numpy as np
import pytest
import torch

from mysteryann_tpu_torch.ops import scan as ts

ODD_N = [ts.BINS, 3 * 512 + 17, 9 * 512 + 5]


@pytest.fixture
def jax_scan():
    """(jnp, the JAX package's ops.scan module)."""
    jnp = pytest.importorskip("jax.numpy")
    from mysteryann_tpu.ops import scan as js
    return jnp, js


def _dyadic(rng, shape):
    return (rng.integers(-8, 9, size=shape) / 8).astype(np.float32)


def test_constants_match(jax_scan):
    _, js = jax_scan
    assert (ts.B_BLK, ts.C_BLK, ts.TG, ts.G, ts.BINS) == (
        js.B_BLK, js.C_BLK, js.TG, js.G, js.BINS)


@pytest.mark.parametrize("n", ODD_N)
def test_binned_scan_ref_bit_identical(jax_scan, n):
    """n = BINS fills every bin once; 3·512+17 leaves half the bins
    unwritten (+inf, j = 0) and masks a tail; 9·512+5 keeps an older j in
    the bins whose last tile is all tail."""
    jnp, js = jax_scan
    rng = np.random.default_rng(n)
    q = _dyadic(rng, (ts.B_BLK, 128))
    base = _dyadic(rng, (n, 128))
    want_d, want_j = js.binned_scan(jnp.asarray(q), js.make_scan_table(base),
                                    n, interpret=True)
    got_d, got_j = ts.binned_scan(torch.from_numpy(q),
                                  ts.make_scan_table(base, device="cpu"), n)
    assert got_d.dtype == torch.float32 and got_j.dtype == torch.int16
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_j.numpy(), np.asarray(want_j))


def test_ref_rules_unwritten_bins_and_ties():
    """The rules the comparison above relies on, stated directly: bins of
    tiles that do not exist stay +inf / j = 0, and a tie keeps the lower
    j."""
    n = 9 * ts.C_BLK + 5                       # tiles 0..9, J = 2
    base = np.zeros((n, 128), np.float32)
    base[:, 0] = 1.0                           # every score is q[:, 0]
    q = np.zeros((ts.B_BLK, 128), np.float32)
    q[:, 0] = 2.0
    d, j = ts.binned_scan(torch.from_numpy(q),
                          ts.make_scan_table(base, device="cpu"), n)
    assert torch.all(d == -2.0)                # all bins written (nt >= TG)
    assert torch.all(j == 0)                   # tiles 8, 9 tie with 0, 1
    n = 3 * ts.C_BLK + 17                      # tiles 0..3 only
    d, j = ts.binned_scan(torch.from_numpy(q),
                          ts.make_scan_table(base[:n], device="cpu"), n)
    cols_per_tile = ts.G * 128
    assert torch.all(torch.isinf(d[:, 4 * cols_per_tile:]))
    assert torch.all(j[:, 4 * cols_per_tile:] == 0)
    # the tail of tile 3 is masked: its bins past column 17 never win
    assert torch.all(torch.isinf(d[:, 3 * cols_per_tile + 17:
                                   4 * cols_per_tile]))


@pytest.mark.parametrize("with_rerank", [False, True])
def test_flat_scan_topk_matches(jax_scan, with_rerank):
    jnp, js = jax_scan
    rng = np.random.default_rng(11)
    n, k = 20000, 10
    q = rng.standard_normal((ts.B_BLK, 128)).astype(np.float32)
    base = rng.standard_normal((n, 128)).astype(np.float32)
    kw_j = {"base_f32": jnp.asarray(base)} if with_rerank else {}
    kw_t = {"base_f32": torch.from_numpy(base)} if with_rerank else {}
    want_d, want_i = js.flat_scan_topk(jnp.asarray(q), js.make_scan_table(base),
                                       n, k, interpret=True, **kw_j)
    got_d, got_i = ts.flat_scan_topk(torch.from_numpy(q),
                                     ts.make_scan_table(base, device="cpu"),
                                     n, k, **kw_t)
    assert got_i.dtype == torch.int32 and got_d.dtype == torch.float32
    want_i = np.asarray(want_i)
    for b in range(ts.B_BLK):
        assert set(got_i[b].tolist()) == set(want_i[b].tolist())
    # scan dists: bf16-operand scores, f32 sums in another order;
    # reranked: exact f32 dots, 128-term sums of |ip| ~ 45
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0,
                               atol=1e-4)


def test_make_scan_table_padding(jax_scan):
    jnp, js = jax_scan
    rng = np.random.default_rng(3)
    for n in (ts.C_BLK, 3 * ts.C_BLK + 17):
        base = rng.standard_normal((n, 128)).astype(np.float32)
        got = ts.make_scan_table(base, device="cpu")
        want = np.asarray(js.make_scan_table(base).astype(jnp.float32))
        assert got.dtype == torch.bfloat16
        assert got.shape[0] % ts.C_BLK == 0 and got.shape[0] - n < ts.C_BLK
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert torch.all(got[n:] == 0)


def test_shape_misfit_errors():
    rng = np.random.default_rng(4)
    tbl = ts.make_scan_table(rng.standard_normal((ts.BINS, 128))
                             .astype(np.float32), device="cpu")
    q = torch.zeros((100, 128))
    with pytest.raises(ValueError, match="shape misfit"):
        ts.flat_scan_topk(q, tbl, ts.BINS, 10)
    with pytest.raises(ValueError, match="shape misfit"):
        ts.binned_scan(torch.zeros((ts.B_BLK, 64)), tbl[:, :64], ts.BINS)
    with pytest.raises(ValueError, match="shape misfit"):
        ts.binned_scan_ref(torch.zeros((ts.B_BLK, 128)), tbl[:100], 100)


def test_cpu_path_launches_no_kernel():
    before = ts.launches
    tbl = ts.make_scan_table(np.ones((10, 128), np.float32), device="cpu")
    ts.binned_scan(torch.zeros((ts.B_BLK, 128)), tbl, 10)
    assert ts.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(n, 128) for n in ODD_N + [100_003]]
                         + [(100_003, 256), (9 * 512 + 5, 256),
                            (20_000, 512)])
def test_kernel_matches_ref(cuda_device, n, d):
    """Dyadic data: bit for bit. d = 128 and 256 keep the query tile
    resident in shared memory; d = 512 streams it beside the table."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(n + d)
    q = (torch.randint(-8, 9, (2 * ts.B_BLK, d), generator=g,
                       device=cuda_device) / 8)
    base = (torch.randint(-8, 9, (n, d), generator=g,
                          device=cuda_device) / 8)
    tbl = ts.make_scan_table(base)
    before = ts.launches
    got = ts.binned_scan(q, tbl, n)
    torch.cuda.synchronize()
    assert ts.launches == before + 1
    want = ts.binned_scan_ref(q, tbl, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_kernel_gaussian_within_tolerance(cuda_device):
    """Gaussian data: the tensor cores sum the f32 products in another
    order than the plain version's matmul, so a bin's score may differ in
    its last bits (relative error held to ts.KERNEL_RTOL)."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(5)
    n = 100_003
    q = torch.randn((2 * ts.B_BLK, 128), generator=g, device=cuda_device)
    tbl = ts.make_scan_table(torch.randn((n, 128), generator=g,
                                         device=cuda_device))
    before = ts.launches
    got_d, _ = ts.binned_scan(q, tbl, n)
    torch.cuda.synchronize()
    assert ts.launches == before + 1
    want_d, _ = ts.binned_scan_ref(q, tbl, n)
    rel = ((got_d - want_d).abs() / want_d.abs()).max().item()
    assert rel <= ts.KERNEL_RTOL
