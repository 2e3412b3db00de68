"""Port row gather (K1) against the JAX package's Pallas gather.

The JAX side runs its kernel in interpret mode, as tests/test_gather.py
does; the port's CPU path is its plain version (index_select). Both must be
bit-identical. The kernel itself runs only on a CUDA device: that test is
marked ``cuda`` and skips without one. The machine with the card has no
jax, so this file imports the JAX package only inside the tests that use
it; there the ``cuda`` tests run with

    python -m pytest --noconftest -m cuda tests/test_torch_gather.py
"""

import numpy as np
import pytest
import torch

from mysteryann_tpu_torch.ops import gather as tg


@pytest.fixture
def jax_gather():
    """(jnp, gather_rows, gather_rows_any) of the JAX package."""
    jnp = pytest.importorskip("jax.numpy")
    from mysteryann_tpu.ops import gather as jg
    return jnp, jg.gather_rows, jg.gather_rows_any


def _table(rng, shape, dtype):
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(shape).astype(dtype)
    return rng.integers(-127, 127, size=shape).astype(dtype)


@pytest.mark.parametrize("shape,dtype,n_idx,block", [
    ((500, 128), np.float32, 777, 128),
    ((200, 32, 128), np.int8, 64, 64),
    ((100, 128), np.float32, 33, 32),       # 33 indices, block 32
])
def test_gather_matches_pallas_interpret(jax_gather, shape, dtype, n_idx,
                                        block):
    jnp, jax_gather_rows, _ = jax_gather
    rng = np.random.default_rng(0)
    table = _table(rng, shape, dtype)
    idx = rng.integers(0, shape[0], size=n_idx).astype(np.int32)
    want = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(idx),
                                      block=block, interpret=True))
    got = tg.gather_rows(torch.from_numpy(table), torch.from_numpy(idx),
                         block=block).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("width", [12, 24, 48, 64])
def test_gather_rows_any_int32_widths(jax_gather, width):
    jnp, _, jax_gather_rows_any = jax_gather
    rng = np.random.default_rng(width)
    table = rng.integers(0, 1 << 30, size=(300, width)).astype(np.int32)
    idx = rng.integers(0, 300, size=257).astype(np.int32)
    want = np.asarray(jax_gather_rows_any(jnp.asarray(table),
                                          jnp.asarray(idx), interpret=True))
    got = tg.gather_rows_any(torch.from_numpy(table),
                             torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_int64_and_empty_indices():
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((50, 7)).astype(np.float32))
    idx = torch.tensor([0, 49, 7, 7], dtype=torch.int64)
    np.testing.assert_array_equal(tg.gather_rows(table, idx).numpy(),
                                  table.numpy()[[0, 49, 7, 7]])
    out = tg.gather_rows(table, torch.zeros(0, dtype=torch.int32))
    assert tuple(out.shape) == (0, 7)


def test_gather_contract_errors():
    t = torch.zeros((10, 4))
    with pytest.raises(ValueError):
        tg.gather_rows(torch.zeros(10), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        tg.gather_rows(t, torch.zeros(3, dtype=torch.int16))
    with pytest.raises(ValueError):
        tg.gather_rows(t.t(), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        tg.gather_rows_any(torch.zeros((4, 2, 2)),
                           torch.zeros(1, dtype=torch.int32))
    # the CPU path does not read out of range either: index_select raises
    with pytest.raises(IndexError):
        tg.gather_rows(t, torch.tensor([10], dtype=torch.int32))


def test_cpu_path_launches_no_kernel():
    before = tg.launches
    tg.gather_rows(torch.zeros((10, 4)), torch.tensor([1, 2]))
    assert tg.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gather kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((100_000, 128), torch.float32), ((100_000, 64), torch.int32),
    ((4096, 48), torch.int8), ((10_000, 96), torch.bfloat16)])
def test_kernel_matches_index_select(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    table = torch.randn(shape, generator=g, device=cuda_device).mul(50).to(dtype)
    idx = torch.randint(0, shape[0], (20_000,), generator=g,
                        device=cuda_device, dtype=torch.int32)
    before = tg.launches
    got = tg.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert tg.launches == before + 1
    assert torch.equal(got, tg.gather_rows_ref(table, idx))
    assert tg.error_flag_value() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("row_bytes", [6528, 4608, 1000])
def test_kernel_fused_byte_rows(cuda_device, row_bytes):
    """The fused engine's uint8 byte rows (16-byte words when the width
    allows, bytes otherwise): bit for bit against index_select."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(1)
    table = torch.randint(0, 256, (20_001, row_bytes), generator=g,
                          device=cuda_device, dtype=torch.uint8)
    idx = torch.randint(0, table.shape[0], (8192,), generator=g,
                        device=cuda_device, dtype=torch.int32)
    got = tg.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, tg.gather_rows_ref(table, idx))
    assert tg.error_flag_value() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n_idx", [
    (torch.float32, 4), (torch.float32, 64), (torch.int8, 4),
    (torch.int8, 64), (torch.uint8, 7)])
def test_kernel_ivf_block_rows(cuda_device, dtype, n_idx):
    """The IVF index's cluster blocks: fat rows ([cap, d] per row, here
    [800, 128]: 409.6 KB f32, 102.4 KB int8) take the segmented path; bit
    for bit against index_select. The uint8 case has an odd width (a row of
    9,001 bytes, single-byte words)."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(4)
    shape = (300, 9001) if dtype == torch.uint8 else (300, 800, 128)
    table = torch.randint(-100, 100, shape, generator=g, device=cuda_device,
                          dtype=torch.int32).to(dtype)
    idx = torch.randint(0, shape[0], (n_idx,), generator=g,
                        device=cuda_device, dtype=torch.int32)
    idx[0] = shape[0] - 1
    before = tg.launches
    got = tg.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert tg.launches == before + 1
    assert torch.equal(got, tg.gather_rows_ref(table, idx))
    assert tg.error_flag_value() == 0


@pytest.mark.cuda
def test_kernel_fat_row_out_of_range(cuda_device):
    table = torch.ones((10, 64, 128), device=cuda_device)
    out = tg.gather_rows(table, torch.tensor([3, 10, 9], device=cuda_device,
                                             dtype=torch.int32))
    torch.cuda.synchronize()
    assert tg.error_flag_value() == 1
    assert bool((out[1] == 0).all()) and bool((out[0] == 1).all())
    assert bool((out[2] == 1).all())
    tg.reset_error_flag()
