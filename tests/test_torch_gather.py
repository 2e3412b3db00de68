"""Port row gather (K1) against the JAX package's Pallas gather.

The JAX side runs its kernel in interpret mode, as tests/test_gather.py
does; the port's CPU path is its plain version (index_select). Both must be
bit-identical. The launch plan (``_plan``: path, segments, grid) is pure
Python and pinned here on the CPU. The kernel itself runs only on a CUDA
device: those tests are marked ``cuda`` and skip without one. The machine
with the card has no jax, so this file imports the JAX package only inside
the tests that use it; there the ``cuda`` tests run with

    python -m pytest --noconftest -m cuda tests/test_torch_gather.py
"""

import ctypes
import re

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


# an H100 SXM as msann_gather_setup reports it: 132 SMs, and the narrow
# kernels' occupancy under their 64-register cap
H100 = tg.DeviceInfo(n_sms=132, narrow_blocks_per_sm=4)


@pytest.mark.parametrize("row_bytes,t_align,o_align,path,word,loads", [
    (16, 0, 0, "narrow", 16, 4),
    (48, 0, 0, "narrow", 16, 4),           # int8 x 48, the odd width
    (256, 0, 0, "narrow", 16, 4),          # i32 x 64 adjacency rows
    (512, 0, 0, "narrow", 16, 8),          # f32 x 128
    (2032, 0, 0, "narrow", 16, 8),         # the switch - 16 B
    (2048, 0, 0, "narrow", 16, 8),         # the switch
    (2064, 0, 0, "register", 16, 0),       # the switch + 16 B
    (2304, 0, 0, "register", 16, 0),       # 4M serving byte rows
    (6528, 0, 0, "register", 16, 0),
    (8192, 0, 0, "register", 16, 0),
    (102400, 0, 0, "register", 16, 0),     # IVF int8 blocks
    (512, 4, 0, "register", 4, 0),         # a table view off 16 B
    (512, 0, 8, "register", 4, 0),
    (8192, 4, 0, "register", 4, 0),
    (28, 0, 0, "register", 4, 0),          # f32 x 7
    (9001, 0, 0, "register", 1, 0),        # an odd byte width
    (512, 2, 0, "register", 1, 0),
])
def test_plan_path_by_width_and_alignment(row_bytes, t_align, o_align, path,
                                          word, loads):
    plan = tg._plan(row_bytes, 4096, t_align, o_align, H100)
    assert (plan.path, plan.word, plan.loads, plan.row_bytes) == (
        path, word, loads, row_bytes)
    assert len(plan.packed()) == len(plan)
    assert plan.packed()[0] == tg.PATHS[path]


def _segment_items(plan, n_idx):
    """The (row, first byte, bytes) items of a segmented register launch,
    warp by warp, with the kernel's index arithmetic (csrc/gather.cu
    gather_segments_kernel: a warp's lanes take words w0 + u * 32)."""
    words = plan.row_bytes // plan.word
    seg_words = plan.seg_bytes // plan.word
    n_seg = -(-words // seg_words)
    n_warps = plan.grid * plan.threads // 32
    for warp in range(n_warps):
        for item in range(warp, n_idx * n_seg, n_warps):
            i, s = divmod(item, n_seg)
            w0 = s * seg_words
            n = min(seg_words, words - w0)
            yield i, w0 * plan.word, n * plan.word


@pytest.mark.parametrize("row_bytes,t_align", [
    (8192, 0), (8192, 4), (9001, 0), (102400, 0), (409600, 0),
    (1064960, 0)])
@pytest.mark.parametrize("n_idx", [1, 4, 64, 600])
def test_plan_segments_cover_each_row_once(row_bytes, t_align, n_idx):
    plan = tg._plan(row_bytes, n_idx, t_align, 0, H100)
    assert plan.path == "register"
    assert plan.seg_bytes == 32 * tg.UNROLL * plan.word and plan.tile == 32
    covered = {}
    for i, off, nbytes in _segment_items(plan, n_idx):
        assert nbytes > 0 and off % plan.word == 0
        covered.setdefault(i, []).append((off, nbytes))
    assert sorted(covered) == list(range(n_idx))
    for spans in covered.values():
        spans.sort()
        assert spans[0][0] == 0
        assert all(a + n == b for (a, n), (b, _) in zip(spans, spans[1:]))
        assert spans[-1][0] + spans[-1][1] == row_bytes


def test_plan_small_block_calls_spread_over_the_card():
    """A call of 4 IVF blocks (102.4 KB int8, 409.6 KB f32) is cut into
    one segment a warp: at least one warp per SM, none idle."""
    for row_bytes in (102400, 409600):
        plan = tg._plan(row_bytes, 4, 0, 0, H100)
        n_items = 4 * -(-row_bytes // plan.seg_bytes)
        assert n_items >= H100.n_sms
        assert plan.grid * plan.threads // 32 == n_items


@pytest.mark.parametrize("row_bytes,t_align", [
    (16, 0), (192, 0), (512, 0), (2048, 0), (4608, 0), (409600, 0),
    (28, 0), (512, 4), (9001, 0), (40000, 4)])
@pytest.mark.parametrize("n_idx", [1, 31, 33, 65536, 1 << 22])
def test_plan_grid_within_device_limits(row_bytes, t_align, n_idx):
    plan = tg._plan(row_bytes, n_idx, t_align, 0, H100)
    assert 1 <= plan.grid < 2 ** 31 and plan.threads == 256
    if plan.path == "narrow":
        assert plan.grid <= H100.narrow_blocks_per_sm * H100.n_sms
        # never more warps than 32-row tiles, once the grid is that small
        warps = plan.grid * plan.threads // 32
        assert warps < -(-n_idx // 32) + plan.threads // 32
    else:
        assert plan.grid <= 16 * H100.n_sms
        if not plan.seg_bytes:    # a group of lanes per row
            assert plan.tile & (plan.tile - 1) == 0 and plan.tile <= 32
            assert plan.tile >= min(32, row_bytes // plan.word)


def test_plan_cache_key(monkeypatch):
    """Plans are cached per (device, row bytes, pointer alignments, index
    count bucket); a bucket [2^(b-1), 2^b) takes the plan of its smallest
    count."""
    monkeypatch.setattr(tg, "_plans", {})
    monkeypatch.setattr(tg, "device_info", lambda index: H100)
    a = tg._cached_plan(0, 512, 40, 0x1000, 0x2000)
    assert tg._cached_plan(0, 512, 63, 0x7000, 0x9000) is a    # same bucket
    assert a[0] == tg._plan(512, 32, 0, 0, H100)
    assert list(a[1]) == list(a[0].packed())
    assert a[2] == ctypes.addressof(a[1])
    assert tg._cached_plan(0, 512, 64, 0x1000, 0x2000) is not a
    assert tg._cached_plan(1, 512, 40, 0x1000, 0x2000) is not a
    assert tg._cached_plan(0, 512, 40, 0x1004, 0x2000)[0].path == "register"
    assert tg._cached_plan(0, 528, 40, 0x1000, 0x2000) is not a
    assert len(tg._plans) == 5


def test_plan_constants_match_the_kernel_source():
    """The plan's packing order and the kernel constants it sizes launches
    by are the ones csrc/gather.cu compiles with."""
    with open(tg.SOURCE) as f:
        src = f.read()
    enum = re.search(r"enum PlanField \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(k\w+)", enum, re.M)
    assert fields == ["kPath", "kRowBytes", "kWord", "kTile", "kLaneLoads",
                      "kSegBytes", "kGrid", "kThreads", "kPlanFields"]
    assert len(tg.Plan._fields) == len(fields) - 1

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kNarrowThreads") == tg.NARROW_THREADS
    assert const("kTileRows") == tg.TILE_ROWS
    assert const("kUnroll") == tg.UNROLL
    assert "narrow_rows_kernel<IdxT, 4>" in src
    assert "narrow_rows_kernel<IdxT, 8>" in src
    paths = re.search(r"enum Path \{(.*?)\};", src).group(1)
    assert paths.replace(" ", "") == "kNarrow=0,kRegister=1"
    assert tg.PATHS == {"narrow": 0, "register": 1}


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


def _byte_table(dev, n_rows, row_bytes, seed, offset=0):
    """A seeded uint8 [n_rows, row_bytes] table whose data pointer lies
    ``offset`` bytes past the start of its (aligned) storage."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    raw = torch.randint(0, 256, (n_rows * row_bytes + offset,), generator=g,
                        device=dev, dtype=torch.uint8)
    return raw[offset:].view(n_rows, row_bytes)


@pytest.mark.cuda
@pytest.mark.parametrize("row_bytes,path", [
    (16, "narrow"), (2032, "narrow"), (2048, "narrow"), (2064, "register"),
    (8192, "register"), (102400, "register")])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_kernel_path_boundary_widths(cuda_device, row_bytes, path, idx_dtype):
    """Each path at its boundary widths, int32 and int64 indices, bit for
    bit against index_select, for a call of a few rows and of many."""
    n_rows = 600 if row_bytes > 8192 else 5000
    table = _byte_table(cuda_device, n_rows, row_bytes, row_bytes)
    assert tg.plan_for(table, 7).path == path
    g = torch.Generator(device=cuda_device)
    g.manual_seed(7)
    for n_idx in (1, 7, 33, 3000):
        idx = torch.randint(0, n_rows, (n_idx,), generator=g,
                            device=cuda_device, dtype=idx_dtype)
        idx[0] = n_rows - 1
        before = tg.launches
        got = tg.gather_rows(table, idx)
        torch.cuda.synchronize()
        assert tg.launches == before + 1
        assert torch.equal(got, tg.gather_rows_ref(table, idx))
    assert tg.error_flag_value() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("offset,row_bytes,word", [
    (4, 512, 4), (4, 8192, 4), (1, 512, 1), (8, 4608, 4)])
def test_kernel_unaligned_table_view(cuda_device, offset, row_bytes, word):
    """A table view that is not 16-byte aligned takes the register path."""
    table = _byte_table(cuda_device, 3000, row_bytes, 11, offset)
    assert table.data_ptr() % 16 == offset
    plan = tg.plan_for(table, 1000)
    assert (plan.path, plan.word) == ("register", word)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(12)
    idx = torch.randint(0, 3000, (1000,), generator=g, device=cuda_device,
                        dtype=torch.int64)
    got = tg.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, tg.gather_rows_ref(table, idx))
    assert tg.error_flag_value() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset,path", [
    ((1000, 512), 0, "narrow"), ((200, 6528), 0, "register"),
    ((50, 131072), 0, "register"), ((1000, 512), 4, "register"),
    ((100, 16384), 4, "register")])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_kernel_out_of_range_on_each_path(cuda_device, shape, offset, path,
                                          idx_dtype):
    """An index of N or -1 reads nothing: its row comes back zero and the
    device flag is set; the other rows are copied."""
    n_rows, row_bytes = shape
    table = _byte_table(cuda_device, n_rows, row_bytes, 3, offset)
    idx = torch.tensor([3, n_rows, n_rows - 1, -1, 0] * 8, device=cuda_device,
                       dtype=idx_dtype)
    assert tg.plan_for(table, idx.shape[0]).path == path
    tg.reset_error_flag()
    out = tg.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert tg.error_flag_value() == 1
    bad = (idx < 0) | (idx >= n_rows)
    assert bool((out[bad] == 0).all())
    good = (~bad).nonzero().squeeze(1)
    assert torch.equal(out[good], table[idx[good].long()])
    tg.reset_error_flag()


@pytest.mark.cuda
def test_kernel_empty_indices(cuda_device):
    table = torch.ones((100, 128), device=cuda_device)
    for dt in (torch.int32, torch.int64):
        before = tg.launches
        out = tg.gather_rows(table, torch.zeros(0, dtype=dt,
                                                device=cuda_device))
        assert tuple(out.shape) == (0, 128) and out.is_cuda
        assert tg.launches == before      # nothing to launch
