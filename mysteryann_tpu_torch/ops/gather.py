"""Row gather ``table[idx]`` — kernel K1 of the port.

Counterpart of ``mysteryann_tpu/ops/gather.py``, whose Pallas kernel drives
one async DMA per row on the TPU. Here the kernel is hand-written CUDA C++
for Hopper (``csrc/gather.cu``), with two paths chosen on the host by
``_plan``: *narrow* rows (16-byte multiples up to 2 KB) by warp tiles of 32
rows with the indices loaded a tile ahead and 4-8 loads in flight per lane;
the *register* path for every other row (byte rows, the IVF index's
cluster blocks cut into segments, unaligned rows). It is compiled with ``nvcc`` for
``sm_90a`` at first use into the package's ``build/`` directory
(git-ignored), from the sources in the checkout only, and bound with
``ctypes`` through a plain C interface.

Routing: a CPU tensor takes the plain version, ``gather_rows_ref``
(``torch.index_select``); a CUDA tensor launches the kernel or raises —
there is no fallback from the kernel to the plain version. Indices must lie
in [0, N): callers clamp (sentinel handling is theirs). On the card an index
outside that range zeroes its output row and sets the device error flag
(``error_flag_value``); on the CPU ``index_select`` raises.

The host path is kept short, since many calls move only a few KB: the plan
is cached per (device, row bytes, pointer alignments, index-count bucket);
the device's SM count and occupancies are read once per device; the stream
is read raw; one ctypes call launches.

``launches`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Dict, NamedTuple, Tuple

import torch

from mysteryann_tpu_torch.ops._nvcc import CSRC, build_library

SOURCE = os.path.join(CSRC, "gather.cu")

# the kernel's constants (csrc/gather.cu), which the plan must agree with
NARROW_MAX_BYTES = 2048     # widest row of the narrow path
NARROW_THREADS = 256
TILE_ROWS = 32              # rows per warp tile (narrow, at most 32)
WIDE_LOADS_BYTES = 512      # narrow rows from here keep 8 loads per lane
REGISTER_THREADS = 256
FAT_ROW_BYTES = 8192        # register path: rows from here are segmented
UNROLL = 4                  # register path: words per lane per segment
PATHS = {"narrow": 0, "register": 1}
# msann_gather's one argument: table, rows, idx, idx is int64, count, out,
# error flag, stream, plan address
_pack_args = struct.Struct("9q").pack

launches = 0       # kernel launches since import (or the last reset)
build_log = ""     # compiler output of the last build (registers, spills)
_fn = None         # the bound C entry point, once loaded
_setup = None      # the bound device query
_get_device = None     # () -> index of the current CUDA device
_raw_stream = None     # (device index) -> current stream as an int
_flags: Dict[int, torch.Tensor] = {}   # device index -> int32 [1] error flag
_flag_ptrs: Dict[int, int] = {}
_devices: Dict[int, "DeviceInfo"] = {}
# (device, row bytes, table ptr % 16, out ptr % 16, n_idx.bit_length())
#   -> (Plan, its packed int64 array, the array's address)
_plans: Dict[tuple, Tuple["Plan", ctypes.Array, int]] = {}


class DeviceInfo(NamedTuple):
    """What a plan needs to know of a device (read once per device)."""
    n_sms: int
    narrow_blocks_per_sm: int     # the narrow kernels' least occupancy


class Plan(NamedTuple):
    """One launch's shape; packed in this order for the C entry point."""
    path: str          # "narrow" or "register"
    row_bytes: int
    word: int          # bytes per word moved through registers
    tile: int          # narrow: rows per warp tile; register: lanes per row
    loads: int         # narrow: 16-byte loads in flight per lane
    seg_bytes: int     # register: bytes per segment; 0 = whole rows
    grid: int
    threads: int

    def packed(self) -> Tuple[int, ...]:
        return (PATHS[self.path],) + tuple(self[1:])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(row_bytes: int, n_idx: int, table_align: int, out_align: int,
          dev: DeviceInfo) -> Plan:
    """The launch plan for ``n_idx`` rows of ``row_bytes`` bytes, with the
    table's and the output's pointers at ``table_align`` / ``out_align``
    bytes past a 16-byte boundary, on ``dev``. Pure: the wrapper caches it.

    Narrow when the rows are 16-byte words and at most NARROW_MAX_BYTES:
    warp tiles of TILE_ROWS rows, a persistent grid of the kernel's
    occupancy. The register path otherwise, in the widest word both
    pointers and the width allow: a group of lanes per row, or warps over
    segments of 32 x UNROLL words for rows of FAT_ROW_BYTES and more, at
    most 16 blocks of 256 threads per SM."""
    if (row_bytes % 16 == 0 and table_align % 16 == 0 and out_align % 16 == 0
            and row_bytes <= NARROW_MAX_BYTES):
        blocks = _cdiv(_cdiv(n_idx, TILE_ROWS), NARROW_THREADS // 32)
        return Plan("narrow", row_bytes, 16, TILE_ROWS,
                    8 if row_bytes >= WIDE_LOADS_BYTES else 4, 0,
                    max(1, min(blocks, dev.narrow_blocks_per_sm * dev.n_sms)),
                    NARROW_THREADS)
    word = next(w for w in (16, 4, 1) if row_bytes % w == 0
                and table_align % w == 0 and out_align % w == 0)
    words = row_bytes // word
    if row_bytes >= FAT_ROW_BYTES:
        seg_words = 32 * UNROLL
        needed = _cdiv(n_idx * _cdiv(words, seg_words) * 32, REGISTER_THREADS)
        tile, seg = 32, seg_words * word
    else:
        tile = 1
        while tile < 32 and tile < words:
            tile <<= 1
        needed, seg = _cdiv(n_idx * tile, REGISTER_THREADS), 0
    return Plan("register", row_bytes, word, tile, 0, seg,
                max(1, min(needed, 16 * dev.n_sms)), REGISTER_THREADS)


def build(force: bool = False) -> float:
    """Compile ``csrc/gather.cu`` (unless a library of the same source is
    already built) and load it. Returns the seconds spent compiling."""
    global _fn, _setup, _get_device, _raw_stream, build_log
    lib, secs, log = build_library(SOURCE, force=force)
    if log:
        build_log = log
    setup = lib.msann_gather_setup
    setup.argtypes, setup.restype = [ctypes.c_void_p], ctypes.c_int
    fn = lib.msann_gather
    fn.argtypes, fn.restype = [ctypes.c_char_p], ctypes.c_int
    # the cheapest reads of the current device and stream this torch offers
    _get_device = getattr(torch._C, "_cuda_getDevice",
                          torch.cuda.current_device)
    _raw_stream = getattr(
        torch._C, "_cuda_getCurrentRawStream",
        lambda d: torch.cuda.current_stream(d).cuda_stream)
    _setup, _fn = setup, fn
    _devices.clear()
    _plans.clear()
    return secs


def device_info(index: int) -> DeviceInfo:
    """The plan's view of CUDA device ``index``, read once (builds the
    kernel at first use)."""
    if _fn is None:
        build()
    if index not in _devices:
        info = (ctypes.c_int64 * len(DeviceInfo._fields))()
        with torch.cuda.device(index):
            rc = _setup(ctypes.addressof(info))
        if rc != 0:
            raise RuntimeError(f"gather kernel setup failed: CUDA error {rc}")
        _flag(torch.device("cuda", index))
        _devices[index] = DeviceInfo(*info)
    return _devices[index]


def _cached_plan(index: int, row_bytes: int, n_idx: int, table_ptr: int,
                 out_ptr: int) -> Tuple[Plan, ctypes.Array, int]:
    """The plan of a call, from the cache or made and cached. A bucket of
    index counts [2^(b-1), 2^b) shares the plan of its smallest count: the
    kernels loop over whatever rows they are given."""
    b = n_idx.bit_length()
    key = (index, row_bytes, table_ptr & 15, out_ptr & 15, b)
    entry = _plans.get(key)
    if entry is None:
        plan = _plan(row_bytes, 1 << (b - 1), table_ptr & 15, out_ptr & 15,
                     device_info(index))
        arr = (ctypes.c_int64 * len(plan))(*plan.packed())
        entry = _plans[key] = (plan, arr, ctypes.addressof(arr))
    return entry


def plan_for(table: torch.Tensor, n_idx: int) -> Plan:
    """The plan the wrapper launches for ``n_idx`` rows of ``table`` (a
    CUDA tensor), its output being 16-byte aligned as torch allocates."""
    row_bytes = table.stride(0) * table.element_size()
    return _cached_plan(table.get_device(), row_bytes, n_idx,
                        table.data_ptr(), 0)[0]


def _flag(device: torch.device) -> torch.Tensor:
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _flags:
        _flags[i] = torch.zeros(1, dtype=torch.int32,
                                device=torch.device("cuda", i))
        _flag_ptrs[i] = _flags[i].data_ptr()
    return _flags[i]


def error_flag_value() -> int:
    """1 when any launch since the last reset met an index outside [0, N)
    (synchronises with the card)."""
    return int(max((int(f.item()) for f in _flags.values()), default=0))


def reset_error_flag() -> None:
    for f in _flags.values():
        f.zero_()


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version: ``torch.index_select(table, 0, idx)``."""
    return torch.index_select(table, 0, idx.long())


_IDX_DTYPES = (torch.int32, torch.int64)


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    """Raise on what the kernel does not take: one chain of cheap reads on
    the way through, the precise message only on the way out."""
    if (table.dim() >= 2 and idx.dim() == 1 and idx.dtype in _IDX_DTYPES
            and idx.get_device() == table.get_device()
            and table.is_contiguous() and idx.is_contiguous()):
        return
    if table.dim() < 2:
        raise ValueError("table must be at least 2D")
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-D, got shape {tuple(idx.shape)}")
    if idx.dtype not in _IDX_DTYPES:
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"idx on {idx.device}, table on {table.device}")
    raise ValueError("table and idx must be contiguous")


def _gather_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    global launches
    if _fn is None:
        build()
    n_idx, shape = idx.numel(), table.shape
    out = table.new_empty((n_idx, shape[1]) if len(shape) == 2
                          else (n_idx,) + shape[1:])
    nbytes = out.nbytes
    if nbytes == 0:
        return out
    d, tp, op = table.get_device(), table.data_ptr(), out.data_ptr()
    plan = _cached_plan(d, nbytes // n_idx, n_idx, tp, op)[2]
    args = (tp, shape[0], idx.data_ptr(), idx.element_size() == 8, n_idx,
            op, _flag_ptrs[d])
    if d == _get_device():
        rc = _fn(_pack_args(*args, _raw_stream(d), plan))
    else:
        with torch.cuda.device(d):
            rc = _fn(_pack_args(*args, _raw_stream(d), plan))
    if rc != 0:
        raise RuntimeError(f"gather kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor, block: int = 256,
                interpret: bool = False) -> torch.Tensor:
    """``table[idx]`` for a contiguous table [N, ...] (≥2-D) of any dtype and
    idx int32/int64 [B] in [0, N). ``block`` and ``interpret`` are the TPU
    kernel's knobs; they are accepted and ignored so call sites read the
    same in both packages."""
    del block, interpret
    _check(table, idx)
    if table.is_cuda:
        return _gather_cuda(table, idx)
    if table.device.type == "cpu":
        return gather_rows_ref(table, idx)
    raise ValueError(f"no gather kernel for device {table.device}")


def gather_rows_any(table: torch.Tensor, idx: torch.Tensor, block: int = 256,
                    interpret: bool = False) -> torch.Tensor:
    """``table[idx]`` for 2-D tables of any row width (the kernel takes any
    width; the TPU package's 128-lane packing has no counterpart here)."""
    if table.dim() != 2:
        raise ValueError("gather_rows_any handles 2D tables")
    return gather_rows(table, idx, block=block, interpret=interpret)


def reset_launches() -> int:
    """Zero the launch count; returns the count it replaced."""
    global launches
    old, launches = launches, 0
    return old
