"""k-selection, the k smallest of every row — kernel K3 of the port.

Counterpart of the TPU's partial-reduce selection (``jax.lax.approx_min_k``,
exact on the JAX package's CPU backend) and of its exact ``lax.top_k``: every
selection of the port goes through ``ops/sort.py::topk_smallest``, which
routes a CUDA tensor here. The kernel is hand-written CUDA C++ for Hopper
(``csrc/select.cu``, Faiss's WarpSelect / BlockSelect), compiled with
``nvcc`` for ``sm_90a`` at first use into the package's ``build/``
directory (git-ignored) and bound with ``ctypes`` through a plain C
interface.

Routes, chosen by the pure ``_plan``, both launching the kernel:

- ``"k3"``, ``k <= MAX_K``: one warp a row, or several warps of one block
  for a long row when rows are few; a per-lane compare against the running
  k-th key and a bitonic merge of the candidates into a queue held across
  the warp's registers.
- ``"wide"``, any larger ``k <= n``: one block a row selects, then sorts
  only k keys: a radix select of the k-th composite key (8 bits a pass,
  shared-memory histograms), one pass collecting the k keys at or below
  it, and a sort of those k padded to a power of two ``L`` (warp segments
  in registers, bitonic merges in shared memory). For ``L >
  SMEM_SORT_KEYS`` the keys go through global scratch: chunks of
  ``SMEM_SORT_KEYS`` sorted in shared memory, then merged pairwise (the
  IVF exactness gates select every cluster: k = n = 2,000, 6,324, 14,142).
  The row is copied to shared memory when it fits beside the sort buffer.

Rows are read with their own stride; only a tensor whose rows one stride
cannot address (a non-unit column stride, unmergeable leading dims) is
copied first. The kernel takes float32, the dtype of every score block the
port selects on; another dtype raises.

The kernel compares the same 64-bit (order image, column) key as the plain
version (``sort.topk_smallest_ref``), so both return the same bits on any
input. A build or launch error raises; no route is taken because the kernel
failed.

``launches`` counts kernel launches and ``wide_launches`` those of the
``wide`` route among them, so a run can show that its main path went
through K3.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from mysteryann_tpu_torch.ops._nvcc import CSRC, build_library

SOURCE = os.path.join(CSRC, "select.cu")

MAX_K = 256                 # the warp queue's widest: 32 lanes x 8 keys
ROW_THREADS = 128           # one warp a row: 4 rows a block
MAX_WARPS_PER_ROW = 8       # a block of 256 threads on one row
MIN_COLS_PER_WARP = 4096    # a row is split only into shares this long
WARPS_PER_SM = 32           # resident warps a call should give every SM
WIDE_THREADS = 256          # the wide route: one block a row (kWideThreads)
WIDE_MIN_SORT = 512         # its narrowest sort (kMinSort)
SMEM_SORT_KEYS = 8192       # its widest sort in shared memory (kSmemSort)
WIDE_SMEM = 200 << 10       # its dynamic shared memory, at most (kWideSmem)
# msann_select's one argument: x, rows, n, row stride, k, values, indices,
# queue keys or sort length, row cached, scratch, warps per row, grid,
# threads, stream
_pack_args = struct.Struct("14q").pack

launches = 0        # kernel launches since import (or the last reset)
wide_launches = 0   # those of the wide route
build_log = ""      # compiler output of the last build (registers, spills)
_fn = None          # the bound C entry point, once loaded
_get_device = None  # () -> index of the current CUDA device
_raw_stream = None  # (device index) -> current stream as an int
_devices: Dict[int, "DeviceInfo"] = {}


class DeviceInfo(NamedTuple):
    """What a plan needs to know of a device (read once per device)."""
    n_sms: int


class Plan(NamedTuple):
    route: str            # "k3" (the warp queue) or "wide" (select + sort)
    copy: bool            # copy to contiguous rows first
    queue: int            # k3: keys in the queue; wide: the sort length L
    cache: bool           # wide: the row copied to shared memory once
    scratch: int          # wide: int64 keys of global scratch (L > 8192)
    warps_per_row: int
    grid: int
    threads: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2(v: int, least: int) -> int:
    p = least
    while p < v:
        p *= 2
    return p


def _plan(k: int, n: int, rows: int, dtype: torch.dtype,
          row_stride: Optional[int], dev: DeviceInfo) -> Plan:
    """The route and launch shape of ``k`` smallest of ``rows`` rows of
    ``n`` columns of ``dtype``, their starts ``row_stride`` elements apart
    (None: no one stride addresses them), on ``dev``. Pure.

    k <= MAX_K: one warp a row, 4 rows a block, unless the rows are too
    few to give every SM WARPS_PER_SM warps: then W warps of one block
    share a row (W a power of two up to MAX_WARPS_PER_ROW, each share at
    least MIN_COLS_PER_WARP columns). The queue holds 32 x 1, 2, 4 or 8
    keys, the least that holds k. Wider k: a block a row, sorting L keys,
    the least power of two from WIDE_MIN_SORT that holds k; the row is
    cached in shared memory when it fits beside a sort buffer of L keys
    (L <= SMEM_SORT_KEYS) within WIDE_SMEM; past SMEM_SORT_KEYS the keys
    sort through 2 x rows x L keys of global scratch."""
    if dtype != torch.float32:
        raise TypeError(f"K3 selects on float32 scores, got {dtype}")
    copy = row_stride is None
    if k > MAX_K:
        sort = _pow2(k, WIDE_MIN_SORT)
        in_smem = sort <= SMEM_SORT_KEYS
        cache = (8 * sort if in_smem else 0) + 4 * n <= WIDE_SMEM
        return Plan("wide", copy, sort, cache,
                    0 if in_smem else 2 * rows * sort, 1, max(1, rows),
                    WIDE_THREADS)
    queue = _pow2(k, 32)
    want = _cdiv(dev.n_sms * WARPS_PER_SM, max(1, rows))
    w = 1
    while (w < MAX_WARPS_PER_ROW and w < want
           and n >= 2 * w * MIN_COLS_PER_WARP):
        w *= 2
    if w == 1:
        rows_per_block = ROW_THREADS // 32
        return Plan("k3", copy, queue, False, 0, 1,
                    max(1, _cdiv(rows, rows_per_block)), ROW_THREADS)
    return Plan("k3", copy, queue, False, 0, w, max(1, rows), 32 * w)


def build(force: bool = False) -> float:
    """Compile ``csrc/select.cu`` (unless a library of the same source is
    already built) and load it. Returns the seconds spent compiling."""
    global _fn, _get_device, _raw_stream, build_log
    lib, secs, log = build_library(SOURCE, force=force)
    if log:
        build_log = log
    fn = lib.msann_select
    fn.argtypes, fn.restype = [ctypes.c_char_p], ctypes.c_int
    _get_device = getattr(torch._C, "_cuda_getDevice",
                          torch.cuda.current_device)
    _raw_stream = getattr(
        torch._C, "_cuda_getCurrentRawStream",
        lambda d: torch.cuda.current_stream(d).cuda_stream)
    _fn = fn
    return secs


def device_info(index: int) -> DeviceInfo:
    """The plan's view of CUDA device ``index``, read once."""
    if index not in _devices:
        props = torch.cuda.get_device_properties(index)
        _devices[index] = DeviceInfo(props.multi_processor_count)
    return _devices[index]


def _rows_view(x: torch.Tensor) -> Tuple[Optional[torch.Tensor], Optional[int]]:
    """``x`` as [rows, n] with unit column stride and its row stride, or
    (None, None) when one stride cannot address its rows."""
    n = x.shape[-1]
    if x.stride(-1) != 1 and n > 1:
        return None, None
    try:
        x2 = x.view(-1, n)
    except RuntimeError:
        return None, None
    return x2, x2.stride(0)


def plan_for(x: torch.Tensor, k: int) -> Plan:
    """The plan ``topk_smallest_cuda`` takes for the ``k`` smallest along
    the last dim of the CUDA tensor ``x``."""
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    return _plan(k, n, rows, x.dtype, _rows_view(x)[1] if rows else n,
                 device_info(x.get_device()))


def _launch(x2: torch.Tensor, stride: int, k: int, plan: Plan,
            vals: torch.Tensor, idx: torch.Tensor) -> None:
    global launches, wide_launches
    if _fn is None:
        build()
    d = x2.get_device()
    scratch = (torch.empty(plan.scratch, dtype=torch.int64, device=x2.device)
               if plan.scratch else None)
    args = _pack_args(x2.data_ptr(), x2.shape[0], x2.shape[1], stride, k,
                      vals.data_ptr(), idx.data_ptr(), plan.queue,
                      int(plan.cache),
                      scratch.data_ptr() if scratch is not None else 0,
                      plan.warps_per_row, plan.grid, plan.threads,
                      _raw_stream(d))
    if d == _get_device():
        rc = _fn(args)
    else:
        with torch.cuda.device(d):
            rc = _fn(args)
    if rc != 0:
        raise RuntimeError(f"select kernel launch failed: CUDA error {rc}")
    launches += 1
    wide_launches += plan.route == "wide"


def topk_smallest_cuda(x: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [..., k], indices [..., k] int64) of the ``k`` smallest along
    the last dim of a float32 CUDA tensor, ascending, ties to the lower
    column: K3, on the route ``_plan`` picks."""
    if x.device.type != "cuda":
        raise ValueError(f"no select kernel for device {x.device}")
    n = x.shape[-1]
    if k > n or k < 0:
        raise RuntimeError(f"selected index k out of range: k={k}, n={n}")
    rows = x.numel() // n if n else 0
    x2, stride = _rows_view(x) if rows else (None, n)
    plan = _plan(k, n, rows, x.dtype, stride, device_info(x.get_device()))
    shape = tuple(x.shape[:-1]) + (k,)
    vals = torch.empty(shape, dtype=x.dtype, device=x.device)
    idx = torch.empty(shape, dtype=torch.int64, device=x.device)
    if vals.numel() == 0:
        return vals, idx
    if n >= 1 << 32:
        raise ValueError(f"K3 selects over fewer than 2^32 columns, got {n}")
    if plan.copy:
        x2, stride = x.contiguous().view(-1, n), n
    _launch(x2, stride, k, plan, vals, idx)
    return vals, idx


def reset_launches() -> int:
    """Zero both counts; returns the kernel count it replaced."""
    global launches, wide_launches
    old, launches, wide_launches = launches, 0, 0
    return old
