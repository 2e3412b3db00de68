"""Row gather ``table[idx]`` — kernel K1 of the port.

Counterpart of ``mysteryann_tpu/ops/gather.py``, whose Pallas kernel drives
one async DMA per row on the TPU. Here the kernel is hand-written CUDA C++
for Hopper (``csrc/gather.cu``): a group of lanes per row, 16-byte words
where the row width and alignment allow, a grid-stride loop over rows. It
is compiled with ``nvcc`` for ``sm_90a`` at first use into the package's
``build/`` directory (git-ignored), from the sources in the checkout only,
and bound with ``ctypes`` through a plain C interface.

Routing: a CPU tensor takes the plain version, ``gather_rows_ref``
(``torch.index_select``); a CUDA tensor launches the kernel or raises —
there is no fallback from the kernel to the plain version. Indices must lie
in [0, N): callers clamp (sentinel handling is theirs). On the card an index
outside that range zeroes its output row and sets the device error flag
(``error_flag_value``); on the CPU ``index_select`` raises.

``launches`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Dict

import torch

from mysteryann_tpu_torch.ops._nvcc import CSRC, build_library

SOURCE = os.path.join(CSRC, "gather.cu")

launches = 0       # kernel launches since import (or the last reset)
build_log = ""     # compiler output of the last build (registers, spills)
_fn = None         # the bound C entry point, once loaded
_flags: Dict[int, torch.Tensor] = {}   # device index -> int32 [1] error flag


def build(force: bool = False) -> float:
    """Compile ``csrc/gather.cu`` (unless a library of the same source is
    already built) and load it. Returns the seconds spent compiling."""
    global _fn, build_log
    lib, secs, log = build_library(SOURCE, force=force)
    if log:
        build_log = log
    fn = lib.msann_gather_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fn = fn
    return secs


def _flag(device: torch.device) -> torch.Tensor:
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _flags:
        _flags[i] = torch.zeros(1, dtype=torch.int32,
                                device=torch.device("cuda", i))
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


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() < 2:
        raise ValueError("table must be at least 2D")
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-D, got shape {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"idx on {idx.device}, table on {table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")


def _gather_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    global launches
    if _fn is None:
        build()
    out = torch.empty((idx.shape[0],) + tuple(table.shape[1:]),
                      dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    row_bytes = math.prod(table.shape[1:]) * table.element_size()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = _fn(table.data_ptr(), table.shape[0], row_bytes, idx.data_ptr(),
                 int(idx.dtype == torch.int64), idx.shape[0], out.data_ptr(),
                 _flag(table.device).data_ptr(), stream)
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
    if table.device.type == "cpu":
        return gather_rows_ref(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {table.device}")
    return _gather_cuda(table, idx)


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
