"""Binned flat scan — kernel K2 of the port.

Counterpart of ``mysteryann_tpu/ops/scan.py``. For a batch of queries the
scan scores every table row with a bf16 × bf16 → f32 dot product and
max-folds each score into one of ``BINS`` = 4096 bins per query; a bin keeps
its best column. A small top-k over the bins, a column decode and
(optionally) an exact f32 rerank of the head through the row gather (K1)
finish the search. It serves ``FlatIndex(precision="scan")``.

Bin mapping (kept exactly: it decides which collisions drop). Column
``col`` lies in tile ``t = col // C_BLK``, lane group ``g = (col % C_BLK) //
128``, lane ``col % 128``; it folds into bin ``p = ((t % TG)·G + g)·128 +
lane`` with ``j = t // TG``. Decode: ``col = (j·TG + r//G)·C_BLK + (r%G)·128
+ lane``, ``r = p // 128``. A tie keeps the lowest j; a bin never written
comes out as ``+inf`` / ``j = 0``; when ``n % C_BLK != 0`` the last tile's
columns at or past ``n`` never win.

Recall model: two true top-k ids in the same bin lose the weaker one —
collision probability about k²/(2·BINS), independent of corpus size. The f32
rerank of a k·oversample head absorbs most of it.

The kernel is hand-written CUDA C++ for Hopper (``csrc/scan.cu``): one
thread block per (256-query tile, half a bin row of 64 lanes) walks its
tiles by itself, so no reduction crosses blocks. A producer warp streams the
table rows of each step into a ring of shared-memory stages by TMA; two
consumer warpgroups score them against the resident query tile with
``wgmma`` (bf16 → f32 on the tensor cores) and fold each accumulator
fragment into the running maximum and j in registers. What bounds it is
the products: 2·B·N·d flops against 989 TFLOP/s of bf16 tensor-core peak
(2.1 ms at 8,192 × 1M × 128); it writes no score to device memory. On
Gaussian data the tensor cores may sum a dot product in another order than
the plain version's matmul (``KERNEL_RTOL``); on dyadic data both are exact.
It is compiled with ``nvcc`` for ``sm_90a`` at first use into the package's
``build/`` directory (git-ignored) and bound with ``ctypes``. ``B_BLK`` is
the TPU kernel's query block; here it is the validation and padding rule
callers rely on (the kernel takes 256 queries per block).

Routing: a CPU tensor takes the plain version, ``binned_scan_ref``; a CUDA
tensor launches the kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np
import torch

from mysteryann_tpu_torch.ops._nvcc import CSRC, build_library
from mysteryann_tpu_torch.ops.distances import array_device
from mysteryann_tpu_torch.ops.sort import topk_smallest

B_BLK = 512     # query batch granularity (the TPU kernel's query block)
C_BLK = 512     # table rows per tile (G = 4 lane groups)
TG = 8          # tile-group stride: tile t folds into bin row block t % TG
G = C_BLK // 128
BINS = TG * G * 128  # 4096 bins per query
# the kernel against binned_scan_ref on Gaussian data: the tensor cores sum
# a dot product's f32 products in another order than the plain matmul
KERNEL_RTOL = 1e-5

SOURCE = os.path.join(CSRC, "scan.cu")

launches = 0       # kernel launches since import (or the last reset)
build_log = ""     # compiler output of the last build (registers, spills)
_fn = None         # the bound C entry point, once loaded


def build(force: bool = False) -> float:
    """Compile ``csrc/scan.cu`` (unless a library of the same source is
    already built) and load it. Returns the seconds spent compiling."""
    global _fn, build_log
    lib, secs, log = build_library(SOURCE, force=force)
    if log:
        build_log = log
    fn = lib.msann_binned_scan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fn = fn
    return secs


def reset_launches() -> int:
    """Zero the launch count; returns the count it replaced."""
    global launches
    old, launches = launches, 0
    return old


def _check(q: torch.Tensor, base_bf16: torch.Tensor) -> None:
    B, d = q.shape
    npad = base_bf16.shape[0]
    if B % B_BLK or npad % C_BLK or d % 128:
        raise ValueError(f"shape misfit: B={B} (need %{B_BLK}), "
                         f"N_pad={npad} (need %{C_BLK}), d={d} (need %128)")
    if base_bf16.dtype != torch.bfloat16 or base_bf16.shape[1] != d:
        raise ValueError(f"table must be bf16 [N_pad, {d}], got "
                         f"{base_bf16.dtype} {tuple(base_bf16.shape)}")
    if q.device != base_bf16.device:
        raise ValueError(f"q on {q.device}, table on {base_bf16.device}")


def _tail_start(n: int, npad: int) -> int:
    """First column the TPU kernel masks: only in the last tile, only when
    ``n % C_BLK != 0``, from ``n`` on (``npad`` when nothing is masked)."""
    if n % C_BLK == 0:
        return npad
    last = npad - C_BLK
    return min(npad, last + max(0, n - last))


def binned_scan_ref(q: torch.Tensor, base_bf16: torch.Tensor, n: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: f32 scores of the bf16 operands (exact products,
    TF32 off), the tail mask, then a fold over j in ascending order with a
    strict ``>`` (the lowest j wins a tie), B_BLK queries at a time."""
    _check(q, base_bf16)
    B = q.shape[0]
    npad = base_bf16.shape[0]
    nt = npad // C_BLK
    J = -(-nt // TG)
    tail = _tail_start(n, npad)
    table = base_bf16.float()
    qb = q.to(torch.bfloat16).float()
    out_d = torch.empty((B, BINS), dtype=torch.float32, device=q.device)
    out_j = torch.empty((B, BINS), dtype=torch.int16, device=q.device)
    for s in range(0, B, B_BLK):
        sc = qb[s:s + B_BLK] @ table.T                       # [b, npad]
        sc[:, tail:] = float("-inf")
        sc = torch.nn.functional.pad(sc, (0, J * TG * C_BLK - npad),
                                     value=float("-inf"))
        sc = sc.view(sc.shape[0], J, BINS)
        best = torch.full((sc.shape[0], BINS), float("-inf"),
                          dtype=torch.float32, device=q.device)
        bj = torch.zeros((sc.shape[0], BINS), dtype=torch.int32,
                         device=q.device)
        for j in range(J):
            win = sc[:, j] > best
            best = torch.where(win, sc[:, j], best)
            bj = torch.where(win, j, bj)
        out_d[s:s + B_BLK] = -best
        out_j[s:s + B_BLK] = bj.to(torch.int16)
    return out_d, out_j


def _scan_cuda(q: torch.Tensor, base_bf16: torch.Tensor, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    if _fn is None:
        build()
    q = q.to(torch.bfloat16).contiguous()
    if not base_bf16.is_contiguous():
        raise ValueError("the scan table must be contiguous")
    if q.data_ptr() % 16 or base_bf16.data_ptr() % 16:
        raise ValueError("q and the scan table must be 16-byte aligned")
    B, d = q.shape
    nt = base_bf16.shape[0] // C_BLK
    out_d = torch.empty((B, BINS), dtype=torch.float32, device=q.device)
    out_j = torch.empty((B, BINS), dtype=torch.int16, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _fn(q.data_ptr(), base_bf16.data_ptr(), B, nt, d, n,
                 out_d.data_ptr(), out_j.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"binned scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return out_d, out_j


def binned_scan(q: torch.Tensor, base_bf16: torch.Tensor, n: int,
                interpret: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scan: (dists f32 [B, BINS], j i16 [B, BINS]).

    ``q`` f32/bf16 [B, d] with B % B_BLK == 0; ``base_bf16`` bf16
    [N_pad, d] with N_pad % C_BLK == 0 and rows >= n zero-padded;
    d % 128 == 0. ``interpret`` is the TPU kernel's knob, accepted and
    ignored. Use `flat_scan_topk` for the full search.
    """
    del interpret
    _check(q, base_bf16)
    if q.device.type == "cpu":
        return binned_scan_ref(q, base_bf16, n)
    if q.device.type != "cuda":
        raise ValueError(f"no scan kernel for device {q.device}")
    return _scan_cuda(q, base_bf16, n)


def _scan_topk(q: torch.Tensor, base_bf16: torch.Tensor, k: int, n: int,
               interpret: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan + bin top-k (lowest bin first among ties) + column decode:
    (dists [B, k], ids [B, k] int32)."""
    dists, j = binned_scan(q, base_bf16, n, interpret=interpret)
    dd, pos = topk_smallest(dists, k)
    jj = j.gather(1, pos).to(torch.int32)
    pos = pos.to(torch.int32)
    r = pos // 128
    lane = pos % 128
    col = (jj * TG + r // G) * C_BLK + (r % G) * 128 + lane
    return dd, col


def make_scan_table(base, device: torch.device | str | None = None
                    ) -> torch.Tensor:
    """bf16 scan table on ``device`` (default: ``base``'s device for a
    tensor, else the card): rows zero-padded to a multiple of C_BLK (the
    scan masks them)."""
    if isinstance(base, torch.Tensor):
        t = base.to(device=device if device is not None else base.device,
                    dtype=torch.float32)
    else:
        t = torch.from_numpy(np.array(base, dtype=np.float32)).to(
            array_device(device))
    n, d = t.shape
    t = t.to(torch.bfloat16)
    rpad = (-n) % C_BLK
    if rpad:
        t = torch.cat([t, torch.zeros((rpad, d), dtype=torch.bfloat16,
                                      device=t.device)])
    return t.contiguous()


def flat_scan_topk(q: torch.Tensor, base_bf16: torch.Tensor, n: int, k: int,
                   base_f32: Optional[torch.Tensor] = None,
                   oversample: int = 2,
                   interpret: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``q`` in the scan table: (dists f32 [B, k], ids i32 [B, k]).

    With ``base_f32`` the k·oversample head is reranked with exact f32
    distances (row gather K1); without it, distances carry bf16-operand
    precision and the ranking is the scan's. B must be a multiple of B_BLK
    (``FlatIndex`` pads query batches).
    """
    if base_f32 is None:
        return _scan_topk(q, base_bf16, k, n, interpret=interpret)
    kk = min(k * oversample, BINS)
    _, cand = _scan_topk(q, base_bf16, kk, n, interpret=interpret)
    from mysteryann_tpu_torch.flat import _rerank_f32
    from mysteryann_tpu_torch.ops.distances import Metric
    return _rerank_f32(base_f32, q, torch.clamp(cand, max=n - 1), k,
                       Metric.IP)
