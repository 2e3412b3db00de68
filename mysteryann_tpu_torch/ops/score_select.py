"""The bf16 score product fused with the k-selection — kernel K3f of the port.

Counterpart of the TPU's matmul → ``approx_min_k`` fusion: the JAX
package's seed scan (``mysteryann_tpu/search/seeding.py``: a bf16 einsum
with an f32 result fed to ``approx_min_k``) and its exact kNN on bf16
operands (``ops/knn.py``, ``FlatIndex(precision="bf16")``) never write a
score block. For bf16 queries ``q`` [B, d] and a bf16 table ``t`` [n, d],
``score_topk`` returns the ``k`` smallest of

- ``-(q · t)`` for ip and cosine,
- ``max(q_sq - 2 (q · t) + t_sq, 0)`` for l2 (``q_sq`` f32 [B], ``t_sq`` f32
  [n], given by the caller),

per query, ascending, ties to the lower column: (values f32 [B, k], column
ids int64 [B, k]), the contract of ``topk_smallest``. Products are bf16 ×
bf16 with an f32 accumulation.

Routing: a CPU tensor takes the plain version, ``score_topk_ref`` (the f32
matmul of the bf16 values in tiles, the metric, then ``topk_smallest_ref``:
what the seed scan and the bf16 kNN computed before the kernel, bit for
bit). On a CUDA device, a call the kernel takes (``_plan``: k ≤ ``MAX_K``,
k ≤ n, the shared memory fits) launches it — hand-written CUDA C++ for
Hopper (``csrc/score_select.cu``: TMA + ``wgmma``, K3's selection on the
accumulators), compiled with ``nvcc`` for ``sm_90a`` at first use and bound
with ``ctypes`` — and any other goes to the unfused route, the same tiled
matmul selected by K3. A build or launch error raises.

The kernel reads rows by TMA, which needs each row to start 16 bytes
apart: a pitch of a multiple of 8 elements. A table made by
``aligned_rows`` (the seed sample, ``FlatIndex``'s bf16 copy) is read in
place; any other with d % 8 != 0 is copied, padded, on every call.

The kernel sums a dot product in another order than a matmul does, so it
does not match the plain version bit for bit: ``check_tolerance`` states
and checks the bound (every value within ε of the f64 distance of its own
column; the id sets equal but for near-ties at the k-th place; each row
ascending). ``launches`` counts kernel launches; a split's partial rows are
merged by a K3 launch, counted as K3's. ``unfused_launches`` counts the CUDA
calls that took the unfused route.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import NamedTuple, Optional, Tuple

import torch

from mysteryann_tpu_torch.ops._nvcc import CSRC, build_library
from mysteryann_tpu_torch.ops.distances import Metric
from mysteryann_tpu_torch.ops.select import device_info
from mysteryann_tpu_torch.ops.sort import topk_smallest, topk_smallest_ref

SOURCE = os.path.join(CSRC, "score_select.cu")

MAX_K = 256              # the warp queue's widest (K3's MAX_K)
NT = 128                 # table rows a step (csrc NT)
KC = 64                  # dimensions a TMA box row (csrc KC)
T_BYTES = NT * KC * 2    # a ring stage
MAX_STAGES = 8
MIN_STAGES = 2
SMEM_LIMIT = 232448      # per block, sm_90
SMEM_SLACK = 1024 + 8 * (2 * MAX_STAGES + 1)
SMALL_BATCH = 64         # B up to this: one consumer warpgroup (64 queries)
BUF = 32                 # candidate buffer keys a query (csrc kBuf) ...
SMALL_BUF = 24           # ... or these, beside a queue of 32 and a narrow box
PREFILTER_STEPS = 2048   # shares of this many steps or more: the pre-filter
PREFILTER_QUEUE = 64     # ... at queues up to this
STAGE_WARP = 32 * 4 + 64   # staged scores a consumer warp (csrc STAGE_WARP)
# msann_score_select's one argument: q, t, q_sq, t_sq, values, ids, B, n,
# d, q's and t's row pitches, k, l2, ld, consumers, split cols, splits,
# queue, stages, the last chunk's box columns, buffer keys, pre-filter, stream
_pack_args = struct.Struct("23q").pack

launches = 0        # kernel launches since import (or the last reset)
unfused_launches = 0    # CUDA calls that took the unfused route
build_log = ""      # compiler output of the last build (registers, spills)
_fn = None          # the bound C entry point, once loaded


class Plan(NamedTuple):
    consumers: int      # consumer warpgroups, 64 queries each
    queue: int          # N = 32 x KPL >= k
    stages: int         # table stages in the ring
    tiles: int          # query tiles of 64 x consumers
    splits: int         # column shares a query tile
    split_cols: int     # columns a share, a multiple of NT
    smem: int           # dynamic shared memory bytes
    tail_cols: int      # the last chunk's box: 64, 32 or 16 columns
    kslices: int        # wgmma k-slices a warpgroup issues a step
    buf: int            # candidate buffer keys a query: 24 or 32
    prefilter: bool     # ip: a quiet step's maximum may end it (long shares)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2(v: int, least: int) -> int:
    p = least
    while p < v:
        p *= 2
    return p


def padded_dim(d: int) -> int:
    """The least row pitch the kernel reads rows of width ``d`` at: a
    multiple of 8 elements (TMA's 16-byte row pitch)."""
    return _cdiv(d, 8) * 8


def _is_aligned(x: torch.Tensor) -> bool:
    return (x.stride(1) == 1 and x.stride(0) % 8 == 0
            and x.stride(0) >= x.shape[1] and x.data_ptr() % 16 == 0)


def aligned_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` [n, d] with rows the kernel reads in place: ``x`` itself when
    its rows start 16 bytes apart, else a [:, :d] view of a zero-padded
    [n, padded_dim(d)] copy. Make a table with it once, so that calls copy
    nothing."""
    if _is_aligned(x):
        return x
    d = x.shape[1]
    out = x.new_zeros((x.shape[0], padded_dim(d)))
    out[:, :d] = x
    return out[:, :d]


def tail_slices(d: int) -> int:
    """The wgmma k-slices (16 dimensions each) of a row's last chunk."""
    return _cdiv(d - KC * (_cdiv(d, KC) - 1), 16)


def _step_bytes(chunks: int, tail_cols: int) -> int:
    return (chunks - 1) * T_BYTES + NT * tail_cols * 2


def _stage_off(s: int, chunks: int, tail_cols: int) -> int:
    """Stage ``s``'s offset in the ring (csrc stage_off): whole steps, then
    full stages."""
    return s // chunks * _step_bytes(chunks, tail_cols) + s % chunks * T_BYTES


def smem_bytes(chunks: int, consumers: int, queue: int, stages: int,
               tail_cols: int = KC, buf: int = BUF) -> int:
    """The query tile, the ring, the queues and buffers of ``buf`` keys a
    query, the staged scores and the buffers' counts (csrc smem_bytes)."""
    qt = 64 * consumers
    return (SMEM_SLACK + qt * ((chunks - 1) * KC + tail_cols) * 2
            + _stage_off(stages, chunks, tail_cols)
            + qt * (queue + buf) * 8
            + 4 * consumers * STAGE_WARP * 8 + qt * 4)


def _ring(chunks: int, consumers: int, queue: int, tail: int,
          prefilter: bool):
    """(stages, tail box columns, buffer keys) of the deepest ring that
    fits: full boxes and BUF-key buffers (the base loop's), or, under the
    pre-filter, the last chunk in a box of 16 or 32 columns where its
    k-slices fit one and the ring of whole steps is deeper for it, with
    SMALL_BUF-key buffers beside a queue of 32. The kernel has an instance
    for each."""
    def fit(tail_cols, buf):
        room = SMEM_LIMIT - smem_bytes(chunks, consumers, queue, 0,
                                       tail_cols, buf)
        if tail_cols == KC:
            return min(MAX_STAGES, room // T_BYTES)
        return min(MAX_STAGES // chunks,
                   room // _step_bytes(chunks, tail_cols)) * chunks

    ring = (fit(KC, BUF), KC, BUF)
    if prefilter and tail <= 2:
        buf = SMALL_BUF if queue == 32 else BUF
        narrow = (fit(16 * tail, buf), 16 * tail, buf)
        if narrow[0] > ring[0]:
            return narrow
    return ring


def _plan(B: int, n: int, d: int, k: int, n_sms: int) -> Optional[Plan]:
    """The launch of ``k`` smallest of ``B`` queries against ``n`` rows of
    width ``d`` on a card with ``n_sms`` SMs, or None when the kernel does
    not take the call (k past MAX_K or n, a table too long for TMA's int32
    coordinates, shared memory). Any B, n and d >= 1: TMA reads a batch
    under a tile, a table under a step and d under a box as zeros. Pure.

    One query tile is 128 queries (two consumer warpgroups), or 64 when B
    <= SMALL_BATCH or when two stages of 128 do not fit with full boxes and
    32-key buffers; each query keeps a queue of the least 32 x 2^i >= k keys
    and a candidate buffer; the ring takes what shared memory is left, up
    to MAX_STAGES. The columns are split into shares so the grid holds
    about one block an SM (tiles x splits ≈ n_sms), each share a multiple
    of NT columns, the last one at least k.

    Where a block's share is PREFILTER_STEPS steps or more and the queue
    at most PREFILTER_QUEUE, ip ends a step whose largest scores miss every
    filter with one vote (``prefilter``), and the last chunk takes a narrow
    box and its buffers SMALL_BUF keys where that deepens the ring
    (``_ring``; a warpgroup then issues only the k-slices that hold
    dimensions). On shorter shares the queues are still filling through
    most steps: the pre-filter cost 4-6% at 1,000-2,000 steps, and the
    deeper ring alone bought nothing. Both thresholds come from kernel
    timings at a few shapes; only the T2I cell's side of them is measured
    end to end."""
    if not 1 <= k <= min(MAX_K, n) or n + 2 * NT >= 1 << 31:
        return None
    chunks = _cdiv(d, KC)
    tail = tail_slices(d)
    queue = _pow2(k, 32)
    consumers = 1 if B <= SMALL_BATCH or smem_bytes(
        chunks, 2, queue, MIN_STAGES) > SMEM_LIMIT else 2
    tiles = _cdiv(B, 64 * consumers)
    splits = max(1, n_sms // tiles)
    while True:
        cols = _cdiv(_cdiv(n, splits), NT) * NT
        used = _cdiv(n, cols)
        if used == 1 or n - (used - 1) * cols >= k:
            break
        splits -= 1
    prefilter = queue <= PREFILTER_QUEUE and cols // NT >= PREFILTER_STEPS
    stages, tail_cols, buf = _ring(chunks, consumers, queue, tail, prefilter)
    if stages < MIN_STAGES:
        return None
    return Plan(consumers, queue, stages, tiles, used, cols,
                smem_bytes(chunks, consumers, queue, stages, tail_cols, buf),
                tail_cols, 4 * chunks - (4 - tail if tail_cols < KC else 0),
                buf, prefilter)


def plan_for(q: torch.Tensor, t: torch.Tensor, k: int) -> Optional[Plan]:
    """The plan ``score_topk`` takes for these CUDA operands, or None (the
    unfused route)."""
    return _plan(q.shape[0], t.shape[0], t.shape[1], k,
                 device_info(q.get_device()).n_sms)


def build(force: bool = False) -> float:
    """Compile ``csrc/score_select.cu`` (unless a library of the same source
    is already built) and load it. Returns the seconds spent compiling."""
    global _fn, build_log
    lib, secs, log = build_library(SOURCE, force=force)
    if log:
        build_log = log
    fn = lib.msann_score_select
    fn.argtypes, fn.restype = [ctypes.c_char_p], ctypes.c_int
    _fn = fn
    return secs


def reset_launches() -> int:
    """Zero the launch counts; returns the kernel's count it replaced."""
    global launches, unfused_launches
    old, launches, unfused_launches = launches, 0, 0
    return old


def _check_args(q: torch.Tensor, t: torch.Tensor, metric: Metric,
                q_sq, t_sq) -> None:
    if q.dtype != torch.bfloat16 or t.dtype != torch.bfloat16:
        raise TypeError(f"K3f takes bf16 operands, got {q.dtype} and "
                        f"{t.dtype}")
    if q.dim() != 2 or t.dim() != 2 or q.shape[1] != t.shape[1]:
        raise ValueError(f"shape misfit: q {tuple(q.shape)}, t "
                         f"{tuple(t.shape)}")
    if q.device != t.device:
        raise ValueError(f"q on {q.device}, t on {t.device}")
    if metric == Metric.L2 and (q_sq is None or t_sq is None):
        raise ValueError("l2 needs q_sq [B] and t_sq [n]")


def _score_tile_fn(q, t, metric: Metric, q_sq, t_sq):
    """score_tile(t0, t1): the f32 distances [B, t1 - t0] of the plain
    version (the f32 matmul of the bf16 values, TF32 off, then the metric,
    in the JAX package's order)."""
    qf = q.float()
    qs = q_sq.float()[:, None] if metric == Metric.L2 else None

    def score_tile(t0, t1):
        ip = qf @ t[t0:t1].float().t()
        if qs is None:
            return -ip
        # clamp: the bf16 ip can push ||q-t||² ulp-negative for a query
        # equal to a table row
        return torch.clamp(qs - 2.0 * ip + t_sq[t0:t1].float(), min=0.0)

    return score_tile


def _tiled(q, t, k, metric, q_sq, t_sq, tile, select):
    from mysteryann_tpu_torch.ops.knn import _tiled_topk
    n = t.shape[0]
    vals, ids = _tiled_topk(_score_tile_fn(q, t, metric, q_sq, t_sq),
                            q.shape[0], n, k, tile or n, q.device, select)
    return vals, ids.long()


def score_topk_ref(q: torch.Tensor, t: torch.Tensor, k: int,
                   metric: Metric | str, q_sq: Optional[torch.Tensor] = None,
                   t_sq: Optional[torch.Tensor] = None,
                   tile: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the f32 matmul of the bf16 values, then the
    metric, then ``topk_smallest_ref``, over column tiles of at most
    ``tile`` (fewer when memory is short; the result does not depend on the
    tile) with an exact running merge."""
    metric = Metric.parse(metric)
    _check_args(q, t, metric, q_sq, t_sq)
    return _tiled(q, t, k, metric, q_sq, t_sq, tile, topk_smallest_ref)


def _score_topk_cuda(q, t, k, metric: Metric, q_sq, t_sq, plan: Plan):
    global launches
    if _fn is None:
        build()
    B, n, d = q.shape[0], t.shape[0], q.shape[1]
    qp, tp = aligned_rows(q), aligned_rows(t)
    l2 = metric == Metric.L2
    qs = q_sq.float().contiguous() if l2 else None
    ts = t_sq.float().contiguous() if l2 else None
    ld = plan.splits * k
    vals = torch.empty((B, ld), dtype=torch.float32, device=q.device)
    ids = torch.empty((B, ld), dtype=torch.int64, device=q.device)
    args = _pack_args(
        qp.data_ptr(), tp.data_ptr(), qs.data_ptr() if l2 else 0,
        ts.data_ptr() if l2 else 0, vals.data_ptr(), ids.data_ptr(), B,
        n, d, qp.stride(0), tp.stride(0), k, int(l2), ld, plan.consumers,
        plan.split_cols, plan.splits, plan.queue, plan.stages,
        plan.tail_cols, plan.buf, int(plan.prefilter),
        torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        rc = _fn(args)
    if rc != 0:
        raise RuntimeError(f"score-select kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    if plan.splits == 1:
        return vals, ids
    # the shares' rows, each ascending and in column order: K3 merges them
    # on (value, position), which orders as (value, column)
    mv, pos = topk_smallest(vals, k)
    return mv, ids.gather(1, pos)


def _route(device: torch.device, plan: Optional[Plan]) -> str:
    """"plain" (a CPU tensor), "k3f" (a CUDA call the kernel takes) or
    "unfused" (any other CUDA call: the tiled matmul selected by K3)."""
    if device.type == "cpu":
        return "plain"
    if device.type != "cuda":
        raise ValueError(f"no score-select kernel for device {device}")
    return "k3f" if plan is not None else "unfused"


def score_topk(q: torch.Tensor, t: torch.Tensor, k: int,
               metric: Metric | str, q_sq: Optional[torch.Tensor] = None,
               t_sq: Optional[torch.Tensor] = None,
               tile: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values f32 [B, k], column ids int64 [B, k]) of the ``k`` smallest
    distances of bf16 queries ``q`` to the bf16 table ``t``, ascending,
    ties to the lower column. CPU: the plain version; CUDA: K3f, or the
    unfused route (tiles of at most ``tile`` columns selected by K3) where
    ``_plan`` refuses the call."""
    global unfused_launches
    metric = Metric.parse(metric)
    _check_args(q, t, metric, q_sq, t_sq)
    plan = (plan_for(q, t, k) if q.device.type == "cuda" and q.shape[0]
            else None)
    route = _route(q.device, plan)
    if route == "plain":
        return score_topk_ref(q, t, k, metric, q_sq, t_sq, tile)
    if route == "unfused":
        unfused_launches += 1
        return _tiled(q, t, k, metric, q_sq, t_sq, tile, topk_smallest)
    return _score_topk_cuda(q, t, k, metric, q_sq, t_sq, plan)


# ------------------------------ the tolerance ------------------------------


def _exact(q, t, cols, metric: Metric, q_sq, t_sq):
    """(f64 distance, ε) of each (query, column) in ``cols`` [B, m]:
    ε = d · 2⁻²⁴ · Σ|qᵢ tᵢ| (+ 2⁻²³ (q_sq + t_sq) for l2)."""
    qd = q.double()[:, None, :]
    td = t[cols].double()
    prod = qd * td
    ip = prod.sum(-1)
    eps = q.shape[1] * 2.0 ** -24 * prod.abs().sum(-1)
    if metric != Metric.L2:
        return -ip, eps
    qs, tsq = q_sq.double()[:, None], t_sq.double()[cols]
    return (torch.clamp(qs - 2.0 * ip + tsq, min=0.0),
            eps + 2.0 ** -23 * (qs.abs() + tsq.abs()))


def _plain(q, t, cols, metric: Metric, q_sq, t_sq):
    """The plain version's f32 distance of each (query, column) in ``cols``."""
    ip = (q.float()[:, None, :] * t[cols].float()).sum(-1)
    if metric != Metric.L2:
        return -ip
    return torch.clamp(q_sq.float()[:, None] - 2.0 * ip
                       + t_sq.float()[cols], min=0.0)


def check_tolerance(q: torch.Tensor, t: torch.Tensor, metric: Metric | str,
                    got: Tuple[torch.Tensor, torch.Tensor],
                    want: Tuple[torch.Tensor, torch.Tensor],
                    q_sq: Optional[torch.Tensor] = None,
                    t_sq: Optional[torch.Tensor] = None,
                    rows: int = 512) -> dict:
    """Hold a fused result ``got`` against the plain version's ``want``
    (each (values [B, k], ids [B, k])). With ε(q, t) = d · 2⁻²⁴ · Σᵢ |qᵢ tᵢ|
    in f64 (+ 2⁻²³ (q_sq + t_sq) for l2):

    - every returned value is within ε of the f64 distance of its own
      (query, column);
    - the id sets are equal, except for columns whose plain distance lies
      within ε(q, t) + ε(q, t_k) of the plain k-th distance, t_k the column
      at the plain k-th place;
    - each row is ascending by (value, column).

    Returns {"ok", "why" (the first failure), "max_abs_err" (against the
    plain version's value of the same column, over the columns both
    return), "max_err_over_eps", "ids_differ" (entries outside the other
    set)}; ``rows`` queries are checked at a time."""
    from mysteryann_tpu_torch.ops.sort import order_key
    metric = Metric.parse(metric)
    gv, gi = got
    wv, wi = want
    out = {"ok": True, "why": "", "max_abs_err": 0.0,
           "max_err_over_eps": 0.0, "ids_differ": 0}

    def fail(why):
        if out["ok"]:
            out.update(ok=False, why=why)

    if gv.shape != wv.shape or gi.shape != wi.shape:
        fail(f"shapes {tuple(gv.shape)} vs {tuple(wv.shape)}")
        return out
    B, k = gi.shape
    for r0 in range(0, B, rows):
        sl = slice(r0, min(B, r0 + rows))
        qq = q[sl]
        qs = q_sq[sl] if q_sq is not None else None
        g_v, g_i, w_v, w_i = gv[sl], gi[sl], wv[sl], wi[sl]
        ex, eps = _exact(qq, t, g_i, metric, qs, t_sq)
        err = (g_v.double() - ex).abs()
        ratio = float((err / eps.clamp(min=1e-300)).max()) if k else 0.0
        out["max_err_over_eps"] = max(out["max_err_over_eps"], ratio)
        if bool((err > eps).any()):
            fail("a value lies farther than ε from its column's f64 "
                 "distance")
        # ascending by (value image, column), strictly
        img = order_key(g_v).long()
        lex = img[:, 1:] * (1 << 32) + g_i[:, 1:] > \
            img[:, :-1] * (1 << 32) + g_i[:, :-1]
        if k > 1 and not bool(lex.all()):
            fail("a row is not ascending by (value, column)")
        # values against the plain version's at the same column
        same = g_i[:, :, None] == w_i[:, None, :]
        both = same.any(-1)
        plain_v = (same * w_v[:, None, :].double()).sum(-1)
        if bool(both.any()):
            out["max_abs_err"] = max(out["max_abs_err"], float(
                (g_v.double() - plain_v).abs()[both].max()))
        # the id sets: the columns in one set only must be near-ties
        extra_g = ~both
        extra_w = ~(w_i[:, :, None] == g_i[:, None, :]).any(-1)
        out["ids_differ"] += int(extra_g.sum()) + int(extra_w.sum())
        if bool(extra_g.any()) or bool(extra_w.any()):
            kth = w_v[:, k - 1:k].double()
            _, eps_k = _exact(qq, t, w_i[:, k - 1:k], metric, qs, t_sq)
            _, eps_g = _exact(qq, t, g_i, metric, qs, t_sq)
            _, eps_w = _exact(qq, t, w_i, metric, qs, t_sq)
            pg = _plain(qq, t, g_i, metric, qs, t_sq).double()
            far_g = (pg - kth).abs() > eps_g + eps_k
            far_w = (w_v.double() - kth).abs() > eps_w + eps_k
            if bool((far_g & extra_g).any()) or bool((far_w & extra_w).any()):
                fail("the id sets differ beyond a near-tie at the k-th "
                     "place")
    return out
