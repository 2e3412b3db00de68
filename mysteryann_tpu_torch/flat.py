"""Flat (brute-force) index — exact search as a serving mode.

Port of ``mysteryann_tpu/flat.py``. The reference exists because CPUs
cannot brute-force million-scale corpora per query (hence graphs + SIMD,
reference distance.h / index_bipartite.cpp); an accelerator computes a
whole [queries, corpus] distance block per batch, so an exact scan is a
serving mode of its own. It is O(N) per query.

Four precisions; each keeps the f32 base resident on the device:

- ``"f32"``: an exact f32 scan (``ops.knn.exact_knn_device``).
- ``"bf16"``: the scan reads a bf16 copy of the table (f32 scores of bf16
  operands), then the k·oversample head is reranked in exact f32 through
  the row gather (K1). Resident: the f32 base and the bf16 table.
- ``"int8"``: an int8 scan — one global scale for IP/cosine, per-row scales
  (required) for L2 — then the same f32 rerank. Resident: the f32 base, the
  int8 table and its scales (and row norms for L2).
- ``"scan"``: the binned scan (kernel K2, ``ops/scan.py``) over a bf16
  table padded to 512 rows, then the f32 rerank. IP/cosine only,
  d % 128 == 0. Resident: the f32 base and the padded bf16 table.

Reported distances are exact f32 in every precision; with bf16, int8 and
scan only the choice of candidates carries the narrower type's rounding.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from mysteryann_tpu_torch.index import register_index
from mysteryann_tpu_torch.ops.distances import Metric, prepare_vectors
from mysteryann_tpu_torch.ops.gather import gather_rows_any
from mysteryann_tpu_torch.ops.knn import (exact_knn_device,
                                          int8_global_knn_device,
                                          int8_knn_device,
                                          quantize_global_int8,
                                          quantize_rows_int8)
from mysteryann_tpu_torch.ops.score_select import aligned_rows
from mysteryann_tpu_torch.ops.sort import topk_smallest
from mysteryann_tpu_torch.utils.trace import tracer


def _rerank_f32(base: torch.Tensor, q: torch.Tensor, cand_i: torch.Tensor,
                k: int, metric: Metric) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 rescoring of per-query candidate ids [B, kk] (row gather
    K1): (dists [B, k], ids [B, k]), ties to the earlier candidate."""
    B, kk = cand_i.shape
    d = base.shape[1]
    vecs = gather_rows_any(base, cand_i.reshape(-1).contiguous()
                           ).reshape(B, kk, d)
    ip = torch.bmm(vecs, q[:, :, None]).squeeze(-1)
    if metric in (Metric.IP, Metric.COSINE):
        dists = -ip
    else:
        dists = (torch.sum(q * q, 1, keepdim=True) - 2.0 * ip
                 + torch.sum(vecs * vecs, 2))
    vals, pos = topk_smallest(dists, k)
    return vals, cand_i.gather(1, pos)


@register_index("flat")
class FlatIndex:
    """Device-resident exact-search index (see the module docstring for
    what each ``precision`` keeps resident)."""

    def __init__(self, base, metric: Metric | str = Metric.IP,
                 tile: int = 262144, oversample: int = 2,
                 precision: str = "f32", recall_target: float = 0.95,
                 int8_scale: str = "auto",
                 device: torch.device | str | None = None):
        """``base`` is a numpy array or a tensor; everything lives on
        ``device`` (default: ``base``'s device for a tensor, else the card;
        ``device="cpu"`` runs on the CPU). ``recall_target`` is kept for
        call-site parity: selection is exact.
        """
        if precision not in ("f32", "bf16", "int8", "scan"):
            raise ValueError(f"unknown precision {precision!r}")
        if int8_scale not in ("auto", "row", "global"):
            raise ValueError(f"unknown int8_scale {int8_scale!r}")
        self.metric = Metric.parse(metric)
        self.precision = precision
        self.recall_target = recall_target
        self.base = prepare_vectors(base, self.metric, device)
        self.device = self.base.device
        self.tile = min(tile, self.base.shape[0])
        self.oversample = oversample
        if precision == "int8":
            # "global": one base-side scale, raw s32 scores rank (IP/cosine
            # only); "row": per-row scales, tighter, required for L2
            if int8_scale == "auto":
                int8_scale = ("row" if self.metric == Metric.L2
                              else "global")
            if int8_scale == "global" and self.metric == Metric.L2:
                raise ValueError("int8_scale='global' supports ip/cosine "
                                 "only (L2 needs per-row norms)")
            self.int8_scale = int8_scale
            if int8_scale == "global":
                self.base_i8, self.base_scale = quantize_global_int8(
                    self.base)
                self.base_norm = None
            else:
                self.base_i8, self.base_scale = quantize_rows_int8(self.base)
                self.base_norm = (torch.sum(self.base * self.base, dim=1)
                                  if self.metric == Metric.L2 else None)
        elif precision == "bf16":
            # rows 16 bytes apart: the fused scan (K3f) reads it in place
            self.base_bf16 = aligned_rows(self.base.to(torch.bfloat16))
        elif precision == "scan":
            from mysteryann_tpu_torch.ops.scan import make_scan_table
            if self.metric == Metric.L2:
                raise ValueError("precision='scan' supports ip/cosine only")
            d = self.base.shape[1]
            if d % 128:
                raise ValueError(f"precision='scan' needs dim % 128 == 0 "
                                 f"(got d={d}); pad the vectors or use "
                                 f"'f32'/'int8'")
            self.scan_table = make_scan_table(self.base)

    @property
    def n_base(self) -> int:
        return self.base.shape[0]

    def _search_batch(self, qs: torch.Tensor, k: int, kk: int, tr):
        """(ids [qb, k], dists [qb, k]) of one padded query batch: the scan
        (``msann.flat.scan``), then, below f32, the exact f32 rerank of its
        head (``msann.flat.rerank``)."""
        with tr.span("msann.flat.scan"):
            if self.precision == "f32":
                dd, ii = exact_knn_device(qs, self.base, k=kk,
                                          metric=self.metric, tile=self.tile)
                return ii[:, :k], dd[:, :k]
            # the bounds the head's ids are clamped to before the rerank
            # gathers their rows
            lo, hi = 0, None
            if self.precision == "scan":
                from mysteryann_tpu_torch.ops.scan import BINS, flat_scan_topk
                _, ii = flat_scan_topk(qs, self.scan_table, self.n_base,
                                       min(k * self.oversample, BINS))
                lo, hi = None, self.n_base - 1
            elif self.precision == "bf16":
                _, ii = exact_knn_device(qs.to(torch.bfloat16),
                                         self.base_bf16, k=kk,
                                         metric=self.metric, tile=self.tile)
            elif self.int8_scale == "global":
                q_i8, _ = quantize_rows_int8(qs)
                _, ii = int8_global_knn_device(q_i8, self.base_i8, k=kk,
                                               tile=self.tile)
            else:
                _, ii = int8_knn_device(qs, self.base_i8, self.base_scale,
                                        k=kk, metric=self.metric,
                                        tile=self.tile,
                                        base_norm=self.base_norm)
        with tr.span("msann.flat.rerank"):
            dd, ii = _rerank_f32(self.base, qs,
                                 torch.clamp(ii, min=lo, max=hi), k,
                                 self.metric)
        return ii, dd

    def search(self, queries, k: int, query_batch: int = 8192,
               device_out: bool = False) -> Tuple:
        """Returns (ids [Q, k] int32, dists [Q, k] f32) as numpy, or as
        tensors on the index's device with ``device_out=True``.

        The queries are staged on the device once; batches of
        ``query_batch`` (rounded up to the scan's 512-query granularity for
        ``precision="scan"``) are zero-padded to full size.
        """
        if k > self.n_base:
            # the reference throws when a search returns < k results
            # (src/index_bipartite.cpp:2408-2412); a silently narrower
            # [Q, N] result breaks [Q, k] consumers
            raise ValueError(f"k ({k}) > corpus size ({self.n_base})")
        tr = tracer()
        with tr.span("msann.flat.search"):
            with tr.span("msann.flat.stage"):
                q = prepare_vectors(queries, self.metric, self.device)
                nq, d = q.shape
                if nq == 0:
                    e_i = torch.empty((0, k), dtype=torch.int32,
                                      device=self.device)
                    e_d = torch.empty((0, k), dtype=torch.float32,
                                      device=self.device)
                    return ((e_i, e_d) if device_out
                            else (e_i.cpu().numpy(), e_d.cpu().numpy()))
                qb = min(query_batch, nq)
                if self.precision == "scan":
                    from mysteryann_tpu_torch.ops.scan import B_BLK
                    qb = -(-qb // B_BLK) * B_BLK
                pad = (-nq) % qb
                if pad:
                    q = torch.cat([q, q.new_zeros((pad, d))])
                kk = min(k * self.oversample, self.n_base)
            tr.note(queries=nq, batches=(nq + pad) // qb,
                    padded_rows=nq + pad)
            outs = [self._search_batch(q[s:s + qb], k, kk, tr)
                    for s in range(0, nq + pad, qb)]
            with tr.span("msann.flat.assemble"):
                ids = torch.cat([o[0] for o in outs])[:nq].to(torch.int32)
                dists = torch.cat([o[1] for o in outs])[:nq]
                if device_out:
                    return ids, dists
                return ids.cpu().numpy(), dists.cpu().numpy()

    def benchmark(self, queries, k: int, query_batch: int = 8192,
                  warmup: int = 1) -> dict:
        """Timed search over all ``queries``: they are on the device before
        the clock starts; on a CUDA device ``torch.cuda.synchronize()``
        closes the timed region on both sides, and results are copied to
        the host after it."""
        q = prepare_vectors(queries, self.metric, self.device)
        qb = min(query_batch, q.shape[0])
        on_cuda = q.device.type == "cuda"

        def sync():
            if on_cuda:
                torch.cuda.synchronize(q.device)

        for _ in range(warmup):
            self.search(q[:qb], k, query_batch=qb, device_out=True)
        sync()
        t0 = time.perf_counter()
        ids, dists = self.search(q, k, query_batch=qb, device_out=True)
        sync()
        dt = time.perf_counter() - t0
        return {
            "qps": q.shape[0] / dt,
            "mean_latency_ms": 1000.0 * dt / max(1, -(-q.shape[0] // qb)),
            "avg_cmps": float(self.n_base),
            "avg_hops": 0.0,
            "ids": ids.cpu().numpy().astype(np.int32),
            "dists": dists.cpu().numpy(),
        }
