"""The plain reference of the T2I configurations: exact top-k by brute
force, and the exact distance of any (query, row) pair.

Plain torch: float32 products with TF32 off and ``torch.topk``, in blocks of
queries and tiles of rows so that it fits; float64 for the distances of
returned pairs. It imports nothing of the port and takes nothing the port
made: only the base and the queries the benchmark drew.

Distances follow the port's convention, smaller is closer: ``-q·x`` for ip
and cosine (rows already unit-normed by the world), ``|q - x|²`` for l2.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _no_tf32():
    """Context that holds TF32 off for float32 matmuls, restoring after."""
    class _Ctx:
        def __enter__(self):
            self.prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            return self

        def __exit__(self, *exc):
            torch.backends.cuda.matmul.allow_tf32 = self.prev
            return False
    return _Ctx()


def _dist_block(q: torch.Tensor, x: torch.Tensor, metric: str
                ) -> torch.Tensor:
    ip = q @ x.T
    if metric in ("ip", "cosine"):
        return -ip
    return (q * q).sum(1, keepdim=True) - 2.0 * ip + (x * x).sum(1)[None, :]


def exact_topk(queries: torch.Tensor, base: torch.Tensor, k: int,
               metric: str = "ip", q_block: int = 4096,
               tile: int = 262144, round_inputs=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids int64 [Q, k], dists f32 [Q, k]) of the ``k`` closest rows of
    ``base`` to each query, ascending. ``round_inputs`` maps both operands
    before the products (the control's lower precision); None for the
    reference itself."""
    if round_inputs is not None:
        queries, base = round_inputs(queries), round_inputs(base)
    out_i, out_d = [], []
    with _no_tf32():
        for s in range(0, queries.shape[0], q_block):
            q = queries[s:s + q_block]
            best_d = best_i = None
            for t0 in range(0, base.shape[0], tile):
                d = _dist_block(q, base[t0:t0 + tile], metric)
                v, i = torch.topk(d, min(k, d.shape[1]), dim=1,
                                  largest=False)
                i = i + t0
                if best_d is not None:
                    v = torch.cat([best_d, v], 1)
                    i = torch.cat([best_i, i], 1)
                    v, pos = torch.topk(v, k, dim=1, largest=False)
                    i = i.gather(1, pos)
                best_d, best_i = v, i
                del d
            out_i.append(best_i)
            out_d.append(best_d)
    return torch.cat(out_i), torch.cat(out_d)


def distances_f64(queries: torch.Tensor, base: torch.Tensor,
                  ids: torch.Tensor, metric: str = "ip") -> torch.Tensor:
    """float64 [B, c] distances of ``queries`` [B, d] to the rows ``ids``
    [B, c] of ``base`` (every id a valid row)."""
    x = base[ids.reshape(-1).long()].reshape(*ids.shape, -1).double()
    q = queries.double()[:, None, :]
    if metric in ("ip", "cosine"):
        return -(x * q).sum(-1)
    return ((x - q) ** 2).sum(-1)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 stored significand bits, round to nearest,
    ties away, as ``cvt.rna.tf32.f32``), held as float32: a float32 matmul
    of such operands is a TF32 tensor-core product."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
