"""Segment sums — the port's ``jax.ops.segment_sum``.

``index_add_`` on a CUDA tensor adds with atomics, so float sums change at
the last bit from run to run (k-means centroids, and through them the IVF
assignment, would then drift between runs). Here the rows are stably sorted
by segment and each segment is reduced in row order by
``torch.segment_reduce``: the same sums on every run, without touching the
process-wide ``torch.use_deterministic_algorithms`` flag. On the CPU the
order of additions is ``index_add_``'s own, so the sums equal it bit for bit.
"""

from __future__ import annotations

import torch


def segment_sum(x: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = sum(x[i] for i where seg[i] == s)`` for ``x`` [n, ...] and
    ``seg`` int [n] in [0, num_segments), on ``x``'s device."""
    order = torch.sort(seg.to(torch.int64), stable=True)
    bounds = torch.searchsorted(
        order.values, torch.arange(num_segments + 1, device=seg.device))
    return torch.segment_reduce(x[order.indices], "sum",
                                lengths=bounds.diff(), axis=0)
