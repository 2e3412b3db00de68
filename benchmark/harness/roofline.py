"""The card's peaks and the least time a kernel's work could take.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit). A bound counts what the inputs need, whatever the kernel reads
again: every input byte read once and every output byte written once, and
the operations the function needs at the inputs' own width. The roofline
share of a kernel is its bound over its measured time; it cannot pass 100%.
"""

from __future__ import annotations

from typing import Tuple

PEAK = {
    "bf16_flop_s": 989e12,
    "tf32_flop_s": 495e12,
    "f32_flop_s": 67e12,
    "int8_op_s": 1979e12,
    "hbm_bytes_s": 3.35e12,
}


def bound_s(flops: float, nbytes: float, flop_s: float,
            bytes_s: float = PEAK["hbm_bytes_s"]) -> Tuple[float, str]:
    """(seconds, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_io = flops / flop_s, nbytes / bytes_s
    return (t_ops, "operations") if t_ops >= t_io else (t_io, "bytes")


def score_select_bound(B: int, n: int, d: int, k: int) -> Tuple[float, str]:
    """K3f, the bf16 score product fused with the k-selection: 2·B·n·d
    operations at the bf16 peak, against the bf16 queries and table read
    once and k f32 values and int64 ids written a query."""
    flops = 2.0 * B * n * d
    nbytes = (B + n) * d * 2 + B * k * 12
    return bound_s(flops, nbytes, PEAK["bf16_flop_s"])


def share_pct(bound: float, measured: float) -> float | None:
    """A roofline share in percent; None when nothing was measured."""
    if measured <= 0:
        return None
    return 100.0 * bound / measured
