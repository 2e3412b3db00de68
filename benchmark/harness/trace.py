"""Reduce a ``torch.profiler`` trace of the traced window to the numbers the
per-layer readers and the result's ``breakdown`` use.

The window is bounded by the harness's own spans: ``bench.call`` around a
call into the program and ``bench.copy_out`` around the copy of its answers
to the host. Device operations (kernels, copies, sets) are clipped to it;
their union is the busy time, and each stretch between them is an idle gap,
named by what the host was doing at its middle: the harness span, then the
outermost operation the host was inside (``python`` where it was in no
operation, so in the program's own Python between calls into torch).

The reductions work on plain ``(name, start_us, end_us)`` tuples, so they
are tested on the CPU; ``from_profiler`` is the only part that reads torch's
events.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[str, float, float]      # (name, start µs, end µs)
SPAN_PREFIX = "bench."
CALL, COPY = "bench.call", "bench.copy_out"
TOP = 10


@dataclass
class Trace:
    start_us: float
    end_us: float
    calls: int
    device: List[Interval]               # clipped to the window
    host: List[Interval]                 # outermost host operations
    spans: List[Interval]                # the harness's spans
    kernels: int = 0                     # device operations in the window

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in merge(self.device)) / 1e6

    def kernel_seconds(self, match) -> float:
        """Summed device time of the operations whose name ``match``
        accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) / 1e6


def merge(intervals: Sequence[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals as sorted disjoint (start, end) pairs."""
    out: List[List[float]] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no busy interval covers."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def outermost(intervals: Sequence[Interval]) -> List[Interval]:
    """The intervals that no other interval contains (nested host
    operations keep their outermost)."""
    out: List[Interval] = []
    for iv in sorted(intervals, key=lambda x: (x[1], -x[2])):
        if out and iv[2] <= out[-1][2]:
            continue
        out.append(iv)
    return out


def _at(intervals: Sequence[Interval], starts: List[float], t: float):
    """The name of the interval of a sorted disjoint-start list that covers
    ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and intervals[i][1] <= t < intervals[i][2]:
        return intervals[i][0]
    return None


def idle_by_host(tr: Trace) -> Dict[str, float]:
    """Seconds of idle device time by what the host was doing."""
    busy = merge(tr.device)
    spans = sorted(tr.spans, key=lambda x: x[1])
    span_starts = [s for _, s, _ in spans]
    host = outermost(tr.host)
    host_starts = [s for _, s, _ in host]
    out: Dict[str, float] = {}
    for s, e in gaps(busy, tr.start_us, tr.end_us):
        mid = 0.5 * (s + e)
        span = _at(spans, span_starts, mid) or "between_calls"
        op = _at(host, host_starts, mid) or "python"
        label = f"{span.removeprefix(SPAN_PREFIX)}:{op}"
        out[label] = out.get(label, 0.0) + (e - s) / 1e6
    return out


def breakdown(tr: Trace) -> dict:
    """The result's ``breakdown``: the device operations that took most
    time, and the longest idle stretches by what the host was doing, at
    most ``TOP`` of each, in seconds."""
    by_op: Dict[str, float] = {}
    for n, s, e in tr.device:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(idle_by_host(tr).items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[short(n), v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in idle]}


def short(name: str, width: int = 120) -> str:
    """A kernel's name cut to ``width`` characters (template arguments make
    some thousands long)."""
    return name if len(name) <= width else name[:width - 3] + "..."


def window(spans: Sequence[Interval]) -> Tuple[float, float, int]:
    """(start, end, calls) of the traced window: from the first call's
    start to the end of the last span."""
    calls = [iv for iv in spans if iv[0] == CALL]
    if not calls:
        raise ValueError("the trace holds no bench.call span")
    return (min(s for _, s, _ in calls), max(e for _, _, e in spans),
            len(calls))


def build(device: Sequence[Interval], host: Sequence[Interval],
          spans: Sequence[Interval]) -> Trace:
    """A ``Trace`` of the window the spans bound, device operations clipped
    to it."""
    lo, hi, calls = window(spans)
    clipped = [(n, max(s, lo), min(e, hi)) for n, s, e in device
               if e > lo and s < hi]
    return Trace(start_us=lo, end_us=hi, calls=calls, device=clipped,
                 host=[iv for iv in host if iv[2] > lo and iv[1] < hi],
                 spans=list(spans), kernels=len(clipped))


def from_profiler(prof) -> Trace:
    """A ``Trace`` from a finished ``torch.profiler.profile``: device
    operations are the events on the CUDA timeline (the harness's spans
    show there too and are left out), host operations the CPU events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host, spans = [], [], []
    for e in prof.events():
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name.startswith(SPAN_PREFIX):
            if e.device_type != cuda:
                spans.append(iv)
        elif e.device_type == cuda:
            device.append(iv)
        else:
            host.append(iv)
    return build(device, host, spans)


def idle_pct(tr: Trace | None) -> float | None:
    """The share of the traced window with no device operation running, in
    percent; None without a trace or with no device operation in it."""
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
