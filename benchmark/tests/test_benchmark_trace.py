"""The trace reduction on hand-made intervals (µs)."""

from __future__ import annotations

import pytest

import _tiny  # noqa: F401

from benchmark.harness import trace as tr


def _trace():
    spans = [("bench.prewarm", 0, 50), ("bench.call", 100, 200),
             ("bench.copy_out", 200, 220), ("bench.call", 230, 300),
             ("bench.copy_out", 300, 310)]
    device = [("k_early", 10, 40),           # before the window: left out
              ("kA", 100, 150), ("kB", 140, 160),   # overlap: busy 100-160
              ("Memcpy DtoH", 205, 215),
              ("kA", 240, 290), ("k_late", 305, 400)]  # clipped to 310
    host = [("aten::sort", 150, 190), ("cudaLaunchKernel", 151, 152),
            ("aten::item", 190, 200), ("aten::cat", 232, 238)]
    return tr.build(device, host, spans)


def test_window_and_busy():
    t = _trace()
    assert (t.start_us, t.end_us, t.calls) == (100, 310, 2)
    assert t.window_s == pytest.approx(210e-6)
    # 100-160, 205-215, 240-290, 305-310
    assert t.busy_s == pytest.approx(125e-6)
    assert tr.idle_pct(t) == pytest.approx(100 * (1 - 125 / 210))
    assert t.kernels == 5
    assert t.kernel_seconds(lambda n: n == "kA") == pytest.approx(100e-6)


def test_merge_and_gaps():
    busy = tr.merge([("a", 0, 5), ("b", 3, 8), ("c", 10, 12)])
    assert busy == [(0, 8), (10, 12)]
    assert tr.gaps(busy, 0, 20) == [(8, 10), (12, 20)]
    assert tr.gaps([], 0, 5) == [(0, 5)]


def test_outermost():
    out = tr.outermost([("in", 2, 3), ("out", 1, 9), ("next", 9, 12),
                        ("in2", 10, 11)])
    assert [n for n, _, _ in out] == ["out", "next"]


def test_idle_by_host():
    idle = tr.idle_by_host(_trace())
    # gaps: 160-205 (mid 182.5: call, aten::sort), 215-240 (mid 227.5:
    # between calls), 290-305 (mid 297.5: call, python)
    assert idle == pytest.approx({"call:aten::sort": 45e-6,
                                  "between_calls:python": 25e-6,
                                  "call:python": 15e-6})


def test_breakdown_shape():
    b = tr.breakdown(_trace())
    assert b["device_ops"][0] == ["kA", pytest.approx(100e-6)]
    assert len(b["device_ops"]) <= tr.TOP and len(b["idle_gaps"]) <= tr.TOP
    assert all(isinstance(n, str) and v > 0
               for n, v in b["device_ops"] + b["idle_gaps"])


def test_no_call_span_raises():
    with pytest.raises(ValueError):
        tr.build([], [], [("bench.prewarm", 0, 1)])


def test_no_device_operations_reads_nothing():
    t = tr.build([], [], [("bench.call", 0, 10)])
    assert tr.idle_pct(t) is None and tr.idle_pct(None) is None
