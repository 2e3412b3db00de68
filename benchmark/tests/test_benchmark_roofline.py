"""The roofline bounds against values worked out by hand."""

from __future__ import annotations

import pytest

import _tiny  # noqa: F401

from benchmark.harness import roofline


def test_seed_scan_bound():
    # 2 · 8,192 · 500,000 · 200 = 1.6384e12 operations at 989e12/s
    t, by = roofline.score_select_bound(8192, 500_000, 200, 40)
    assert by == "operations"
    assert t == pytest.approx(1.6384e12 / 989e12)
    assert t * 1e3 == pytest.approx(1.6566, abs=1e-4)


def test_flat_scan_bound():
    t, by = roofline.score_select_bound(8192, 1_000_000, 200, 20)
    assert by == "operations"
    assert t * 1e3 == pytest.approx(3.3132, abs=1e-4)


def test_small_batch_is_bytes_bound():
    # one query: 2 · 1 · 500,000 · 200 = 2e8 operations (0.2 µs), against
    # (1 + 500,000) · 200 · 2 + 48 · 12 bytes at 3.35e12 B/s
    t, by = roofline.score_select_bound(1, 500_000, 200, 48)
    assert by == "bytes"
    assert t == pytest.approx((500_001 * 400 + 576) / 3.35e12)


def test_share():
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.share_pct(1.0, 0.0) is None
