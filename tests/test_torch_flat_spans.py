"""The program-span reductions of ``scripts/torch_flat_spans.py`` on
hand-made intervals (µs), and its whole measurement of the benchmark's flat
cell cut to a tiny size, on the CPU (and on the card)."""

from __future__ import annotations

import importlib.util
import os
import sys
from types import SimpleNamespace

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmark", "tests"))
from _tiny import tiny_tree  # noqa: E402

from benchmark.harness import trace as tr  # noqa: E402


def _script():
    """scripts/torch_flat_spans.py, imported by path."""
    path = os.path.join(REPO, "scripts", "torch_flat_spans.py")
    spec = importlib.util.spec_from_file_location("torch_flat_spans", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # its dataclass looks itself up
    spec.loader.exec_module(mod)
    return mod


ps = _script()

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
SEED = 2**31 + 9

# two calls: bench.call 100-200 and 230-300, copy-outs after each
HARNESS = [("bench.prewarm", 0, 50, False), ("bench.call", 100, 200, False),
           ("bench.copy_out", 200, 220, False),
           ("bench.call", 230, 300, False),
           ("bench.copy_out", 300, 310, False),
           ("bench.call", 120, 190, True)]           # its CUDA-side range
OPS = [("k_early", 10, 40, True), ("msann_k3f::k", 120, 150, True),
       ("k1", 160, 170, True), ("gemv", 168, 175, True),
       ("Memcpy DtoH", 205, 215, True), ("msann_k3f::k", 250, 280, True),
       ("k1", 285, 290, True), ("k_late", 305, 400, True),
       ("aten::empty", 102, 118, False), ("aten::to", 201, 219, False),
       ("aten::cat", 231, 240, False)]
# the program's spans: host, then their CUDA-side extents
PROGRAM = [("msann.flat.search", 101, 199, False),
           ("msann.flat.stage", 101, 104, False),
           ("msann.flat.scan", 104, 119, False),
           ("msann.flat.rerank", 119, 121, False),
           ("msann.flat.assemble", 121, 122, False),
           ("msann.flat.search", 231, 295, False),
           ("msann.flat.stage", 231, 245, False),
           ("msann.flat.scan", 245, 246, False),
           ("msann.flat.rerank", 246, 247, False),
           ("msann.flat.search", 120, 190, True),
           ("msann.flat.scan", 120, 150, True),
           ("msann.flat.rerank", 158, 176, True),
           ("msann.flat.rerank", 284, 291, True)]


def test_split_leaves_the_harness_readings_as_without_the_program():
    without = ps.split(HARNESS + OPS).trace
    p = ps.split(HARNESS + OPS + PROGRAM)
    assert p.trace == without
    assert (p.trace.busy_s, tr.idle_pct(p.trace), p.trace.kernels) == (
        without.busy_s, tr.idle_pct(without), without.kernels)
    k3f = lambda n: "msann_k3f::" in n                       # noqa: E731
    assert p.trace.kernel_seconds(k3f) == without.kernel_seconds(k3f)
    assert tr.breakdown(p.trace) == tr.breakdown(without)
    assert len(p.host) == 9 and len(p.device) == 4
    # the harness's reduction now counts the program's CUDA-side ranges as
    # busy device operations and names idle by the program's spans
    prof = SimpleNamespace(events=lambda: [
        SimpleNamespace(name=n, time_range=SimpleNamespace(start=s, end=e),
                        device_type=CUDA if d else CPU)
        for n, s, e, d in HARNESS + OPS + PROGRAM])
    now = tr.from_profiler(prof)
    assert now.busy_s > without.busy_s
    assert tr.breakdown(now) != tr.breakdown(without)
    assert ps.split(ps.profiler_events(prof)) == p


def test_entry_idle_counts_only_gaps_inside_program_spans():
    p = ps.split(HARNESS + OPS + PROGRAM)
    ms, by = ps.entry_idle(p)
    # window 100-310; busy 120-150, 160-175, 205-215, 250-280, 285-290,
    # 305-310. Gaps: 100-120 (mid 110: scan), 150-160 (mid 155: search),
    # 175-205 (mid 190: search), 215-250 (mid 232.5: stage), 280-285
    # (mid 282.5: search), 290-305 (mid 297.5: in the call, outside every
    # program span)
    assert by == pytest.approx({"msann.flat.scan": 20e-3 / 2,
                                "msann.flat.search": 45e-3 / 2,
                                "msann.flat.stage": 35e-3 / 2})
    assert ms == pytest.approx(100e-3 / 2)
    assert ps.entry_idle(ps.split(HARNESS + OPS)) == (None, {})
    # clipped: only the parts of the gaps the spans cover, by the innermost
    # span there: 100-120 gives stage 101-104, scan 104-119, rerank
    # 119-120; 150-160 and 175-199 search; 215-250 stage 231-245, scan,
    # rerank, search 247-250; 280-285 and 290-295 search
    ms, by = ps.entry_idle(p, clip=True)
    assert by == pytest.approx({"msann.flat.stage": 17e-3 / 2,
                                "msann.flat.scan": 16e-3 / 2,
                                "msann.flat.rerank": 2e-3 / 2,
                                "msann.flat.search": 47e-3 / 2})
    assert ms == pytest.approx(82e-3 / 2)
    # on the CUDA timeline: the gaps inside the program's device extents
    # (search 120-190, scan 120-150, rerank 158-176 and 284-291): 150-158
    # and 176-190 search; 158-160, 175-176, 284-285 and 290-291 rerank
    ms, by = ps.entry_idle(p, clip=True, on_device=True)
    assert by == pytest.approx({"msann.flat.search": 22e-3 / 2,
                                "msann.flat.rerank": 5e-3 / 2})
    assert ms == pytest.approx(27e-3 / 2)


def test_rerank_reads_the_union_inside_its_device_extents():
    p = ps.split(HARNESS + OPS + PROGRAM)
    # extents 158-176 and 284-291: k1 160-170 and gemv 168-175 (union 15),
    # k1 285-290 (5); k3f and the copy lie outside
    assert ps.busy_inside(p, ps.RERANK) == pytest.approx(20e-6)
    cfg = {"world": {"n_base": 1000, "dim": 200},
           "serve": {"k": 10, "oversample": 2}}
    bound, by = ps.rerank_bound(8, 20, 200, 10)
    assert by == "bytes"
    assert ps.rerank_roofline(p, cfg, {"batch": 8}) == pytest.approx(
        100 * bound / 10e-6)
    assert ps.rerank_roofline(ps.split(HARNESS + OPS), cfg,
                              {"batch": 8}) is None


def test_rerank_bound_at_the_cell():
    bound, by = ps.rerank_bound(8192, 20, 200, 10)
    # 8,192 x 20 rows and 8,192 queries of 200 f32, 8,192 x 20 int32 ids,
    # 8,192 x 10 f32 distances and int64 ids: 139,264,000 bytes
    assert by == "bytes"
    assert bound == pytest.approx(139_264_000 / 3.35e12)
    assert bound == pytest.approx(41.57e-6, rel=1e-3)


def test_clock_lays_the_tracer_over_the_profiler():
    t0_ns, start_ns = 1_000_000_000, 1_000_500_000       # 500 µs apart
    events = [{"name": "a", "t_start": 0.0006, "dur_s": 0.0001,
               "parent": None, "call": 0},
              {"name": "b", "t_start": 0.000601, "dur_s": 0.00005,
               "parent": "a", "call": 0},
              {"name": "build.phase", "t_start": 0.0, "dur_s": 1.0}]
    host = [("a", 100.5, 199.0), ("b", 101.5, 150.5)]
    c = ps.clock(events, t0_ns, host, start_ns)
    assert c["spans"] == 2
    assert c["start_us"] == pytest.approx([0.5, 0.5])
    assert c["end_us"] == pytest.approx([0.75, 1.0])
    assert ps.clock(events, t0_ns, host[:1], start_ns) is None


def test_read_dump(tmp_path):
    from mysteryann_tpu_torch.utils.trace import DROPPED, Tracer

    t = Tracer(on=True, max_events=4)
    for _ in range(3):
        with t.span("msann.flat.search"):
            with t.span("msann.flat.scan"):
                pass
    path = str(tmp_path / "t.jsonl")
    t.dump(path)
    d = ps.read_dump(path)
    assert {n: v["n"] for n, v in d["spans"].items()} == {
        "msann.flat.search": 2, "msann.flat.scan": 2}
    assert d["counters"] == {DROPPED: 2.0} and d["t0_ns"] == t.t0_ns
    assert all(0 <= v["median_ms"] <= v["max_ms"]
               for v in d["spans"].values())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_tree(str(tmp_path_factory.mktemp("tiny_spans")))


def _measure(root, device):
    recs = ps.measure(root, "t2i10m-flat.b8192", SEED, 1, device)
    assert [r["tracing"] for r in recs] == [False, True]
    off, on = recs
    assert off["program_spans"] == {"host": 0, "device": 0}
    assert off["flat.entry_idle_ms"] is None and "clock" not in off
    # each call's five spans (one batch), the settling call's too
    assert on["program_spans"]["host"] == 5 * (on["calls"] + 1)
    assert on["flat.entry_idle_ms"] is not None
    assert on["entry_idle_clipped_ms"] is not None
    assert on["dropped_events"] == 0
    c = on["clock"]
    assert c["spans"] == on["program_spans"]["host"]
    assert c["least_us"] > -2 and c["start_us"][0] < 50 \
        and c["end_us"][0] < 50
    assert set(ps.summarize(recs)) >= {"off.split.device.idle_pct",
                                      "on.flat.rerank_roofline"}
    return off, on


def test_measure_on_the_cpu(root):
    off, on = _measure(root, torch.device("cpu"))
    # the CPU has no device timeline: nothing on the device to read
    assert on["program_spans"]["device"] == 0
    assert on["flat.rerank_roofline"] is None
    assert on["split"]["device.idle_pct"] is None


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_measure_on_the_card(root, cuda):
    off, on = _measure(root, cuda)
    assert on["program_spans"]["device"] > 0
    assert 0 < on["flat.rerank_roofline"] <= 100
    assert on["split"]["device.idle_pct"] is not None
