"""Twin of tests/test_trace.py for the port's `Tracer`
(``mysteryann_tpu_torch/utils/trace.py``): under one scripted clock its
spans, counters, summary, ``dump`` lines and ``reset`` equal the JAX
package's in every field the JAX tracer records; then what the port adds:
spans off by default (no event, no profiler range), ``parent`` and
``call``, the event cap and its dropped counter, the profiler's clock; and
a tiny port build emits the build's phase records, each phase closed by the
device's synchronize."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mysteryann_tpu.utils import trace as jax_trace
from mysteryann_tpu_torch.utils import timers as torch_timers
from mysteryann_tpu_torch.utils import trace as torch_trace


def _scripted(mp, module, ticks):
    """The module's clock steps through ``ticks`` (seconds)."""
    it = iter(ticks)
    if module is jax_trace:
        mp.setattr(module.time, "perf_counter", lambda: next(it))
    else:
        mp.setattr(module.time, "time_ns", lambda: round(next(it) * 1e9))


def _traced(module, path, ticks):
    """Drive a fresh Tracer of ``module`` (spans on) through the same
    calls."""
    with pytest.MonkeyPatch.context() as mp:
        _scripted(mp, module, ticks)
        tr = (module.Tracer() if module is jax_trace
              else module.Tracer(on=True))
        with tr.span("outer", queries=5):
            tr.count("cmps", 42)
            tr.count("cmps", 8)
            with tr.span("inner"):
                pass
        tr.record("phase", 1.5, nodes=100)
        tr.count("hops")
    summary = tr.summary()
    tr.dump(path)
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    events = list(tr.events)
    tr.reset()
    return tr, summary, lines, events


def _jax_fields(got, want):
    """``got``'s dicts cut to the keys of ``want``'s."""
    return [{k: g[k] for k in w} for g, w in zip(got, want)]


def test_spans_counters_dump_and_reset_equal_the_jax_tracer(tmp_path):
    # __init__, outer start, inner start, inner end, outer end, record
    ticks = [100.0, 100.5, 100.75, 101.0, 102.0, 103.0]
    j = _traced(jax_trace, str(tmp_path / "jax.jsonl"), ticks)
    t = _traced(torch_trace, str(tmp_path / "torch.jsonl"), ticks)
    assert t[1] == j[1]                                  # summary
    assert len(t[2]) == len(j[2])
    assert _jax_fields(t[2], j[2]) == j[2]               # dump lines
    assert _jax_fields(t[3], j[3]) == j[3]               # events
    s = t[1]
    assert s["spans"]["outer"] == {"n": 1, "total_s": 1.5, "max_s": 1.5}
    assert s["spans"]["phase"]["total_s"] == 1.5
    assert s["counters"] == {"cmps": 50.0, "hops": 1.0}
    assert t[2][0]["name"] == "inner" and t[2][1]["queries"] == 5
    # the port's own fields: parent, call, and the clock's origin
    assert [(e["name"], e["parent"], e["call"]) for e in t[3][:2]] == [
        ("inner", "outer", 0), ("outer", None, 0)]
    assert "parent" not in t[3][2] and "call" not in t[3][2]   # a record
    assert t[2][-1] == {"counters": {"cmps": 50.0, "hops": 1.0},
                        "t0_ns": 100_000_000_000}
    for tr in (j[0], t[0]):
        assert list(tr.events) == [] and tr.counters == {}


def test_span_calls_its_sync():
    calls = []
    tr = torch_trace.Tracer()
    with tr.span("dev", sync=lambda: calls.append(1)):
        pass
    assert calls == [] and list(tr.events) == []        # off: no sync
    with tr.tracing():
        with tr.span("dev", sync=lambda: calls.append(1)):
            pass
    assert calls == [1] and tr.events[0]["dur_s"] >= 0


def test_off_records_nothing_and_opens_no_record_function():
    tr = torch_trace.Tracer()
    assert tr.span("msann.a") is tr.span("msann.b")     # one null context
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("msann.test.off", queries=3):
            tr.note(queries=4)
            torch.ones(4).sum()
    assert list(tr.events) == [] and tr.counters == {}
    assert not [e for e in prof.events() if e.name.startswith("msann.")]


def test_tracing_switches_on_and_restores():
    tr = torch_trace.Tracer()
    with tr.tracing():
        assert tr.on
        with tr.tracing(False):
            assert not tr.on
            with tr.span("msann.test.off"):
                pass
        with tr.span("msann.test.on"):
            pass
    assert not tr.on
    assert [e["name"] for e in tr.events] == ["msann.test.on"]


def test_process_tracer_off_unless_msann_trace(monkeypatch, tmp_path):
    registered = []
    monkeypatch.setattr("atexit.register", registered.append)
    monkeypatch.setattr(torch_trace, "_global", None)
    monkeypatch.delenv("MSANN_TRACE", raising=False)
    assert not torch_trace.tracer().on and registered == []
    assert torch_trace.tracer() is torch_trace.tracer()
    monkeypatch.setattr(torch_trace, "_global", None)
    path = str(tmp_path / "t.jsonl")
    monkeypatch.setenv("MSANN_TRACE", path)
    tr = torch_trace.tracer()
    assert tr.on and len(registered) == 1
    with tr.span("msann.test.exported"):
        pass
    registered[0]()                                      # interpreter exit
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    assert lines[0]["name"] == "msann.test.exported"
    assert lines[-1]["t0_ns"] == tr.t0_ns


def test_on_records_parent_call_and_notes():
    tr = torch_trace.Tracer(on=True)
    for _ in range(2):
        with tr.span("msann.t.root", queries=8):
            with tr.span("msann.t.child"):
                with tr.span("msann.t.leaf"):
                    pass
            tr.note(batches=2)
            with tr.span("msann.t.child"):
                pass
    # a thread's spans have a stack of their own: a root there
    with tr.span("msann.t.root"):
        got = {}

        def other():
            with tr.span("msann.t.thread"):
                pass
            got["ok"] = True
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive() and got["ok"]
    ev = [(e["name"], e["parent"], e["call"]) for e in tr.events]
    assert ev == [
        ("msann.t.leaf", "msann.t.child", 0),
        ("msann.t.child", "msann.t.root", 0),
        ("msann.t.child", "msann.t.root", 0),
        ("msann.t.root", None, 0),
        ("msann.t.leaf", "msann.t.child", 1),
        ("msann.t.child", "msann.t.root", 1),
        ("msann.t.child", "msann.t.root", 1),
        ("msann.t.root", None, 1),
        ("msann.t.thread", None, 3),
        ("msann.t.root", None, 2),
    ]
    roots = [e for e in tr.events if e["name"] == "msann.t.root"]
    assert [(e.get("queries"), e.get("batches")) for e in roots] == [
        (8, 2), (8, 2), (None, None)]
    leaf, child, root = list(tr.events)[:2] + [roots[0]]
    assert root["t_start"] <= child["t_start"] <= leaf["t_start"]
    assert (leaf["t_start"] + leaf["dur_s"]
            <= root["t_start"] + root["dur_s"] + 1e-6)


def test_event_cap_counts_dropped_events():
    tr = torch_trace.Tracer(on=True, max_events=3)
    for i in range(5):
        with tr.span(f"msann.t.s{i}"):
            pass
    assert [e["name"] for e in tr.events] == [
        "msann.t.s2", "msann.t.s3", "msann.t.s4"]
    assert tr.counters == {torch_trace.DROPPED: 2.0}
    tr.record("build.phase", 1.0)
    assert [e["name"] for e in tr.events][-1] == "build.phase"
    assert tr.counters[torch_trace.DROPPED] == 3.0
    tr.reset()
    assert list(tr.events) == [] and tr.counters == {}
    assert tr.events.maxlen == 3


def test_span_is_on_the_profiler_clock():
    """An on span's start and end, on the Tracer's clock, hold the
    profiler's own event for it and lie within 50 µs of its ends."""
    tr = torch_trace.Tracer(on=True)
    x = torch.ones(256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("msann.t.warm"):
            x.sum()
        for i in range(20):
            with tr.span(f"msann.t.s{i}"):
                x.sum()
    prof_ev = {e.name(): (e.start_ns(), e.end_ns())
               for e in prof.profiler.kineto_results.events()
               if e.name().startswith("msann.t.s")}
    starts, ends = [], []
    for e in tr.events:
        if e["name"] not in prof_ev:
            continue
        s = tr.t0_ns + e["t_start"] * 1e9
        t = s + e["dur_s"] * 1e9
        ps, pe = prof_ev[e["name"]]
        # rounding of t_start and dur_s to the µs: 1 µs each side
        assert s - 1e3 <= ps <= pe <= t + 2e3
        starts.append(ps - s)
        ends.append(t - pe)
    assert len(starts) == 20
    assert np.median(starts) < 50e3 and np.median(ends) < 50e3


def test_device_sync():
    assert torch_timers.device_sync("cpu") is None
    sync = torch_timers.device_sync(torch.device("cuda", 0))
    assert sync.func is torch.cuda.synchronize
    assert sync.args == (torch.device("cuda", 0),)


def test_build_emits_trace(monkeypatch):
    from mysteryann_tpu_torch.graph import build_roargraph
    from mysteryann_tpu_torch.graph import roargraph
    from mysteryann_tpu_torch.io import make_cross_modal
    from mysteryann_tpu_torch.ops import exact_knn
    from mysteryann_tpu_torch.utils.params import BuildConfig

    syncs = []
    monkeypatch.setattr(roargraph, "device_sync",
                        lambda dev: lambda: syncs.append(str(dev)))
    torch_trace.tracer().reset()
    base, train = make_cross_modal(800, 400, 16, metric="ip", seed=81)
    _, knn = exact_knn(train, base, k=8, metric="ip", device="cpu")
    cfg = BuildConfig(M_sq=8, M_pjbp=6, L_pjpq=16, metric="ip",
                      query_batch=256, search_batch=256,
                      connectivity_iters=2)
    build_roargraph(base, train, knn, cfg, verbose=False, device="cpu")
    names = {e["name"] for e in torch_trace.tracer().events}
    assert {"build.medoid", "build.phaseA", "build.phaseBC",
            "build.phaseD"} <= names
    assert all(np.isfinite(e["dur_s"]) and e["dur_s"] >= 0
               for e in torch_trace.tracer().events)
    # each of the four phase Timers closes on the device's synchronize
    assert syncs == ["cpu"] * 4
