"""Twin of tests/test_trace.py for the port's `Tracer`
(``mysteryann_tpu_torch/utils/trace.py``): under one scripted clock its
spans, counters, summary, ``dump`` lines and ``reset`` equal the JAX
package's, and a tiny port build emits the build's phase spans."""

import json

import numpy as np
import pytest

from mysteryann_tpu.utils import trace as jax_trace
from mysteryann_tpu_torch.utils import trace as torch_trace


def _traced(module, path, ticks):
    """Drive a fresh Tracer of ``module`` through the same calls."""
    it = iter(ticks)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module.time, "perf_counter", lambda: next(it))
        tr = module.Tracer()
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


def test_spans_counters_dump_and_reset_equal_the_jax_tracer(tmp_path):
    # __init__, outer start, inner start, inner end, outer end, record
    ticks = [100.0, 100.5, 100.75, 101.0, 102.0, 103.0]
    j = _traced(jax_trace, str(tmp_path / "jax.jsonl"), ticks)
    t = _traced(torch_trace, str(tmp_path / "torch.jsonl"), ticks)
    assert t[1] == j[1]                   # summary
    assert t[2] == j[2]                   # dump lines
    assert t[3] == j[3]                   # events
    s = t[1]
    assert s["spans"]["outer"] == {"n": 1, "total_s": 1.5, "max_s": 1.5}
    assert s["spans"]["phase"]["total_s"] == 1.5
    assert s["counters"] == {"cmps": 50.0, "hops": 1.0}
    assert t[2][0]["name"] == "inner" and t[2][1]["queries"] == 5
    assert t[2][-1] == {"counters": {"cmps": 50.0, "hops": 1.0}}
    for tr in (j[0], t[0]):
        assert tr.events == [] and tr.counters == {}


def test_span_calls_its_sync():
    calls = []
    tr = torch_trace.Tracer()
    with tr.span("dev", sync=lambda: calls.append(1)):
        pass
    assert calls == [1] and tr.events[0]["dur_s"] >= 0


def test_build_emits_trace():
    from mysteryann_tpu_torch.graph import build_roargraph
    from mysteryann_tpu_torch.io import make_cross_modal
    from mysteryann_tpu_torch.ops import exact_knn
    from mysteryann_tpu_torch.utils.params import BuildConfig

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
