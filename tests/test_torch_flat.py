"""Port FlatIndex against the JAX package's FlatIndex on the same data.

Every precision reports exact f32 distances of its chosen ids, so the two
packages agree up to f32 summation order: distances within 1e-5 relative,
and ids equal wherever the JAX distances are untied (the JAX package's
``approx_min_k`` does not order exact ties by index on the CPU). The JAX
scan runs its Pallas kernel in interpret mode (its CPU default), the port
its plain version.
"""

import numpy as np
import pytest
import torch

from mysteryann_tpu.flat import FlatIndex as JFlat
from mysteryann_tpu_torch.flat import FlatIndex as TFlat
from mysteryann_tpu_torch.io.synthetic import make_cross_modal

CASES = [(p, m) for p in ("f32", "bf16", "int8")
         for m in ("ip", "l2", "cosine")] + [("scan", "ip"),
                                              ("scan", "cosine")]


@pytest.fixture(scope="module")
def world():
    base, _ = make_cross_modal(3000, 1, 128, metric="ip", seed=61)
    _, q = make_cross_modal(1, 100, 128, metric="ip", seed=61, query_seed=62)
    return base, q


def _assert_same_result(got, want):
    g_i, g_d = got
    w_i, w_d = (np.asarray(a) for a in want)
    assert g_i.dtype == np.int32 and g_d.dtype == np.float32
    assert g_i.shape == w_i.shape
    np.testing.assert_allclose(g_d, w_d, rtol=1e-5, atol=1e-6)
    gap = np.diff(w_d, axis=1) > 1e-5 * np.maximum(1.0, np.abs(w_d[:, 1:]))
    untied = np.ones_like(w_d, bool)
    untied[:, 1:] &= gap
    untied[:, :-1] &= gap
    np.testing.assert_array_equal(g_i[untied], w_i[untied])
    assert untied.mean() > 0.9


@pytest.mark.parametrize("precision,metric", CASES)
def test_flat_matches_jax(world, precision, metric):
    base, q = world
    want = JFlat(base, metric=metric, tile=1024, precision=precision
                 ).search(q, k=10, query_batch=64)
    idx = TFlat(base, metric=metric, tile=1024, precision=precision,
                device="cpu")
    _assert_same_result(idx.search(q, k=10, query_batch=64), want)


def test_flat_uneven_batches(world):
    base, q = world
    want = JFlat(base[:500, :16], metric="ip", tile=128
                 ).search(q[:77, :16], k=5, query_batch=50)
    got = TFlat(base[:500, :16], metric="ip", tile=128, device="cpu"
                ).search(q[:77, :16], k=5, query_batch=50)  # 50 + 27 padded
    assert got[0].shape == (77, 5)
    _assert_same_result(got, want)


def test_flat_device_out_and_empty(world):
    base, q = world
    idx = TFlat(base, metric="ip", precision="int8", device="cpu")
    ids, dists = idx.search(q[:7], k=3, device_out=True)
    assert isinstance(ids, torch.Tensor) and ids.dtype == torch.int32
    assert tuple(dists.shape) == (7, 3)
    e_i, e_d = idx.search(q[:0], k=3)
    assert e_i.shape == (0, 3) and e_d.dtype == np.float32


def test_flat_k_exceeds_corpus_raises():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((7, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="corpus"):
        TFlat(base, metric="ip", device="cpu").search(q, k=10)


def test_flat_validation_errors():
    base, _ = make_cross_modal(600, 1, 48, metric="ip", seed=9)
    with pytest.raises(ValueError, match="dim % 128"):
        TFlat(base, metric="ip", precision="scan", device="cpu")
    base2, _ = make_cross_modal(600, 1, 128, metric="l2", seed=9)
    with pytest.raises(ValueError, match="ip/cosine"):
        TFlat(base2, metric="l2", precision="scan", device="cpu")
    with pytest.raises(ValueError, match="global"):
        TFlat(base2, metric="l2", precision="int8", int8_scale="global",
              device="cpu")
    with pytest.raises(ValueError, match="precision"):
        TFlat(base2, precision="fp8", device="cpu")


def test_flat_benchmark_schema():
    base, q = make_cross_modal(1000, 64, 16, metric="ip", seed=53)
    want = JFlat(base, metric="ip", tile=512).benchmark(q, k=5,
                                                        query_batch=64)
    got = TFlat(base, metric="ip", tile=512, device="cpu").benchmark(q, k=5,
                                                       query_batch=64)
    assert set(got) == set(want)
    assert got["qps"] > 0 and got["avg_cmps"] == 1000.0
    assert got["avg_hops"] == 0.0 and got["mean_latency_ms"] > 0
    assert got["ids"].shape == (64, 5) and got["ids"].dtype == np.int32
    _assert_same_result((got["ids"], got["dists"]),
                        (want["ids"], want["dists"]))


def test_get_index_cls_flat():
    from mysteryann_tpu_torch.index import get_index_cls, index_kinds
    assert get_index_cls("flat") is TFlat
    assert "flat" in index_kinds() and "roargraph" in index_kinds()


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8", "scan"])
def test_flat_search_spans(world, precision, monkeypatch):
    """Off, ``search`` records nothing; on, it gives the same answers and
    records ``msann.flat.search`` (queries, batches, padded rows) over
    ``stage``, each batch's ``scan`` and, below f32, ``rerank``, then
    ``assemble``, under one call id, each also a range of a running
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    from mysteryann_tpu_torch.ops.scan import B_BLK
    from mysteryann_tpu_torch.utils import trace

    tr = trace.Tracer()
    monkeypatch.setattr(trace, "_global", tr)
    base, q = world
    idx = TFlat(base, metric="ip", tile=1024, precision=precision,
                device="cpu")
    off = idx.search(q, k=10, query_batch=64)
    assert list(tr.events) == []
    with tr.tracing(), profile(activities=[ProfilerActivity.CPU]) as prof:
        on = idx.search(q, k=10, query_batch=64)
    np.testing.assert_array_equal(on[0], off[0])
    np.testing.assert_array_equal(on[1], off[1])

    qb = B_BLK if precision == "scan" else 64     # 64 rounded up to B_BLK
    batches = -(-q.shape[0] // qb)
    per_batch = (["msann.flat.scan"] if precision == "f32"
                 else ["msann.flat.scan", "msann.flat.rerank"])
    ev = list(tr.events)
    assert [e["name"] for e in ev] == (
        ["msann.flat.stage"] + per_batch * batches
        + ["msann.flat.assemble", "msann.flat.search"])
    assert [e["parent"] for e in ev] == ["msann.flat.search"] * (
        len(ev) - 1) + [None]
    assert {e["call"] for e in ev} == {0}
    root = ev[-1]
    assert (root["queries"], root["batches"], root["padded_rows"]) == (
        q.shape[0], batches, batches * qb)
    ranges = {e.name for e in prof.events() if e.name.startswith("msann.")}
    assert ranges == {e["name"] for e in ev}
