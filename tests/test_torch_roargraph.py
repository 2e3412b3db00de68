"""Port RoarGraph build and persistence against the JAX package.

- Build parity: dyadic data (integers / 64 — every distance exact in
  float32), the same numpy kNN handed to both builds: adjacency and entry
  point must be identical, for 1 and 2 phase-D passes, with the classic
  phase-D engine and with the fused one (int8 rows popped one at a time,
  int4 rows popped four at a time).
- Persistence: the port reads the JAX package's file, and writes the same
  bytes.
(Recall on make_cross_modal data is in test_torch_recall.py.)
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mysteryann_tpu.graph import RoarGraphIndex as JIndex
from mysteryann_tpu.graph import build_roargraph as j_build
from mysteryann_tpu.graph import compute_medoid as j_medoid
from mysteryann_tpu.ops import exact_knn as j_knn
from mysteryann_tpu.utils.params import BuildConfig as JConfig
import mysteryann_tpu_torch as port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test processes run side by side (pytest-xdist); torch's own thread
    pool on top of them oversubscribes the cores, and its parallel ops then
    wait on each other. These tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dyadic(rng, shape):
    return (rng.integers(-64, 65, size=shape) / 64).astype(np.float32)


@pytest.fixture(scope="module")
def dyadic_builds(tmp_path_factory):
    """Both packages build with 1 and then 2 phase-D passes from the same
    numpy kNN. The 2-pass builds resume from each package's own 1-pass
    checkpoints (connectivity_passes is fingerprint-neutral), which also
    holds the port's checkpoint resume to the JAX package's."""
    rng = np.random.default_rng(0)
    base, train = _dyadic(rng, (2000, 32)), _dyadic(rng, (800, 32))
    _, knn = j_knn(train, base, k=24, metric="ip", precision="highest")
    j_dir = str(tmp_path_factory.mktemp("jax_ckpt"))
    t_dir = str(tmp_path_factory.mktemp("port_ckpt"))
    out = {}
    for passes in (1, 2):
        kw = dict(M_sq=24, M_pjbp=10, L_pjpq=48, metric="ip",
                  query_batch=512, search_batch=512, connectivity_iters=4,
                  connectivity_passes=passes, connectivity_engine="classic")
        out[passes] = (
            j_build(base, train, knn, JConfig(**kw), verbose=False,
                    checkpoint_dir=j_dir),
            port.build_roargraph(base, train, knn, port.BuildConfig(**kw),
                                 verbose=False, checkpoint_dir=t_dir,
                                 device="cpu"))
    return out


@pytest.mark.parametrize("passes", [1, 2])
def test_build_identical_on_dyadic_data(dyadic_builds, passes):
    want, got = dyadic_builds[passes]
    assert got.graph.ep == want.graph.ep
    np.testing.assert_array_equal(got.graph.neighbors, want.graph.neighbors)
    st = got.graph.degree_stats()
    assert st["zero"] == 0 and st["max"] <= 20


def test_save_load_reads_and_writes_jax_format(dyadic_builds, tmp_path):
    j_index = dyadic_builds[2][0]
    j_path = str(tmp_path / "jax.index")
    j_index.save(j_path)
    loaded = port.RoarGraphIndex.load(j_path)
    assert loaded.graph.ep == j_index.graph.ep
    assert loaded.metric == port.Metric.IP and loaded.dim == 32
    np.testing.assert_array_equal(loaded.graph.neighbors,
                                  j_index.graph.neighbors)
    t_path = str(tmp_path / "port.index")
    loaded.save(t_path)
    for suffix in ("", ".meta.json"):
        with open(j_path + suffix, "rb") as a, open(t_path + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    assert os.path.getsize(t_path) == os.path.getsize(j_path)
    # and the JAX package reads the port's file back
    back = JIndex.load(t_path)
    np.testing.assert_array_equal(back.graph.neighbors,
                                  j_index.graph.neighbors)


def test_from_numpy_and_registry(dyadic_builds):
    j_index = dyadic_builds[1][0]
    idx = port.RoarGraphIndex.from_numpy(j_index.graph.neighbors,
                                         j_index.graph.ep, "ip", 32)
    assert port.get_index_cls("roargraph") is port.RoarGraphIndex
    assert idx.graph.max_degree == j_index.graph.max_degree
    assert idx.graph.neighbors.dtype == np.int32
    assert idx.graph.ep == j_index.graph.ep


@pytest.fixture(scope="module")
def fused_builds(tmp_path_factory):
    """Both packages build with the fused phase-D engine, 1 and then 2
    passes, the 2-pass builds resuming from each package's own 1-pass
    checkpoints. M_pjbp=8 makes the supply width 16, the table's own; with
    16 rounds (the int8 builds) the first pass repacks incrementally after
    its first round, a third of the rows changing per round."""
    rng = np.random.default_rng(1)
    base, train = _dyadic(rng, (2000, 32)), _dyadic(rng, (800, 32))
    _, knn = j_knn(train, base, k=24, metric="ip", precision="highest")
    out = {}
    for bits, expand, rounds in ((8, 1, 16), (4, 4, 4)):
        j_dir = str(tmp_path_factory.mktemp(f"jax_fused{bits}"))
        t_dir = str(tmp_path_factory.mktemp(f"port_fused{bits}"))
        for passes in (1, 2):
            kw = dict(M_sq=24, M_pjbp=8, L_pjpq=48, metric="ip",
                      query_batch=512, search_batch=512,
                      connectivity_iters=rounds, connectivity_passes=passes,
                      connectivity_engine="fused", connectivity_bits=bits,
                      connectivity_expand=expand)
            out[bits, passes] = (
                j_build(base, train, knn, JConfig(**kw), verbose=False,
                        checkpoint_dir=j_dir),
                port.build_roargraph(base, train, knn, port.BuildConfig(**kw),
                                     verbose=False, checkpoint_dir=t_dir,
                                     device="cpu"))
    return out


@pytest.mark.parametrize("bits,passes", [(8, 1), (8, 2), (4, 1), (4, 2)])
def test_fused_build_identical_on_dyadic_data(fused_builds, bits, passes):
    want, got = fused_builds[bits, passes]
    assert got.graph.ep == want.graph.ep
    np.testing.assert_array_equal(got.graph.neighbors, want.graph.neighbors)
    st = got.graph.degree_stats()
    assert st["zero"] == 0 and st["max"] <= 16


def test_fused_engine_not_ported():
    """The fused engine, named or picked by "auto", builds a valid graph
    (the port once raised NotImplementedError here)."""
    rng = np.random.default_rng(2)
    base = _dyadic(rng, (300, 16))
    _, knn = j_knn(base[:60], base, k=8, metric="ip", precision="highest")
    for engine in ("fused", "auto"):   # auto resolves to fused at this size
        cfg = port.BuildConfig(M_sq=8, M_pjbp=4, L_pjpq=16,
                               connectivity_engine=engine,
                               query_batch=128, search_batch=128)
        assert port.graph.roargraph._resolve_engine(cfg, 300, 16) == "fused"
        index = port.build_roargraph(base, base[:60], knn, cfg,
                                     verbose=False, device="cpu")
        index.graph.validate()
        st = index.graph.degree_stats()
        assert st["zero"] == 0 and st["max"] <= 8


def test_fused_build_with_seeds():
    """connectivity_seeds: phase-D searches start from sample-scan seeds;
    the graph stays valid and the checkpoint tag names the seeding."""
    rng = np.random.default_rng(3)
    base = _dyadic(rng, (400, 16))
    _, knn = j_knn(base[:80], base, k=8, metric="ip", precision="highest")
    cfg = port.BuildConfig(M_sq=8, M_pjbp=8, L_pjpq=24,
                           connectivity_engine="fused", connectivity_seeds=8,
                           connectivity_seed_sample=4, connectivity_bits=4,
                           query_batch=128, search_batch=128)
    assert port.graph.roargraph._phase_d_knob_tag(cfg, 400, 16).endswith(
        "b4s8r4")
    index = port.build_roargraph(base, base[:80], knn, cfg, verbose=False,
                                 device="cpu")
    index.graph.validate()
    st = index.graph.degree_stats()
    assert st["zero"] == 0 and st["max"] <= 16


def test_resolve_engine_matches_jax():
    from mysteryann_tpu.graph.roargraph import (_phase_d_knob_tag as j_tag,
                                                _resolve_engine as j_res)
    from mysteryann_tpu_torch.graph.roargraph import (_phase_d_knob_tag,
                                                      _resolve_engine)
    for n, d, kw in ((1_000_000, 128, dict(M_pjbp=32, connectivity_bits=4)),
                     (1_000_000, 128, dict(M_pjbp=32)),
                     (3_000_000, 128, dict(M_pjbp=32)),
                     (10_000_000, 128, dict(M_pjbp=32, connectivity_bits=4)),
                     (5000, 20, dict(connectivity_bits=4)),
                     (5000, 24, dict(connectivity_seeds=8)),
                     (5000, 32, dict(connectivity_engine="classic"))):
        assert _resolve_engine(port.BuildConfig(**kw), n, d) == \
            j_res(JConfig(**kw), n, d), (n, d, kw)
        assert _phase_d_knob_tag(port.BuildConfig(**kw), n, d) == \
            j_tag(JConfig(**kw), n, d), (n, d, kw)
    # the bench's recipe resolves to fused at 1M x 128
    assert _resolve_engine(port.BuildConfig(M_pjbp=32, connectivity_bits=4),
                           1_000_000, 128) == "fused"


def test_fused_engine_needs_aligned_dims():
    base = np.zeros((64, 20), np.float32)
    knn = np.zeros((8, 8), np.int32)
    cfg = port.BuildConfig(M_sq=8, M_pjbp=4, L_pjpq=8,
                           connectivity_engine="fused")
    with pytest.raises(ValueError, match="dim % 8"):
        port.build_roargraph(base, base[:8], knn, cfg, verbose=False,
                             device="cpu")


def test_medoid_matches():
    rng = np.random.default_rng(4)
    base = _dyadic(rng, (500, 16))
    assert port.compute_medoid(torch.from_numpy(base)) == \
        j_medoid(jnp.asarray(base))
