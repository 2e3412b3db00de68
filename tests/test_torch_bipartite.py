"""Port bipartite index against the JAX package's ``graph/bipartite.py``.

Dyadic vectors (integers / 64) keep every distance exact in float32, so the
built adjacency, the entry-point draw and the two-hop beams (ids, dists,
cmps, hops) must be identical, chunked and unchunked.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mysteryann_tpu.graph import bipartite as jb
from mysteryann_tpu.ops import exact_knn
from mysteryann_tpu.search import beam as jbeam
from mysteryann_tpu.utils.params import BuildConfig as JCfg
from mysteryann_tpu_torch.graph import bipartite as tb
from mysteryann_tpu_torch.search import beam as tbeam
from mysteryann_tpu_torch.utils.metrics import compute_recall
from mysteryann_tpu_torch.utils.params import BuildConfig as TCfg

N, NQ, D, M = 600, 1800, 16, 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(5)
    base = (rng.integers(-64, 65, size=(N, D)) / 64).astype(np.float32)
    train = (rng.integers(-64, 65, size=(NQ, D)) / 64).astype(np.float32)
    q = (rng.integers(-64, 65, size=(64, D)) / 64).astype(np.float32)
    _, knn = exact_knn(train, base, k=M, metric="ip", precision="highest")
    return base, train, q, knn


@pytest.fixture(scope="module")
def built(world):
    base, train, _, knn = world
    cfg = dict(M_sq=M, M_pjbp=M, metric="ip")
    return (jb.build_bipartite(base, train, knn, JCfg(**cfg),
                               base_row_cap=16),
            tb.build_bipartite(base, train, knn, TCfg(**cfg),
                               base_row_cap=16))


@pytest.mark.parametrize("cap,metric", [(0, "ip"), (16, "ip"), (16, "l2"),
                                        (8, "cosine")])
def test_build_arrays_equal(world, cap, metric):
    base, train, _, knn = world
    cfg = dict(M_sq=M, M_pjbp=M, metric=metric)
    j = jb.build_bipartite(base, train, knn, JCfg(**cfg), base_row_cap=cap)
    t = tb.build_bipartite(base, train, knn, TCfg(**cfg), base_row_cap=cap)
    np.testing.assert_array_equal(t.neighbors, j.neighbors)
    assert (t.n_base, t.dim, t.metric.value) == (j.n_base, j.dim,
                                                 j.metric.value)


@pytest.mark.parametrize("chunk", [0, 3, 5, 16])
def test_two_hop_search_bit_identical(world, built, chunk):
    """chunk 0 takes the automatic rule (here: unchunked, chunk >= M);
    3 and 5 run the chunked loop, 5 with a narrower last chunk."""
    base, _, q, _ = world
    j, t = built
    js = jb.BipartiteSearcher(j, base, seed=3)
    ts = tb.BipartiteSearcher(t, base, seed=3, device="cpu")
    np.testing.assert_array_equal(ts.eps.numpy(), np.asarray(js.eps))
    a = js.search(q, k=10, L=32, query_batch=64, two_hop_chunk=chunk)
    b = ts.search(q, k=10, L=32, query_batch=64, two_hop_chunk=chunk)
    for x, y, name in zip(a, b, ("ids", "dists", "cmps", "hops")):
        np.testing.assert_array_equal(y, np.asarray(x), err_msg=name)
    assert b[3].min() > 0


def test_chunk_rule_matches_jax(built):
    _, t = built
    ts = tb.BipartiteSearcher(t, np.zeros((N, D), np.float32), device="cpu")
    for qb, d in ((64, 16), (4096, 128), (512, 512), (1, 8)):
        M_ = t.neighbors.shape[1]
        budget = (1 << 25) // max(1, qb * d)
        want = max(1, min(M_, budget // max(1, M_)))
        f_max = int(((1 << 27) // max(1, qb)) ** 0.5)
        want = max(1, min(want, f_max // max(1, M_)))
        assert ts.auto_two_hop_chunk(qb, d) == want


def test_beam_two_hop_chunked_equals_unchunked_on_its_own(world, built):
    """The port's chunked hop 2 equals its single [B, M·M] fan-out in
    every visited mode, and matches the JAX beam in pool mode."""
    base, _, q, _ = world
    j, t = built
    eps = np.array([3, 17, 250], np.int32)
    args = (torch.from_numpy(base), torch.from_numpy(t.neighbors),
            torch.from_numpy(eps), torch.from_numpy(q))
    for mode in ("bitmask", "pool", "merge"):
        full = tbeam.beam_search(*args, k=10, L=24, two_hop=True,
                                 visited_mode=mode)
        part = tbeam.beam_search(*args, k=10, L=24, two_hop=True,
                                 visited_mode=mode, two_hop_chunk=4,
                                 expand=3)   # two_hop forces expand 1
        for name in ("ids", "dists", "hops"):
            np.testing.assert_array_equal(getattr(part, name).numpy(),
                                          getattr(full, name).numpy())
    jr = jbeam.beam_search(jnp.asarray(base), jnp.asarray(j.neighbors),
                           jnp.asarray(eps), jnp.asarray(q), k=10, L=24,
                           two_hop=True, visited_mode="pool",
                           two_hop_chunk=4)
    tr = tbeam.beam_search(*args, k=10, L=24, two_hop=True,
                           visited_mode="pool", two_hop_chunk=4)
    for name in ("ids", "dists", "cmps", "hops"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)))


def test_save_load_search_and_benchmark(world, built, tmp_path):
    base, _, q, _ = world
    _, t = built
    p = str(tmp_path / "bip.index")
    t.save(p)
    loaded = tb.BipartiteIndex.load(p)
    np.testing.assert_array_equal(loaded.neighbors, t.neighbors)
    assert loaded.n_base == N
    s = tb.BipartiteSearcher(loaded, base, seed=3, device="cpu")
    r = s.benchmark(q, k=10, L=48, query_batch=32)
    _, gt = exact_knn(q, base, k=10, metric="ip", precision="highest")
    assert r["ids"].shape == (64, 10) and r["qps"] > 0
    assert np.all(r["ids"] < N)
    assert np.all(np.diff(r["dists"], axis=1) >= 0)
    assert compute_recall(r["ids"], gt, 10) > 0.6


def test_index_kinds_registered():
    from mysteryann_tpu_torch import get_index_cls
    assert get_index_cls("bipartite") is tb.BipartiteIndex
    from mysteryann_tpu_torch.ivf import IVFIndex
    assert get_index_cls("ivf") is IVFIndex
