"""Port lockstep beam search against the JAX package on a graph it built.

Dyadic vectors (integers / 64) keep every distance exact in float32, so
ids, dists, cmps, hops and the expansion history must be identical in every
visited mode.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mysteryann_tpu.graph import build_roargraph
from mysteryann_tpu.ops import exact_knn
from mysteryann_tpu.search import beam as jbeam
from mysteryann_tpu.utils.params import BuildConfig
from mysteryann_tpu_torch.search import beam as tbeam

N, D = 1000, 16


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(3)
    base = (rng.integers(-64, 65, size=(N, D)) / 64).astype(np.float32)
    train = (rng.integers(-64, 65, size=(300, D)) / 64).astype(np.float32)
    queries = (rng.integers(-64, 65, size=(40, D)) / 64).astype(np.float32)
    _, knn = exact_knn(train, base, k=16, metric="ip", precision="highest")
    cfg = BuildConfig(M_sq=16, M_pjbp=8, L_pjpq=32, metric="ip",
                      query_batch=256, search_batch=256,
                      connectivity_iters=2, connectivity_engine="classic")
    index = build_roargraph(base, train, knn, cfg, verbose=False)
    return base, queries, index.graph.neighbors, index.graph.ep


def _run_both(world, **kw):
    base, queries, nb, ep = world
    seeds = kw.pop("seed_ids", None)
    j = jbeam.beam_search(
        jnp.asarray(base), jnp.asarray(nb), jnp.asarray([ep], jnp.int32),
        jnp.asarray(queries),
        seed_ids=None if seeds is None else jnp.asarray(seeds), **kw)
    t = tbeam.beam_search(
        torch.from_numpy(base), torch.from_numpy(nb),
        torch.tensor([ep], dtype=torch.int32), torch.from_numpy(queries),
        seed_ids=None if seeds is None else torch.from_numpy(seeds), **kw)
    return j, t


def _assert_same(j, t):
    for name in ("ids", "dists", "cmps", "hops", "hist_ids", "hist_d"):
        jv, tv = getattr(j, name), getattr(t, name)
        if jv is None:
            assert tv is None, name
            continue
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                      err_msg=name)


@pytest.mark.parametrize("metric,mode,expand", [
    ("ip", "bitmask", 1), ("ip", "bitmask", 4),
    ("ip", "pool", 1), ("ip", "pool", 4),
    ("ip", "merge", 1), ("ip", "merge", 4),
    ("l2", "bitmask", 1), ("l2", "pool", 4),
])
def test_beam_modes_identical(world, metric, mode, expand):
    j, t = _run_both(world, k=10, L=32, metric=metric, expand=expand,
                     visited_mode=mode)
    _assert_same(j, t)
    assert (t.hops.numpy() > 0).all()


@pytest.mark.parametrize("expand", [1, 4])
def test_beam_collect_expanded(world, expand):
    # the build's call: pool mode, k=1, history of 3L
    j, t = _run_both(world, k=1, L=24, metric="ip", expand=expand,
                     visited_mode="pool", collect_expanded=72)
    _assert_same(j, t)


def test_beam_seed_ids(world):
    rng = np.random.default_rng(9)
    seeds = rng.integers(0, N, size=(40, 6)).astype(np.int32)
    j, t = _run_both(world, k=10, L=24, metric="ip", visited_mode="bitmask",
                     seed_ids=seeds)
    _assert_same(j, t)


@pytest.mark.parametrize("mode", ["bitmask", "pool"])
def test_beam_max_hops_cap_binds(world, mode):
    j, t = _run_both(world, k=5, L=32, metric="ip", expand=2,
                     visited_mode=mode, max_hops=5, collect_expanded=16)
    _assert_same(j, t)
    # capped for every query: the entry point alone in step 1, then two
    # pops in each of the 4 steps left
    assert (t.hops.numpy() == 9).all()


def test_scatter_or_bits_bit31():
    rng = np.random.default_rng(2)
    B, M, W = 6, 24, 4
    ids = np.stack([rng.choice(W * 32, size=M, replace=False)
                    for _ in range(B)]).astype(np.int32)
    ids[:, 0] = 31                               # bit 31 of word 0
    ids[:, 1] = 63                               # bit 31 of word 1
    active = rng.random((B, M)) < 0.8
    active[:, :2] = True
    start = rng.integers(0, 1 << 32, size=(B, W), dtype=np.uint64)
    jv = jbeam._scatter_or_bits(
        jnp.asarray(start.astype(np.uint32)), jnp.asarray(ids >> 5),
        jnp.uint32(1) << jnp.asarray(ids & 31).astype(jnp.uint32),
        jnp.asarray(active))
    tv = tbeam._scatter_or_bits(
        torch.from_numpy(start.astype(np.uint32).view(np.int32)),
        torch.from_numpy(ids >> 5), tbeam._bit_of(torch.from_numpy(ids)),
        torch.from_numpy(active))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32), np.asarray(jv))


def test_search_batched_matches(world):
    base, queries, nb, ep = world
    jr = jbeam.search_batched(jnp.asarray(base), jnp.asarray(nb),
                              jnp.asarray([ep], jnp.int32), queries, k=10,
                              L=32, query_batch=16, visited_mode="pool")
    tr = tbeam.search_batched(torch.from_numpy(base), torch.from_numpy(nb),
                              torch.tensor([ep], dtype=torch.int32), queries,
                              k=10, L=32, query_batch=16, visited_mode="pool")
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b, a)


def test_two_hop_not_ported(world):
    base, queries, nb, ep = world
    with pytest.raises(NotImplementedError):
        tbeam.beam_search(torch.from_numpy(base), torch.from_numpy(nb),
                          torch.tensor([ep], dtype=torch.int32),
                          torch.from_numpy(queries), k=10, L=32, two_hop=True)
