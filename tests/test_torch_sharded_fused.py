"""The port's ShardedFusedSearcher against the JAX package's and against the
port's single-card FusedSearcher, case for case.

Counterparts of tests/test_sharded_fused.py. Each world's graph is built
once with the port (classic engine, on the CPU) and serves three things:
the JAX package's ShardedFusedSearcher on the conftest's 8-device virtual
mesh (in this process), the port's in 8 gloo ranks (dp=2 x mp=4) spawned
once for the module by ``parallel.launch``, and the port's single-card
FusedSearcher in merge mode at the ranks' batch (B / dp). Tolerances:

- dyadic world (integers / 64: every distance exact in f32): ids, dists,
  cmps and hops bit for bit against both;
- Gaussian world (the JAX test's own): bit for bit against the port's
  single-card searcher; against the JAX package ids >= 0.999, dists within
  1e-4, and the JAX test's recall bars.
"""

import numpy as np
import pytest
import torch

from mysteryann_tpu.graph.adjacency import PaddedGraph as JGraph
from mysteryann_tpu.graph.roargraph import RoarGraphIndex as JIndex
from mysteryann_tpu.io import make_cross_modal
from mysteryann_tpu.ops import exact_knn
from mysteryann_tpu.ops.distances import Metric as JMetric
from mysteryann_tpu.parallel import ShardedFusedSearcher as JSharded
from mysteryann_tpu.parallel import make_mesh as jmake_mesh
from mysteryann_tpu.parallel.sharded_fused import _pack_shard_host
from mysteryann_tpu.search.fused import _row_bytes as jrow_bytes
from mysteryann_tpu_torch.graph import build_roargraph
from mysteryann_tpu_torch.graph.adjacency import PaddedGraph
from mysteryann_tpu_torch.graph.roargraph import RoarGraphIndex
from mysteryann_tpu_torch.ops.distances import Metric, prepare_vectors
from mysteryann_tpu_torch.ops.knn import exact_knn_device
from mysteryann_tpu_torch.parallel import launch
from mysteryann_tpu_torch.parallel.sharded_fused import _pack_shard
from mysteryann_tpu_torch.search.fused import (FusedSearcher, _pack_chunk,
                                               _row_bytes)
from mysteryann_tpu_torch.utils.params import BuildConfig

SPAWN_TIMEOUT_S = 300
DP, MP = 2, 4
K, L = 10, 24
ID_AGREE = 0.999      # Gaussian world
TOL = 1e-4
FIELDS = ("ids", "dists", "cmps", "hops")
CFG = dict(M_sq=24, M_pjbp=8, L_pjpq=32, metric="ip",
           connectivity_engine="classic")


def _world(base, train, queries):
    knn = exact_knn_device(torch.from_numpy(train), torch.from_numpy(base),
                           k=CFG["M_sq"], metric="ip")[1].numpy()
    g = build_roargraph(base, train, knn, BuildConfig(**CFG), verbose=False,
                        device="cpu").graph
    _, gt = exact_knn(queries, base, k=K, metric="ip", precision="highest")
    return {"base": base, "queries": queries, "graph": g.neighbors,
            "ep": g.ep, "gt": np.asarray(gt)}


def _worlds():
    base, train = make_cross_modal(4000, 800, 32, metric="ip", seed=11)
    _, eval_q = make_cross_modal(1, 64, 32, metric="ip", seed=11,
                                 query_seed=5)
    # the dyadic world has the Gaussian one's shapes, so the JAX package
    # compiles each case once
    rng = np.random.default_rng(9)
    db = (rng.integers(-64, 65, size=(4000, 32)) / 64).astype(np.float32)
    dt = (rng.integers(-64, 65, size=(800, 32)) / 64).astype(np.float32)
    dq = (rng.integers(-64, 65, size=(64, 32)) / 64).astype(np.float32)
    return {"gauss": _world(base, train, eval_q),
            "dyadic": _world(db, dt, dq)}


def _case(name, world, metric="ip", bits=8, expand=1, seeds=0,
          seed_sample=0):
    return {"name": name, "kind": "sharded_fused", "world": world,
            "dp": DP, "mp": MP, "metric": metric,
            "init": {"bits": bits, "seed_sample": seed_sample},
            "opts": {"k": K, "L": L, "expand": expand, "seeds": seeds}}


# test_sharded_fused.py's cases, on its Gaussian world and on a dyadic one
BITS_EXPAND = [(8, 1), (8, 2), (4, 2)]
CASES = [c for w in ("gauss", "dyadic") for c in (
    [_case(f"{w}_b{b}_e{e}", w, bits=b, expand=e) for b, e in BITS_EXPAND]
    + [_case(f"{w}_seeded", w, expand=2, seeds=8, seed_sample=4),
       _case(f"{w}_l2", w, metric="l2", expand=2)])]
CASES.append({"name": "fused_errors", "kind": "fused_errors", "world": "gauss",
              "dp": DP, "mp": MP, "metric": "ip", "init": {"bits": 8}})


@pytest.fixture(scope="module")
def worlds():
    return _worlds()


@pytest.fixture(scope="module")
def ranks(worlds):
    """All cases in one spawn of 8 gloo ranks; rank 0's results, after
    checking that every rank gathered the same."""
    from torch_parallel_ranks import ranks_agree
    out = launch.run("torch_parallel_ranks:run_cases", 8, (worlds, CASES),
                     timeout=SPAWN_TIMEOUT_S)
    assert ranks_agree(out)
    return out[0]


def _by_name(name):
    return next(c for c in CASES if c["name"] == name)


def _jax(case, w):
    """The JAX package's ShardedFusedSearcher on the virtual mesh."""
    index = JIndex(graph=JGraph(neighbors=w["graph"], ep=w["ep"]),
                   metric=JMetric.parse(case["metric"]),
                   dim=w["base"].shape[1])
    sf = JSharded(jmake_mesh(dp=DP, mp=MP), index, w["base"], **case["init"])
    return dict(zip(FIELDS, sf.search(w["queries"], **case["opts"])))


def _single(case, w):
    """The port's single-card FusedSearcher at the ranks' batch."""
    index = RoarGraphIndex(graph=PaddedGraph(neighbors=w["graph"],
                                             ep=w["ep"]),
                           metric=Metric.parse(case["metric"]),
                           dim=w["base"].shape[1])
    fs = FusedSearcher(index, w["base"], device="cpu", **case["init"])
    q = w["queries"]
    return dict(zip(FIELDS, fs.search(q, query_batch=q.shape[0] // DP,
                                      visited_mode="merge",
                                      **case["opts"])))


def _recall(found, gt):
    hits = sum(len(set(f.tolist()) & set(g.tolist()))
               for f, g in zip(found, gt))
    return hits / gt.size


def _check(ranks, worlds, name):
    case = _by_name(name)
    w = worlds[case["world"]]
    got, want_j, want_t = ranks[name], _jax(case, w), _single(case, w)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want_t[f], err_msg=f)
    if case["world"] == "dyadic":
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], want_j[f], err_msg=f)
    else:
        assert (got["ids"] == want_j["ids"]).mean() >= ID_AGREE
        np.testing.assert_allclose(got["dists"], want_j["dists"], rtol=TOL,
                                   atol=TOL)
    assert got["ids"].shape == (w["queries"].shape[0], K)
    return got, w


@pytest.mark.parametrize("world", ["gauss", "dyadic"])
@pytest.mark.parametrize("bits,expand", BITS_EXPAND)
def test_sharded_matches_single_chip(ranks, worlds, world, bits, expand):
    got, w = _check(ranks, worlds, f"{world}_b{bits}_e{expand}")
    if world == "gauss":
        assert _recall(got["ids"], w["gt"]) > 0.85


@pytest.mark.parametrize("world", ["gauss", "dyadic"])
def test_sharded_seeded_matches_single_chip(ranks, worlds, world):
    got, w = _check(ranks, worlds, f"{world}_seeded")
    if world == "gauss":
        assert _recall(got["ids"], w["gt"]) > 0.9


@pytest.mark.parametrize("world", ["gauss", "dyadic"])
def test_sharded_l2_matches_single_chip(ranks, worlds, world):
    _check(ranks, worlds, f"{world}_l2")


def test_sharded_fused_arg_validation(ranks):
    # the JAX package's checks, raised on every rank before any collective
    err = ranks["fused_errors"]
    assert "seeds > 0 needs seed_sample" in err["seeds_without_sample"]
    assert "seeds (30) must be <= L (24)" in err["seeds_over_L"]
    assert "k (30) must be <= L (24)" in err["k_over_L"]


def test_10m_shard_packing_math():
    """The 10M-shape packing arithmetic of scripts/torch_bench_10m.py
    --sharded-fused at mp 8 and 4: the port's rows carry no 1 KB padding,
    so R is 2,304 B (the JAX package's 3,072 B)."""
    n, d, M, bits = 10_000_000, 128, 32, 4
    R = _row_bytes(M, d, bits)
    assert R == 2304 and jrow_bytes(M, d, bits) == 3072
    assert n * R == 23_040_000_000          # the whole table, 23.0 GB
    sn = -(-n // 8)
    assert sn == 1_250_000
    assert (sn + 1) * R == 2_880_002_304     # a shard at mp 8
    assert (-(-n // 4) + 1) * R == 5_760_002_304   # at mp 4
    assert sn * d * 4 == 640_000_000         # an f32 rerank base shard
    for gid in (0, sn - 1, sn, n - 1):
        owner, local = gid // sn, gid % sn
        assert owner * sn + local == gid and 0 <= owner < 8


@pytest.mark.parametrize("bits", [8, 4])
def test_pack_shard_tail_padding(bits):
    """A non-divisible n: the tail shard's rows past the corpus and its
    local sentinel row pack as sentinel rows; the real row is
    _pack_chunk's, and every row is the JAX package's _pack_shard_host row
    without its padding (dyadic values: the same scales)."""
    n, d, M, mp = 10, 16, 16, 4
    sn = -(-n // mp)   # 3 rows a shard: shard 3 holds row 9, then padding
    rng = np.random.default_rng(0)
    base = (rng.integers(-64, 65, size=(n, d)) / 64).astype(np.float32)
    nb = rng.integers(0, n, size=(n, M)).astype(np.int32)
    bt = prepare_vectors(base, "ip", "cpu")
    shard = _pack_shard(bt, nb, 3 * sn, sn, n, M, d, bits).numpy()
    R = _row_bytes(M, d, bits)
    assert shard.shape == (sn + 1, R)
    sent = _pack_chunk(bt, torch.full((1, M), n, dtype=torch.int32),
                       n_base=n, M=M, d=d, bits=bits).numpy()[0]
    real = _pack_chunk(bt, torch.from_numpy(nb[9:10]), n_base=n, M=M, d=d,
                       bits=bits).numpy()[0]
    np.testing.assert_array_equal(shard[0], real)
    for i in (1, 2, sn):
        np.testing.assert_array_equal(shard[i], sent)
    import jax.numpy as jnp
    jshard = np.asarray(_pack_shard_host(jnp.asarray(base), nb, 3 * sn, sn,
                                         n, M, d, bits))
    np.testing.assert_array_equal(shard, jshard.reshape(sn + 1, -1)[:, :R])


def test_pack_shard_rows_are_the_single_table_rows():
    """Every shard of a divisible and a non-divisible split holds the
    single-card table's rows for its ids."""
    from mysteryann_tpu_torch.search.fused import pack_neighbor_table
    rng = np.random.default_rng(1)
    n, d, M = 37, 32, 16
    bt = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    nb = rng.integers(0, n + 1, size=(n, M)).astype(np.int32)
    table, _ = pack_neighbor_table(bt, nb, bits=8)
    for mp in (1, 4, 5):
        sn = -(-n // mp)
        for j in range(mp):
            shard = _pack_shard(bt, nb, j * sn, sn, n, M, d, 8, chunk=7)
            avail = max(0, min(j * sn + sn, n) - j * sn)
            assert torch.equal(shard[:avail], table[j * sn: j * sn + avail])
            assert torch.equal(shard[avail:],
                               table[n:].expand(sn + 1 - avail, -1))
