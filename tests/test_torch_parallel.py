"""The port's parallel/ against the JAX package's, case for case.

Counterparts of tests/test_parallel.py and of the two
distributed_beam_search tests of tests/test_sharded_build.py. Each case
feeds the same seeded numpy inputs to three things: the JAX function on the
conftest's 8-device virtual mesh (in this process), the port's function in
8 gloo ranks spawned once for the module by ``parallel.launch`` (one
process per rank, as torch.distributed runs), and the port's single-device
function. Tolerances:

- dyadic worlds (integers / 64: every distance exact in f32): bit for bit —
  ids, dists, cmps, hops and the expansion history, in every visited mode
  and at expand 1, 2 and 4, and the sharded kNN's ids and dists;
- Gaussian worlds (the JAX tests' own): ids agree >= 0.999, dists within
  rtol / atol 1e-4, and the JAX tests' recall bars.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mysteryann_tpu.io import make_cross_modal
from mysteryann_tpu.ops import exact_knn
from mysteryann_tpu.ops.distances import Metric as JMetric
from mysteryann_tpu.parallel import make_mesh as jmake_mesh
from mysteryann_tpu.parallel import (distributed_beam_search as jdist,
                                     query_parallel_search as jqp,
                                     sharded_exact_knn as jknn)
from mysteryann_tpu_torch.ops.knn import exact_knn_device
from mysteryann_tpu_torch.parallel import launch, make_mesh
from mysteryann_tpu_torch.search.beam import beam_search as tbeam

SPAWN_TIMEOUT_S = 300
ID_AGREE = 0.999      # Gaussian worlds
TOL = 1e-4
FIELDS = ("ids", "dists", "cmps", "hops", "hist_ids", "hist_d")


def _knn_graph(base, metric, m=8):
    """Each row's m nearest other rows (the JAX tests' graph)."""
    _, ids = exact_knn(base, base, k=m + 1, metric=metric,
                       precision="highest")
    n = base.shape[0]
    graph = np.full((n, m), n, np.int32)
    for i in range(n):
        row = [j for j in ids[i] if j != i][:m]
        graph[i, : len(row)] = row
    return graph


def _worlds():
    gb, gq = make_cross_modal(1600, 64, 32, n_concepts=1, metric="ip",
                              seed=13)
    bb, _ = make_cross_modal(1024, 512, 32, metric="ip", seed=21)
    rng = np.random.default_rng(3)
    db = (rng.integers(-64, 65, size=(1000, 16)) / 64).astype(np.float32)
    dq = (rng.integers(-64, 65, size=(40, 16)) / 64).astype(np.float32)
    worlds = {"gauss": {"base": gb, "queries": gq},
              "build": {"base": bb, "queries": bb[:64].copy()},
              "dyadic": {"base": db, "queries": dq}}
    for w in worlds.values():
        w["graph_ip"] = _knn_graph(w["base"], "ip")
    for name in ("gauss", "dyadic"):
        worlds[name]["graph_l2"] = _knn_graph(worlds[name]["base"], "l2")
    return worlds


def _beam(name, world, dp, mp, graph="graph_ip", eps=(0,), **opts):
    return {"name": name, "kind": "beam", "world": world, "dp": dp,
            "mp": mp, "graph": graph, "eps": list(eps), "opts": opts}


KNN_CASES = [
    {"name": "knn_gauss", "kind": "knn", "world": "gauss", "dp": 2, "mp": 4,
     "k": 10, "metric": "ip"},
    {"name": "knn_dyadic_ip", "kind": "knn", "world": "dyadic", "dp": 2,
     "mp": 4, "k": 10, "metric": "ip"},
    {"name": "knn_dyadic_l2", "kind": "knn", "world": "dyadic", "dp": 4,
     "mp": 2, "k": 10, "metric": "l2"},
]
# test_parallel.py's beams, on its Gaussian world and on the dyadic one
BEAM_CASES = [
    c for w in ("gauss", "dyadic") for c in (
        _beam(f"beam_ip_{w}", w, 2, 4, k=10, L=64, metric="ip"),
        _beam(f"beam_l2_{w}", w, 4, 2, graph="graph_l2", eps=(3,), k=10,
              L=64, metric="l2"),
        _beam(f"beam_merge_{w}", w, 2, 4, k=10, L=64, metric="ip",
              visited_mode="merge"))]
# every visited mode at expand 1, 2 and 4 with the history, dyadic
MODES = [(m, e) for m in ("bitmask", "pool", "merge") for e in (1, 2, 4)]
MODE_CASES = [_beam(f"modes_{m}_{e}", "dyadic", 2, 4, k=10, L=32,
                    metric="ip", visited_mode=m, expand=e,
                    collect_expanded=96) for m, e in MODES]
# test_sharded_build.py's two traversal tests: pool mode, k=1, L=32, a
# history of 3L, entry 3, expand 1, 2 and 4
BUILD_CASES = [_beam(f"build_{w}_{e}", w, 2, 4, eps=(3,), k=1, L=32,
                     metric="ip", visited_mode="pool", collect_expanded=96,
                     expand=e)
               for w in ("build", "dyadic") for e in (1, 2, 4)]
QP_CASES = [{"name": f"qp_{w}", "kind": "query_parallel", "world": w,
             "dp": 4, "mp": 2, "graph": "graph_ip", "eps": [0],
             "opts": {"k": 10, "L": 64, "metric": "ip"}}
            for w in ("gauss", "dyadic")]
CASES = KNN_CASES + BEAM_CASES + MODE_CASES + BUILD_CASES + QP_CASES


@pytest.fixture(scope="module")
def worlds():
    return _worlds()


@pytest.fixture(scope="module")
def ranks(worlds):
    """All cases in one spawn of 8 gloo ranks; rank 0's results, after
    checking that every rank gathered the same."""
    from torch_parallel_ranks import ranks_agree
    out = launch.run("torch_parallel_ranks:run_cases", 8,
                     (worlds, CASES), timeout=SPAWN_TIMEOUT_S)
    assert ranks_agree(out)
    return out[0]


def _case(name):
    return next(c for c in CASES if c["name"] == name)


def _jax(case, w):
    """The JAX package's sharded function on the virtual mesh."""
    mesh = jmake_mesh(dp=case["dp"], mp=case["mp"])
    if case["kind"] == "knn":
        d, i = jknn(mesh, jnp.asarray(w["queries"]), jnp.asarray(w["base"]),
                    k=case["k"], metric=JMetric.parse(case["metric"]))
        return {"dists": np.asarray(d), "ids": np.asarray(i)}
    fn = jdist if case["kind"] == "beam" else jqp
    opts = dict(case["opts"], metric=JMetric.parse(case["opts"]["metric"]))
    r = fn(mesh, jnp.asarray(w["base"]), jnp.asarray(w[case["graph"]]),
           jnp.asarray(case["eps"], jnp.int32), jnp.asarray(w["queries"]),
           **opts)
    return {f: np.asarray(getattr(r, f)) for f in FIELDS
            if getattr(r, f) is not None}


def _single(case, w):
    """The port's single-device function on the CPU."""
    if case["kind"] == "knn":
        d, i = exact_knn_device(torch.from_numpy(w["queries"]),
                                torch.from_numpy(w["base"]), k=case["k"],
                                metric=case["metric"])
        return {"dists": d.numpy(), "ids": i.numpy()}
    r = tbeam(torch.from_numpy(w["base"]),
              torch.from_numpy(w[case["graph"]]),
              torch.tensor(case["eps"], dtype=torch.int32),
              torch.from_numpy(w["queries"]), **case["opts"])
    return {f: getattr(r, f).numpy() for f in FIELDS
            if getattr(r, f) is not None}


def _same(got, want, fields=FIELDS):
    for f in fields:
        if f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _close(got, want, exact_counts=True):
    """The Gaussian bars: ids >= 0.999, dists within 1e-4; traversal
    counters (hops, cmps) equal where the JAX test holds them equal."""
    assert (got["ids"] == want["ids"]).mean() >= ID_AGREE
    np.testing.assert_allclose(got["dists"], want["dists"], rtol=TOL,
                               atol=TOL)
    if exact_counts and "hops" in want:
        np.testing.assert_array_equal(got["hops"], want["hops"])
        np.testing.assert_array_equal(got["cmps"], want["cmps"])


def _recall(found, gt):
    hits = sum(len(set(f.tolist()) & set(g.tolist()))
               for f, g in zip(found, gt))
    return hits / gt.size


def _check(ranks, worlds, name):
    case = _case(name)
    w = worlds[case["world"]]
    got, want_j, want_t = ranks[name], _jax(case, w), _single(case, w)
    if case["world"] == "dyadic":
        _same(got, want_j)
        _same(got, want_t)
    else:
        _close(got, want_j)
        _close(got, want_t)
    return case, w, got


@pytest.mark.parametrize("name", [c["name"] for c in KNN_CASES])
def test_sharded_knn_matches_single(ranks, worlds, name):
    case, w, got = _check(ranks, worlds, name)
    assert got["ids"].shape == (w["queries"].shape[0], case["k"])


@pytest.mark.parametrize("world", ["gauss", "dyadic"])
def test_distributed_beam_matches_single_device(ranks, worlds, world):
    _, w, got = _check(ranks, worlds, f"beam_ip_{world}")
    if world == "gauss":
        _, gt = exact_knn(w["queries"], w["base"], k=10, metric="ip",
                          precision="highest")
        assert _recall(got["ids"], gt) > 0.75


@pytest.mark.parametrize("world", ["gauss", "dyadic"])
def test_distributed_beam_l2(ranks, worlds, world):
    _, w, got = _check(ranks, worlds, f"beam_l2_{world}")
    if world == "gauss":
        _, gt = exact_knn(w["queries"], w["base"], k=10, metric="l2",
                          precision="highest")
        assert _recall(got["ids"], gt) > 0.75


@pytest.mark.parametrize("world", ["gauss", "dyadic"])
def test_distributed_beam_merge_mode(ranks, worlds, world):
    """No-visited-state mode: the bitmask mode's results up to
    pool-boundary ties, the same hops, cmps at least the bitmask's."""
    _check(ranks, worlds, f"beam_merge_{world}")
    rm, rb = ranks[f"beam_merge_{world}"], ranks[f"beam_ip_{world}"]
    assert (rm["ids"] == rb["ids"]).mean() > 0.99
    np.testing.assert_array_equal(rm["hops"], rb["hops"])
    assert np.all(rm["cmps"] >= rb["cmps"])


@pytest.mark.parametrize("mode,expand", MODES)
def test_distributed_beam_modes_bit_identical(ranks, worlds, mode, expand):
    _, _, got = _check(ranks, worlds, f"modes_{mode}_{expand}")
    assert "hist_ids" in got and (got["hops"] > 0).all()


@pytest.mark.parametrize("world", ["build", "dyadic"])
def test_distributed_pool_search_hist_matches(ranks, worlds, world):
    _, _, got = _check(ranks, worlds, f"build_{world}_1")
    want = _single(_case(f"build_{world}_1"), worlds[world])
    if world == "dyadic":
        _same(got, want, ("hist_ids", "hist_d"))
    else:
        assert (got["hist_ids"] == want["hist_ids"]).mean() >= ID_AGREE


@pytest.mark.parametrize("world", ["build", "dyadic"])
@pytest.mark.parametrize("expand", [2, 4])
def test_distributed_search_expand_matches(ranks, worlds, world, expand):
    name = f"build_{world}_{expand}"
    _, _, got = _check(ranks, worlds, name)
    want = _single(_case(name), worlds[world])
    if world == "dyadic":
        _same(got, want, ("hist_ids", "hops"))
    else:
        assert (got["hist_ids"] == want["hist_ids"]).mean() >= ID_AGREE


@pytest.mark.parametrize("world", ["gauss", "dyadic"])
def test_query_parallel_search(ranks, worlds, world):
    _, w, got = _check(ranks, worlds, f"qp_{world}")
    if world == "gauss":
        _, gt = exact_knn(w["queries"], w["base"], k=10, metric="ip",
                          precision="highest")
        assert _recall(got["ids"], gt) > 0.75


def test_mesh_validation(ranks):
    # in the pytest process (no process group: a world of one) and in the
    # 8 spawned ranks
    with pytest.raises(ValueError, match="devices"):
        make_mesh(dp=16, mp=16, device="cpu")
    assert "devices" in ranks["mesh_validation"]
    with pytest.raises(ValueError, match="devices"):
        jmake_mesh(dp=16, mp=16)
    assert len(jax.devices()) == 8


def test_mesh_on_a_subset_of_ranks(ranks):
    # make_mesh(1, 4, devices=[4..7]): ranks 0-3 get None, ranks 4-7 form
    # the mesh in order and sum 5 + 6 + 7 + 8 over mp, as the JAX mesh
    # over devices 4..7 lays them
    jm = jmake_mesh(dp=1, mp=4, devices=jax.devices()[4:])
    assert [d.id for d in jm.devices.ravel()] == [4, 5, 6, 7]
    assert ranks["mesh_subset"] == [(True, None, None)] * 4 + [
        (False, 26.0, (0, m)) for m in range(4)]


def test_sharded_argument_errors(ranks):
    # the JAX package's errors: mp must divide N (here: base shards of
    # unequal size) and L >= E, raised by every rank together
    assert "mp must divide N" in ranks["errors"]["knn_uneven"]
    assert "must be >= number of entry points" in \
        ranks["errors"]["beam_l_below_e"]
