"""The port's sharded build against the JAX package's and against the port's
single-device build, case for case.

Counterparts of tests/test_sharded_build.py (its two traversal tests are in
tests/test_torch_parallel.py). Each case feeds the same seeded numpy inputs
to the port's function in 8 gloo ranks (dp=2 x mp=4) spawned once for the
module by ``parallel.launch``, to the port's single-device function on the
CPU at the ranks' batches (``query_batch`` and ``search_batch`` divided by
dp), and to the JAX package's sharded function on the conftest's
8-device virtual mesh. Tolerances:

- dyadic world (integers / 64: every distance exact in f32): the graph
  (entry point and every neighbour) bit for bit against both;
- Gaussian world (the JAX test's own): bit for bit against the port's
  single-device build; against the JAX package's, the neighbour ids agree
  >= 0.999.
"""

import numpy as np
import pytest
import torch

from mysteryann_tpu.io import make_cross_modal
from mysteryann_tpu.ops import exact_knn
from mysteryann_tpu.parallel import make_mesh as jmake_mesh
from mysteryann_tpu.parallel.sharded_build import \
    sharded_build_roargraph as jbuild
from mysteryann_tpu.utils.params import BuildConfig as JConfig
from mysteryann_tpu_torch.graph import build_roargraph
from mysteryann_tpu_torch.graph.roargraph import _batched_prune_rows
from mysteryann_tpu_torch.ops.distances import prepare_vectors
from mysteryann_tpu_torch.ops.knn import exact_knn_device
from mysteryann_tpu_torch.parallel import launch
from mysteryann_tpu_torch.utils.params import BuildConfig

SPAWN_TIMEOUT_S = 300
ID_AGREE = 0.999      # Gaussian world, against the JAX package
DP, MP = 2, 4
N, NQ, D = 1024, 512, 32
# classic engine on both sides: the sharded phase D is the classic
# traversal (the fused byte-row engine is a single-card accelerator).
# Two rounds of 512 rows a pass, searched in dp batches of 192 rows: a
# round's last step gives rank 0 a short batch and rank 1 none
CFG = dict(M_sq=24, M_pjbp=8, L_pjpq=32, metric="ip", query_batch=256,
           search_batch=384, connectivity_iters=2,
           connectivity_engine="classic")
RECIPES = {"one_pass": {}, "two_pass": {"connectivity_passes": 2},
           "expand4": {"connectivity_expand": 4, "connectivity_passes": 2}}


def _worlds():
    base, train = make_cross_modal(N, NQ, D, metric="ip", seed=21)
    _, knn = exact_knn(train, base, k=CFG["M_sq"], metric="ip",
                       precision="highest")
    rng = np.random.default_rng(5)
    db = (rng.integers(-64, 65, size=(N, D)) / 64).astype(np.float32)
    dt = (rng.integers(-64, 65, size=(NQ, D)) / 64).astype(np.float32)
    dknn = exact_knn_device(torch.from_numpy(dt), torch.from_numpy(db),
                            k=CFG["M_sq"], metric="ip")[1].numpy()
    worlds = {"gauss": {"base": base, "train": train,
                        "knn": np.asarray(knn, np.int32)},
              "dyadic": {"base": db, "train": dt, "knn": dknn}}
    for w in worlds.values():
        w["tgt"] = w["knn"][:, 0].astype(np.int32)
        w["cand"] = np.where(w["knn"] == w["tgt"][:, None], N,
                             w["knn"]).astype(np.int32)
    rng = np.random.default_rng(0)
    worlds["rows"] = {"arr": np.arange(64 * 6, dtype=np.int32).reshape(64, 6),
                      "ids": np.array([0, 17, 33, 63, 5, 48], np.int32),
                      "rows": rng.integers(-9, 0, size=(6, 6)).astype(
                          np.int32)}
    return worlds


def _case(name, kind, world, **opts):
    return {"name": name, "kind": kind, "world": world, "dp": DP, "mp": MP,
            "metric": "ip", "opts": opts}


CASES = ([_case(f"prune_{w}", "prune_rows", w, cap=CFG["M_pjbp"], batch=256,
                fill=True) for w in ("gauss", "dyadic")]
         + [_case("take_scatter", "take_scatter", "rows")]
         + [_case(f"build_{r}_{w}", "sharded_build", w, **CFG, **extra)
            for r, extra in RECIPES.items() for w in ("gauss", "dyadic")]
         + [_case("build_errors", "build_errors", "gauss", **CFG)])


@pytest.fixture(scope="module")
def worlds():
    return _worlds()


@pytest.fixture(scope="module")
def ranks(worlds):
    """All cases in one spawn of 8 gloo ranks; rank 0's results, after
    checking that every rank got the same."""
    from torch_parallel_ranks import ranks_agree
    out = launch.run("torch_parallel_ranks:run_cases", 8, (worlds, CASES),
                     timeout=SPAWN_TIMEOUT_S)
    assert ranks_agree(out)
    return out[0]


def _single_cfg(extra) -> BuildConfig:
    """The recipe at the ranks' batches: query_batch and search_batch / dp."""
    return BuildConfig(**dict(CFG, **extra,
                              query_batch=CFG["query_batch"] // DP,
                              search_batch=CFG["search_batch"] // DP))


@pytest.mark.parametrize("world", ["gauss", "dyadic"])
def test_sharded_prune_matches_local(ranks, worlds, world):
    w = worlds[world]
    base = prepare_vectors(w["base"], "ip", "cpu")
    want = _batched_prune_rows(base, w["tgt"], w["cand"], CFG["M_pjbp"],
                               "ip", 256 // DP, fill=True).numpy()
    np.testing.assert_array_equal(ranks[f"prune_{world}"]["pruned"], want)


def test_take_scatter_rows_sharded(ranks, worlds):
    w, got = worlds["rows"], ranks["take_scatter"]
    np.testing.assert_array_equal(got["taken"], w["arr"][w["ids"]])
    want = w["arr"].copy()
    want[w["ids"]] = w["rows"]
    np.testing.assert_array_equal(got["scattered"], want)


@pytest.mark.parametrize("world", ["gauss", "dyadic"])
@pytest.mark.parametrize("recipe", list(RECIPES))
def test_sharded_build_matches_single_device(ranks, worlds, recipe, world):
    w, got = worlds[world], ranks[f"build_{recipe}_{world}"]
    want = build_roargraph(w["base"], w["train"], w["knn"],
                           _single_cfg(RECIPES[recipe]), verbose=False,
                           device="cpu").graph
    assert got["ep"] == want.ep
    np.testing.assert_array_equal(got["neighbors"], want.neighbors)
    # the JAX package's sharded build on the virtual mesh
    jg = jbuild(jmake_mesh(dp=DP, mp=MP), w["base"], w["train"], w["knn"],
                JConfig(**dict(CFG, **RECIPES[recipe]))).graph
    assert got["ep"] == jg.ep
    if world == "dyadic":
        np.testing.assert_array_equal(got["neighbors"], jg.neighbors)
    else:
        assert (got["neighbors"] == jg.neighbors).mean() >= ID_AGREE


def test_sharded_build_rejects_fused_engine(ranks):
    err = ranks["build_errors"]
    assert "classic" in err["fused_engine"]
    assert "mp (4) must divide N (1023)" in err["n_not_divisible"]
