"""The build's bounded-memory paths and the rule that chooses them.

Each path — host reverse aggregation, the slab fold with its reverse-row
reconstruction, the host projection, the slabbed tail — must give the same
bits as the single-fold path and as the JAX package, on the inputs of
tests/test_roargraph_build.py and in whole builds on dyadic data (integers
/ 64: every distance exact in float32) with the engine pinned. The memory
rule's choices are held as a table.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mysteryann_tpu.graph import RoarGraphIndex as JIndex
from mysteryann_tpu.graph import build_roargraph as j_build
from mysteryann_tpu.graph import roargraph as jrg
from mysteryann_tpu.ops import exact_knn as j_knn
from mysteryann_tpu.utils.params import BuildConfig as JConfig
import mysteryann_tpu_torch as port
from mysteryann_tpu_torch.graph import roargraph as trg
from mysteryann_tpu_torch.ops.distances import Metric

GB16 = 16 * 2 ** 30      # a 16 GB device
GB80 = 85_000_000_000    # what an 80 GB H100 reports in total


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test processes run side by side (pytest-xdist); these tests run
    torch on one thread so its pool does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fold_inputs():
    """The inputs of tests/test_roargraph_build.py's slab-fold test."""
    rng = np.random.default_rng(77)
    n, W, M, c, r0 = 3000, 16, 8, 600, 1200
    supply = np.full((n, W), n, np.int32)
    for i in range(n):  # ragged existing lists
        deg = rng.integers(0, W)
        supply[i, :deg] = rng.choice(n, size=deg, replace=False)
    chunk = rng.integers(0, n + 40, (c, M)).astype(np.int32)  # some sentinels
    return n, W, M, r0, supply, chunk


@pytest.mark.parametrize("sn", [1000, 1024, 3000])
def test_slab_fold_matches_single_fold_and_jax(sn):
    n, W, M, r0, supply, chunk = _fold_inputs()
    j_supply, j_rev, j_fit = jrg._fold_round_device(
        jnp.asarray(supply), jnp.asarray(chunk), jnp.int32(r0))

    a_supply, a_rev, a_fit = trg._fold_round_device(
        _t(supply).clone(), _t(chunk), r0)
    np.testing.assert_array_equal(a_supply.numpy(), np.asarray(j_supply))
    np.testing.assert_array_equal(a_rev.numpy(), np.asarray(j_rev))
    np.testing.assert_array_equal(a_fit.numpy(), np.asarray(j_fit))

    b_supply = trg._fold_own_rows(_t(supply).clone(), _t(chunk), r0)
    fits = []
    for lo in range(0, n, sn):
        b_supply, fit_s = trg._fold_slab(b_supply, _t(chunk), r0, lo, sn)
        fits.append(fit_s)
    np.testing.assert_array_equal(b_supply.numpy(), a_supply.numpy())
    np.testing.assert_array_equal(torch.cat(fits).numpy(), a_fit.numpy())
    assert (~a_fit).sum() > 0, "no row overflowed: the case is too easy"


def test_rev_rows_for_ids_match_dense_rev_and_jax():
    n, W, M, r0, supply, chunk = _fold_inputs()
    _, a_rev, a_fit = trg._fold_round_device(_t(supply).clone(), _t(chunk),
                                             r0)
    ids = np.array([5, 77, 1200, 1201, 2999, n, n, n], np.int32)  # sorted
    got = trg._rev_rows_for_ids(_t(chunk), r0, _t(ids), n, W).numpy()
    want = np.asarray(jrg._rev_rows_for_ids(
        jnp.asarray(chunk), jnp.int32(r0), jnp.asarray(ids), n=n, W=W))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:5], a_rev.numpy()[ids[:5]])
    assert (got[5:] == n).all()
    over = torch.nonzero(~a_fit)[:, 0].to(torch.int32)
    np.testing.assert_array_equal(
        trg._rev_rows_for_ids(_t(chunk), r0, over, n, W).numpy(),
        a_rev.numpy()[over.numpy()])


@pytest.mark.parametrize("slab_rows", [1000, 1024])
def test_fold_and_overflow_slabbed_matches_single_and_jax(slab_rows):
    """The whole round fold, overflow prune and refill included."""
    n, W, M, r0, supply, chunk = _fold_inputs()
    rng = np.random.default_rng(78)
    base = (rng.integers(-64, 65, (n, 16)) / 64).astype(np.float32)
    want, _ = jrg._fold_and_overflow(
        jnp.asarray(base), jnp.asarray(supply), jnp.asarray(chunk), r0, n, M,
        jrg.Metric.IP, 256)
    single, fit = trg._fold_and_overflow(
        _t(base), _t(supply).clone(), _t(chunk), r0, n, M, Metric.IP, 256)
    slabbed, fit_s = trg._fold_and_overflow(
        _t(base), _t(supply).clone(), _t(chunk), r0, n, M, Metric.IP, 256,
        slab_rows=slab_rows)
    assert (~fit).sum() > 0
    np.testing.assert_array_equal(single.numpy(), np.asarray(want))
    np.testing.assert_array_equal(slabbed.numpy(), single.numpy())
    np.testing.assert_array_equal(fit_s.numpy(), fit.numpy())


def test_reverse_aggregation_host_device_and_jax_agree():
    """The inputs of tests/test_roargraph_build.py: sorted destinations,
    many exact distance ties."""
    rng = np.random.default_rng(11)
    n, E, r_max = 600, 5000, 6
    e_dst = np.sort(rng.integers(0, n, E))
    e_src = rng.integers(0, n, E)
    e_dist = rng.integers(0, 50, E).astype(np.float32)
    want = jrg._aggregate_reverse(e_src.astype(np.int64),
                                  e_dst.astype(np.int64), e_dist, n, r_max)
    host = trg._aggregate_reverse(e_src.astype(np.int64),
                                  e_dst.astype(np.int64), e_dist, n, r_max)
    dev = trg._aggregate_reverse_device(_t(e_src), _t(e_dst), _t(e_dist),
                                        n=n, r_max=r_max)
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(dev.numpy(), want)
    # unsorted arrival order too
    perm = rng.permutation(E)
    host_p = trg._aggregate_reverse(e_src[perm].astype(np.int64),
                                    e_dst[perm].astype(np.int64),
                                    e_dist[perm], n, r_max)
    dev_p = trg._aggregate_reverse_device(_t(e_src[perm]), _t(e_dst[perm]),
                                          _t(e_dist[perm]), n=n, r_max=r_max)
    np.testing.assert_array_equal(dev_p.numpy(), host_p)


# ---- whole builds ---------------------------------------------------------


def _dyadic(rng, shape):
    return (rng.integers(-64, 65, size=shape) / 64).astype(np.float32)


ENGINES = {"classic": dict(connectivity_engine="classic",
                           connectivity_passes=2),
           "fused4": dict(connectivity_engine="fused", connectivity_bits=4,
                          connectivity_expand=4, connectivity_passes=1)}


@pytest.fixture(scope="module")
def builds():
    """Per engine: the JAX build, the port's default build and the port's
    build with every bounded-memory path forced: `device_memory` is patched
    to report a device of one byte (the engine is pinned, so only the paths
    change)."""
    rng = np.random.default_rng(1)
    base, train = _dyadic(rng, (2500, 32)), _dyadic(rng, (800, 32))
    _, knn = j_knn(train, base, k=24, metric="ip", precision="highest")
    out = {}
    for name, eng in ENGINES.items():
        kw = dict(M_sq=24, M_pjbp=10, L_pjpq=48, metric="ip",
                  query_batch=512, search_batch=512, connectivity_iters=4,
                  **eng)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(trg, "device_memory", lambda device: 1)
            forced = port.build_roargraph(
                base, train, knn, port.BuildConfig(**kw), device="cpu",
                verbose=False)
        out[name] = dict(
            jax=j_build(base, train, knn, JConfig(**kw), verbose=False),
            default=port.build_roargraph(base, train, knn,
                                         port.BuildConfig(**kw),
                                         verbose=False, device="cpu"),
            forced=forced, cfg=port.BuildConfig(**kw), shape=base.shape)
    return out


@pytest.mark.parametrize("name", list(ENGINES))
def test_forced_large_paths_build_the_default_graph(builds, name):
    b = builds[name]
    plan = trg._build_memory_plan(b["cfg"], *b["shape"], 1)
    assert plan.large and plan.fold == "slab" and plan.slab_rows == 1024
    assert plan.engine == b["cfg"].connectivity_engine
    assert not trg._build_memory_plan(b["cfg"], *b["shape"]).large
    np.testing.assert_array_equal(b["forced"].graph.neighbors,
                                  b["default"].graph.neighbors)
    assert b["forced"].graph.ep == b["default"].graph.ep


@pytest.mark.parametrize("name", list(ENGINES))
def test_forced_large_paths_build_the_jax_graph(builds, name):
    b = builds[name]
    np.testing.assert_array_equal(b["forced"].graph.neighbors,
                                  b["jax"].graph.neighbors)
    st = b["forced"].graph.degree_stats()
    assert st["zero"] == 0 and st["max"] <= 20


def test_forced_large_index_and_jax_index_share_files(builds, tmp_path):
    """State carried across: the slab-path index saves the JAX index's
    bytes, and each package loads the other's file."""
    b = builds["classic"]
    t_path, j_path = str(tmp_path / "t.index"), str(tmp_path / "j.index")
    b["forced"].save(t_path)
    b["jax"].save(j_path)
    with open(t_path, "rb") as f, open(j_path, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(
        np.asarray(JIndex.load(t_path).graph.neighbors),
        b["jax"].graph.neighbors)
    np.testing.assert_array_equal(
        port.RoarGraphIndex.load(j_path).graph.neighbors,
        b["forced"].graph.neighbors)


@pytest.mark.parametrize("large", [False, True])
def test_connectivity_pass_host_projection_and_tail(large):
    """One pass, called directly: under ``large`` it takes a host
    projection, returns its result on the host, and the values are those
    of the device-resident pass."""
    rng = np.random.default_rng(6)
    n, M = 1500, 6
    base = _t(_dyadic(rng, (n, 16)))
    proj = np.full((n, M), n, np.int32)
    for i in range(n):
        d = rng.integers(1, M + 1)
        proj[i, :d] = rng.choice(n, size=d, replace=False)
    cfg = port.BuildConfig(M_sq=12, M_pjbp=M, L_pjpq=24, metric="ip",
                           search_batch=256, connectivity_iters=3,
                           connectivity_engine="classic")
    plan = trg._build_memory_plan(cfg, n, 16, 1 if large else 10 ** 12)
    assert plan.large == large
    quiet = lambda *a, **k: None
    got = trg._connectivity_pass(base, _t(proj), 0, cfg, Metric.IP, quiet,
                                 plan=plan)
    want = trg._connectivity_pass(base, _t(proj), 0, cfg, Metric.IP, quiet)
    assert got.device.type == "cpu" and got.shape == (n, M)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert ((got < n).sum(dim=1) > 0).all()


# ---- the memory rule ------------------------------------------------------

RULE = [
    # n, memory, engine, fold
    (1_000_000, GB16, "fused", "single"),
    (1_000_000, GB80, "fused", "single"),
    (4_000_000, GB16, "classic", "single"),
    (4_000_000, GB80, "fused", "single"),
    (10_000_000, GB16, "classic", "slab"),
    (10_000_000, GB80, "fused", "single"),
]


@pytest.mark.parametrize("n,mem,engine,fold", RULE)
def test_memory_rule_choices(n, mem, engine, fold):
    """"auto" at d = 128, M = 32, bits 4 (4,608-byte rows at the supply
    width 64)."""
    cfg = port.BuildConfig(M_pjbp=32, connectivity_bits=4)
    plan = trg._build_memory_plan(cfg, n, 128, mem)
    assert (plan.engine, plan.fold) == (engine, fold)
    assert plan.bytes["table"] == (n + 1) * 4608
    assert trg._resolve_engine(cfg, n, 128, mem) == engine
    assert trg._phase_d_knob_tag(cfg, n, 128, mem).startswith(engine)
    # the sum is the documented one
    b = plan.bytes
    want = b["base"] + 4 * b["supply"] + (
        b["table"] + b["table_snapshot"] if engine == "fused" else 0)
    assert b["resident_single"] == want
    assert plan.large == (want > int(0.8 * mem))


def test_memory_rule_pins_and_fallbacks():
    cfg4 = port.BuildConfig(M_pjbp=32, connectivity_bits=4)
    # a pinned engine is kept; only the fold path is planned
    for eng in ("classic", "fused"):
        c = port.BuildConfig(M_pjbp=32, connectivity_bits=4,
                             connectivity_engine=eng)
        assert trg._build_memory_plan(c, 10_000_000, 128, GB16).engine == eng
    assert trg._build_memory_plan(
        port.BuildConfig(M_pjbp=32, connectivity_bits=4,
                         connectivity_engine="fused"),
        10_000_000, 128, GB16).large
    # dims off the byte-row boundary: classic whatever the memory
    assert trg._build_memory_plan(cfg4, 1000, 24, GB80).engine == "classic"
    # the plan between single fold and nothing: fused on the slab paths
    n = 11_000_000
    p = trg._build_memory_plan(cfg4, n, 128, GB80)
    assert (p.engine, p.fold) == ("fused", "slab")
    assert p.bytes["resident_bounded"] <= p.bytes["budget"] \
        < p.bytes["resident_single"]
    # a CPU device (no memory given) keeps the JAX package's thresholds
    for n_, large in ((3_999_999, False), (4_000_000, True)):
        q = trg._build_memory_plan(cfg4, n_, 128)
        assert q.large == large and q.memory is None
        assert q.engine == jrg._resolve_engine(
            JConfig(M_pjbp=32, connectivity_bits=4), n_, 128)
    assert trg.device_memory(torch.device("cpu")) is None
