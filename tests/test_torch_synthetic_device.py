"""The port's index-keyed corpus against the JAX package's.

Each stage is pinned where it starts: threefry bits, the folded keys, the
uniform draws and the concept ids are the same bits as JAX's; the normals
are sqrt(2)·erfinv of the same uniforms, by the same polynomial, and agree
within NORMAL_ATOL (log1p and fused multiply-adds differ in the last ulps;
a draw reaches ~5, where an ulp is ~5e-7); unit-norm rows agree within
ROW_ATOL. Then the cases of
tests/test_synthetic_device.py, on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mysteryann_tpu.io.synthetic import CrossModalDeviceSpec as JSpec
from mysteryann_tpu_torch.io.synthetic import (CrossModalDeviceSpec, _bits,
                                               threefry2x32)

NORMAL_ATOL = 2e-6
ROW_ATOL = 1e-6

IDX = np.concatenate([np.arange(0, 300), [1023, 1024, 65535, 65536, 999_999,
                                          49_999_999, 2 ** 31 - 5]]
                     ).astype(np.int32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _jax_keys(seed, query_side, idx):
    root = jax.random.fold_in(jax.random.PRNGKey(seed),
                              1 if query_side else 0)
    return jax.vmap(lambda i: jax.random.fold_in(root, i))(jnp.asarray(idx))


@pytest.mark.parametrize("count", [1, 7, 64, 80])
def test_threefry_bits_match_jax(count):
    """Raw draws, odd and even counts: element j is out0 ^ out1 of
    threefry(key, (0, j)), jax's partitionable layout."""
    key = jax.random.PRNGKey(20260101)
    want = np.asarray(jax.random.bits(key, (count,), jnp.uint32))
    k = np.asarray(key).astype(np.int64)
    k0 = torch.tensor([k[0]]).to(torch.int32)
    k1 = torch.tensor([k[1] - (1 << 32) if k[1] >= 1 << 31 else k[1]]
                      ).to(torch.int32)
    np.testing.assert_array_equal(_u32(_bits(k0, k1, count))[0], want)


def test_threefry_block_matches_jax_primitive():
    from jax._src import prng
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint32)
    x = rng.integers(0, 2 ** 32, (2, 257), dtype=np.uint32)
    want = prng.threefry2x32_p.bind(jnp.uint32(k[0]), jnp.uint32(k[1]),
                                    jnp.asarray(x[0]), jnp.asarray(x[1]))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    got = threefry2x32(int(k[0]), int(k[1]), t(x[0]), t(x[1]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u32(g), np.asarray(w))


@pytest.mark.parametrize("query_side", [False, True], ids=["base", "query"])
@pytest.mark.parametrize("seed", [11, 23])
def test_draws_match_jax_stage_by_stage(seed, query_side):
    t = CrossModalDeviceSpec(64, n_concepts=500, intrinsic_dim=24,
                             noise=0.85, seed=seed, device="cpu")
    j = JSpec(64, n_concepts=500, intrinsic_dim=24, noise=0.85, seed=seed)
    keys = _jax_keys(seed, query_side, IDX)
    k0, k1 = t._keys(t._idx(IDX), query_side)
    np.testing.assert_array_equal(
        np.stack([_u32(k0), _u32(k1)], axis=1), np.asarray(keys))
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(keys))
    np.testing.assert_array_equal(t.uniforms(IDX, query_side).numpy(), u)
    cid = np.minimum(np.asarray(jnp.searchsorted(j.pop_cdf, jnp.asarray(u))),
                     499).astype(np.int32)
    np.testing.assert_array_equal(t.concept_ids(IDX, query_side).numpy(), cid)
    assert len(np.unique(cid)) > 50
    eps = np.asarray(jax.vmap(lambda k: jax.random.normal(
        jax.random.fold_in(k, 1), (24 + 64,), jnp.float32))(keys))
    np.testing.assert_allclose(t.normals(IDX, query_side).numpy(), eps,
                               rtol=0, atol=NORMAL_ATOL)
    np.testing.assert_allclose(
        t.rows(IDX, query_side).numpy(),
        np.asarray(j.rows(jnp.asarray(IDX), query_side)),
        rtol=0, atol=ROW_ATOL)


@pytest.mark.parametrize("name", ["concepts", "a_map", "b_map", "gap_dir",
                                  "pop_cdf"])
def test_constants_are_the_jax_objects(name):
    kw = dict(n_concepts=300, intrinsic_dim=12, modality_gap=0.4, seed=5)
    t = CrossModalDeviceSpec(48, device="cpu", **kw)
    np.testing.assert_array_equal(getattr(t, name).numpy(),
                                  np.asarray(getattr(JSpec(48, **kw), name)))


def test_l2_world_and_tiles_match_jax():
    """An unnormalized (l2) world, tiles and queries through the public
    calls."""
    t = CrossModalDeviceSpec(32, metric="l2", seed=3, device="cpu")
    j = JSpec(32, metric="l2", seed=3)
    np.testing.assert_allclose(t.base_tile(1000, 48).numpy(),
                               np.asarray(j.base_tile(1000, 48)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.queries(40).numpy(),
                               np.asarray(j.queries(40)), rtol=0, atol=1e-5)


# ---- the cases of tests/test_synthetic_device.py, on the port -------------


@pytest.fixture(scope="module")
def spec():
    return CrossModalDeviceSpec(dim=64, seed=11, device="cpu")


def test_random_access_matches_tiles(spec):
    tile = spec.base_tile(0, 2048).numpy()
    np.testing.assert_array_equal(tile, spec.base_tile(0, 2048).numpy())
    ids = np.asarray([7, 7, 2047, 0, 1024, 3], np.int32)
    np.testing.assert_allclose(spec.rows(ids).numpy(), tile[ids],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(spec.concept_ids(ids).numpy(),
                                  spec.concept_ids(np.arange(2048)).numpy()[ids])
    mid = spec.base_tile(1000, 48).numpy()
    np.testing.assert_allclose(mid, tile[1000:1048], rtol=0, atol=1e-6)


def test_blocked_generation_matches_one_block(spec, monkeypatch):
    """A call longer than BLOCK rows is cut into blocks; same rows."""
    whole = spec.base_tile(5, 700).numpy()
    monkeypatch.setattr(CrossModalDeviceSpec, "BLOCK", 256)
    np.testing.assert_allclose(spec.base_tile(5, 700).numpy(), whole,
                               rtol=0, atol=1e-6)


def test_streams_are_disjoint(spec):
    b = spec.rows(np.arange(16)).numpy()
    q = spec.rows(np.arange(16), query_side=True).numpy()
    assert not np.allclose(b, q)


def test_distribution_shape(spec):
    base = spec.base_tile(0, 4096).numpy()
    queries = spec.queries(256).numpy()
    np.testing.assert_allclose(np.linalg.norm(base, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(queries, axis=1), 1.0,
                               atol=1e-5)
    top = np.argsort(-(queries @ base.T), axis=1)[:, :10]
    distinct = len(np.unique(top))
    assert 50 < distinct < 2000, distinct


def test_seed_changes_corpus():
    a = CrossModalDeviceSpec(dim=32, seed=1, device="cpu").base_tile(0, 8)
    b = CrossModalDeviceSpec(dim=32, seed=2, device="cpu").base_tile(0, 8)
    assert not np.allclose(a.numpy(), b.numpy())


def test_default_device_is_the_card():
    """Without a card and without device="cpu" the spec raises, like
    every entry point of the port."""
    if torch.cuda.is_available():
        assert CrossModalDeviceSpec(16).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            CrossModalDeviceSpec(16)
