"""The port's host result cache against the JAX package's."""

import numpy as np

from mysteryann_tpu.utils.cache import npz_cached as j_cached
from mysteryann_tpu_torch.utils.cache import npz_cached


def _arrays():
    rng = np.random.default_rng(4)
    return [rng.standard_normal((5, 3)).astype(np.float32),
            rng.integers(0, 9, (7,)).astype(np.int32)]


def test_npz_cached_round_trip(tmp_path):
    calls = []

    def fn():
        calls.append(1)
        return _arrays()

    first = npz_cached(str(tmp_path / "c"), "world", fn)
    again = npz_cached(str(tmp_path / "c"), "world", fn)
    assert len(calls) == 1, "the second call must load, not recompute"
    for a, b, want in zip(first, again, _arrays()):
        np.testing.assert_array_equal(a, want)
        np.testing.assert_array_equal(b, want)
        assert a.dtype == b.dtype == want.dtype
    assert [p.name for p in (tmp_path / "c").iterdir()] == ["world.npz"]


def test_npz_cached_files_are_shared_with_the_jax_package(tmp_path):
    """Either package loads what the other cached (same file layout)."""
    def never():
        raise AssertionError("must load from the cache")

    npz_cached(str(tmp_path), "a", _arrays)
    j_cached(str(tmp_path), "b", _arrays)
    for got in (j_cached(str(tmp_path), "a", never),
                npz_cached(str(tmp_path), "b", never)):
        for g, want in zip(got, _arrays()):
            np.testing.assert_array_equal(g, want)
    # (the bytes are not compared: a zip member carries its write time)
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        assert a.files == b.files == ["arr_0", "arr_1"]
