"""Port ``ops.segment.segment_sum`` against ``jax.ops.segment_sum`` and
``index_add_`` on the same seeded inputs.

On dyadic data (integers / 64) every partial sum is exact in both packages,
so the sums compare bit for bit with JAX. On Gaussian data the port adds
each segment's rows in row order, which is ``index_add_``'s order on the
CPU, so the two compare bit for bit as well.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mysteryann_tpu_torch.ops.segment import segment_sum


def _seg(rng, n, num_segments):
    # the top segment stays empty: an empty segment sums to 0
    return rng.integers(0, num_segments - 1, n).astype(np.int32)


@pytest.mark.parametrize("shape", [(1000,), (1000, 24), (1000, 3, 8)])
def test_segment_sum_matches_jax_on_dyadic_data(shape):
    rng = np.random.default_rng(1)
    x = (rng.integers(-512, 512, shape) / 64).astype(np.float32)
    seg = _seg(rng, shape[0], 17)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(seg),
                                          num_segments=17))
    got = segment_sum(torch.from_numpy(x), torch.from_numpy(seg), 17)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[16].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_matches_index_add_in_row_order(dtype):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3000, 16))).to(dtype)
    seg = torch.from_numpy(_seg(rng, 3000, 40))
    want = x.new_zeros((40, 16)).index_add_(0, seg.to(torch.int64), x)
    got = segment_sum(x, seg, 40)
    assert torch.equal(got, want)


def test_segment_sum_leaves_the_deterministic_flag_alone():
    before = torch.are_deterministic_algorithms_enabled()
    segment_sum(torch.ones(10), torch.zeros(10, dtype=torch.int64), 3)
    assert torch.are_deterministic_algorithms_enabled() == before
