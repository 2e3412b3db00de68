"""Port occlusion prune against the JAX package, bit for bit.

Dyadic vectors (small integers / 8) keep every distance exact in float32,
so both packages see the same distances — and many ties, which exercise the
(distance, id) sort, the dedup and the seed rules.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mysteryann_tpu.graph import prune as jp
from mysteryann_tpu_torch.graph import prune as tp

N, D, B, C = 300, 16, 40, 48


def _inputs(seed):
    rng = np.random.default_rng(seed)
    base = (rng.integers(-4, 5, size=(N, D)) / 8).astype(np.float32)
    src = rng.integers(0, N, size=B).astype(np.int32)
    cand = rng.integers(0, N, size=(B, C)).astype(np.int32)
    cand[:, :3] = cand[:, 3:6]                  # duplicates
    cand[:, 6] = src                            # the source itself
    cand[rng.random((B, C)) < 0.15] = N         # sentinel slots
    cand[0, 7] = -1                             # a negative id
    not_seedable = rng.random((B, C)) < 0.3
    return base, src, cand, not_seedable


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("fill,seedable,two_pass,use_vecs", [
    (True, False, False, True),
    (False, False, False, False),
    (False, True, False, True),
    (False, True, True, True),
    (True, True, True, False),
])
def test_prune_bit_identical(metric, fill, seedable, two_pass, use_vecs):
    base, src, cand, ns = _inputs(11)
    cap = 10
    jb = jnp.asarray(base)
    jsv = jb[jnp.asarray(src)]
    jcd, jcv = jp.dists_to_src(jsv, jnp.asarray(cand), jb, metric,
                               return_vecs=True)
    j_ids, j_cnt = jp.batched_occlusion_prune(
        jsv, jnp.asarray(src), jnp.asarray(cand), jcd, jb, cap=cap,
        metric=metric, fill=fill,
        not_seedable=jnp.asarray(ns) if seedable else None,
        two_pass=two_pass, cand_vecs=jcv if use_vecs else None)

    tb = torch.from_numpy(base)
    tsv = tb[torch.from_numpy(src).long()]
    tcd, tcv = tp.dists_to_src(tsv, torch.from_numpy(cand), tb, metric,
                               return_vecs=True)
    np.testing.assert_array_equal(tcd.numpy(), np.asarray(jcd))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(jcv))
    t_ids, t_cnt = tp.batched_occlusion_prune(
        tsv, torch.from_numpy(src), torch.from_numpy(cand), tcd, tb,
        cap=cap, metric=metric, fill=fill,
        not_seedable=torch.from_numpy(ns) if seedable else None,
        two_pass=two_pass, cand_vecs=tcv if use_vecs else None)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_dists_to_src_without_vecs(metric):
    base, src, cand, _ = _inputs(12)
    want = jp.dists_to_src(jnp.asarray(base)[jnp.asarray(src)],
                           jnp.asarray(cand), jnp.asarray(base), metric)
    got = tp.dists_to_src(torch.from_numpy(base)[torch.from_numpy(src).long()],
                          torch.from_numpy(cand), torch.from_numpy(base),
                          metric)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
