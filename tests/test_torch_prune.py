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


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("use_vecs", [True, False])
def test_prune_gather_hook(metric, use_vecs):
    """base=None with gather_fn + n_base (the sharded build's owner-masked
    fetch): the same prune as with the base, and the same as the JAX
    package's own hook."""
    base, src, cand, ns = _inputs(13)
    tb = torch.from_numpy(base)
    calls = []

    def fetch(ids):
        calls.append(ids.numel())
        return tb[ids.long()]

    tsv = tb[torch.from_numpy(src).long()]
    tcand, tns = torch.from_numpy(cand), torch.from_numpy(ns)
    want_d, want_v = tp.dists_to_src(tsv, tcand, tb, metric,
                                     return_vecs=True)
    got_d, got_v = tp.dists_to_src(tsv, tcand, None, metric,
                                   return_vecs=True, gather_fn=fetch,
                                   n_base=N)
    assert torch.equal(got_d, want_d) and torch.equal(got_v, want_v)
    kw = dict(cap=10, metric=metric, fill=True, not_seedable=tns,
              cand_vecs=want_v if use_vecs else None)
    want = tp.batched_occlusion_prune(tsv, torch.from_numpy(src), tcand,
                                      want_d, tb, **kw)
    got = tp.batched_occlusion_prune(tsv, torch.from_numpy(src), tcand,
                                     want_d, None, gather_fn=fetch,
                                     n_base=N, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert len(calls) == (1 if use_vecs else 2)

    jb = jnp.asarray(base)
    jsv = jb[jnp.asarray(src)]
    jd = jp.dists_to_src(jsv, jnp.asarray(cand), None, metric,
                         gather_fn=lambda ids: jb[ids], n_base=N)
    j_ids, _ = jp.batched_occlusion_prune(
        jsv, jnp.asarray(src), jnp.asarray(cand), jd, None, cap=10,
        metric=metric, fill=True, not_seedable=jnp.asarray(ns),
        gather_fn=lambda ids: jb[ids], n_base=N)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(j_ids))


def test_prune_without_base_needs_n_base():
    base, src, cand, _ = _inputs(14)
    tb = torch.from_numpy(base)
    tsv = tb[torch.from_numpy(src).long()]
    d = tp.dists_to_src(tsv, torch.from_numpy(cand), tb, "ip")
    with pytest.raises(ValueError, match="n_base"):
        tp.batched_occlusion_prune(tsv, torch.from_numpy(src),
                                   torch.from_numpy(cand), d, None, cap=10,
                                   gather_fn=lambda ids: tb[ids.long()])
