"""The world generator: drawn from the seed, its shapes and its norms."""

from __future__ import annotations

import torch

import _tiny  # noqa: F401  (puts the repository on sys.path)

from benchmark.harness.world import make_world, stream_seed

SPEC = dict(world_seed=7, n_base=500, n_train=60, n_pool=32, dim=200, metric="ip",
            n_concepts=40, intrinsic_dim=48, modality_gap=0.35, noise=0.85)
CPU = torch.device("cpu")


def test_same_seed_same_world():
    a = make_world(SPEC, 2**31 + 17, CPU)
    b = make_world(SPEC, 2**31 + 17, CPU)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_other_seed_other_rows():
    a = make_world(SPEC, 5, CPU)
    b = make_world(SPEC, 6, CPU)
    assert not torch.equal(a.base, b.base)
    assert not torch.equal(a.pool, b.pool)


def test_the_world_is_the_configurations():
    """The concepts and maps come from ``world_seed``: two seeds' rows
    sample one world (the same pool of concepts), another world_seed
    another."""
    small = {**SPEC, "n_concepts": 3, "noise": 0.0, "n_base": 50}
    a = make_world(small, 5, CPU).base
    b = make_world(small, 6, CPU).base
    c = make_world({**small, "world_seed": 8}, 6, CPU).base
    # with no noise every row is one of three points (up to the 0.02
    # ambient jitter): the same three for both seeds of one world
    def near(x, y):
        return (torch.cdist(x, y).amin(1) < 0.2).all()
    assert near(a, b) and near(b, a) and not near(c, a)


def test_shapes_and_unit_rows():
    w = make_world(SPEC, 3, CPU)
    assert w.base.shape == (500, 200) and w.base.dtype == torch.float32
    assert w.train.shape == (60, 200) and w.pool.shape == (32, 200)
    for x in w:
        assert torch.allclose(torch.linalg.vector_norm(x, dim=1),
                              torch.ones(x.shape[0]), atol=1e-5)
        assert x.is_contiguous()


def test_no_train_set():
    spec = {k: v for k, v in SPEC.items() if k != "n_train"}
    assert make_world(spec, 3, CPU).train.shape == (0, 200)


def test_parts_are_independent_streams():
    """The pool is held out: another stream than the train queries', and
    growing the train set changes neither the base nor the pool."""
    a = make_world(SPEC, 9, CPU)
    b = make_world({**SPEC, "n_train": 120}, 9, CPU)
    assert torch.equal(a.base, b.base) and torch.equal(a.pool, b.pool)
    assert not torch.equal(a.pool, a.train[:32])


def test_stream_seed_takes_any_whole_number():
    seeds = {stream_seed(s, p) for s in (0, 1, 2**40, 2**70)
             for p in ("base", "pool")}
    assert len(seeds) == 8
    assert all(0 <= s < 2**63 for s in seeds)


def test_chunked_draws_are_one_stream(monkeypatch):
    """Rows are drawn in blocks: a base longer than a block is its blocks
    in order, the first block the same as a base of one block."""
    from benchmark.harness import world
    monkeypatch.setattr(world, "CHUNK", 128)
    a = make_world(SPEC, 4, CPU)
    b = make_world({**SPEC, "n_base": 128}, 4, CPU)
    assert a.base.shape == (500, 200)
    assert torch.equal(a.base[:128], b.base)
    assert not torch.equal(a.base[128:256], b.base)
