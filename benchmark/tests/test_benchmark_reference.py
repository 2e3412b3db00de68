"""The plain reference: exact top-k, float64 distances, TF32 rounding, and
its imports."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from _tiny import REPO

from benchmark.harness.checks import compute_recall
from benchmark.reference.exact_topk import distances_f64, exact_topk, tf32

REF_DIR = os.path.join(REPO, "benchmark", "reference")


def _data(n=3000, q=70, d=200, seed=0):
    g = torch.Generator().manual_seed(seed)
    base = torch.randn(n, d, generator=g)
    base = base / torch.linalg.vector_norm(base, dim=1, keepdim=True)
    qs = torch.randn(q, d, generator=g)
    return qs / torch.linalg.vector_norm(qs, dim=1, keepdim=True), base


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_exact_topk_matches_numpy_brute_force(metric):
    q, base = _data()
    ids, d = exact_topk(q, base, 10, metric, q_block=32, tile=700)
    qn, bn = q.double().numpy(), base.double().numpy()
    if metric == "ip":
        full = -(qn @ bn.T)
    else:
        full = ((qn[:, None, :] - bn[None, :, :]) ** 2).sum(-1)
    want = np.argsort(full, axis=1, kind="stable")[:, :10]
    assert compute_recall(ids.numpy(), want, 10) == 1.0
    np.testing.assert_allclose(
        d.numpy(), np.take_along_axis(full, want, 1), atol=1e-5)
    assert bool((d[:, 1:] >= d[:, :-1]).all())


def test_distances_f64():
    q, base = _data(n=50, q=4)
    ids = torch.tensor([[3, 7], [0, 49], [5, 5], [1, 2]])
    got = distances_f64(q, base, ids, "ip")
    want = -np.einsum("bd,bkd->bk", q.double().numpy(),
                      base.double().numpy()[ids.numpy()])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)
    got = distances_f64(q, base, ids, "l2")
    want = ((q.double().numpy()[:, None, :]
             - base.double().numpy()[ids.numpy()]) ** 2).sum(-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)


def test_tf32_keeps_ten_significand_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12,
                      -(1.0 + 2**-11), 3.0e-3, -7.5])
    got = tf32(x)
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0,
                         -(1.0 + 2**-10)])
    assert torch.equal(got[:5], want)
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    assert float((got[5] - x[5]).abs() / x[5]) <= 2**-11
    assert got[6] == -7.5


def _imports(path: str):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_port_or_jax():
    files = [f for f in os.listdir(REF_DIR) if f.endswith(".py")]
    assert "exact_topk.py" in files and "tf32_control.py" in files
    for f in files:
        for mod in _imports(os.path.join(REF_DIR, f)):
            top = mod.split(".")[0]
            assert top not in ("mysteryann_tpu_torch", "mysteryann_tpu",
                               "jax", "jaxlib", "flax"), (f, mod)
            if top == "benchmark":
                assert mod.startswith("benchmark.reference"), (f, mod)


def test_only_the_engine_adapters_import_the_port():
    bench = os.path.join(REPO, "benchmark")
    for base, _, files in os.walk(bench):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(base, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & {"mysteryann_tpu", "jax", "jaxlib", "flax"}, path
            if "mysteryann_tpu_torch" in tops:
                rel = os.path.relpath(path, bench)
                assert rel.startswith("engines" + os.sep) or \
                    rel.startswith("tests" + os.sep), rel
