"""Port native persistence against the JAX package's graph files.

The port builds its own copy of the host library (``native``) with g++ into
its ``build/`` directory. Projection and bipartite files written through
the native path, through the numpy plain version and by the JAX package
must be byte for byte the same, and each loader must give back the
adjacency (and reject trailing bytes) on both paths.
"""

import ctypes
import os
import struct

import numpy as np
import pytest

from mysteryann_tpu.graph import bipartite as jbip
from mysteryann_tpu.graph import roargraph as jrg
from mysteryann_tpu.graph.adjacency import PaddedGraph as JGraph
from mysteryann_tpu_torch import native
from mysteryann_tpu_torch.graph import bipartite as tbip
from mysteryann_tpu_torch.graph import roargraph as trg
from mysteryann_tpu_torch.graph.adjacency import PaddedGraph
from mysteryann_tpu_torch.io import write_fbin
from mysteryann_tpu_torch.ops.distances import Metric


@pytest.fixture(scope="module")
def lib():
    L = native.lib()
    if L is None:
        pytest.skip(f"no native toolchain: {native.status()['error']}")
    return L


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _random_adjacency(rng, n=500, m=9, sentinel=None):
    sentinel = n if sentinel is None else sentinel
    nb = np.full((n, m), sentinel, np.int32)
    for i in range(n):
        deg = rng.integers(0, m + 1)
        nb[i, :deg] = rng.choice(n, size=deg, replace=False)
    return nb


def test_library_built_into_the_port(lib):
    st = native.status()
    assert st["loaded"] and st["error"] is None
    assert os.path.dirname(st["library"]) == os.path.join(
        os.path.dirname(os.path.dirname(native.__file__)), "build")
    assert os.path.basename(st["library"]).endswith(".so")


@pytest.mark.parametrize("m", [1, 5, 9])
def test_projection_files_byte_identical(lib, tmp_path, m):
    rng = np.random.default_rng(m)
    nb = _random_adjacency(rng, m=m)
    g = PaddedGraph(neighbors=nb, ep=7)
    before = dict(native.calls)
    trg.save_projection_graph(str(tmp_path / "native.idx"), g)
    trg.save_projection_graph_ref(str(tmp_path / "py.idx"), g)
    assert native.calls["native"] == before["native"] + 1
    assert native.calls["python"] == before["python"] + 1
    jrg.save_projection_graph(str(tmp_path / "jax.idx"),
                              JGraph(neighbors=nb, ep=7))
    want = _bytes(tmp_path / "jax.idx")
    assert _bytes(tmp_path / "native.idx") == want
    assert _bytes(tmp_path / "py.idx") == want
    for load in (trg.load_projection_graph, trg.load_projection_graph_ref):
        got = load(str(tmp_path / "jax.idx"))
        assert got.ep == 7
        j = jrg.load_projection_graph(str(tmp_path / "jax.idx"))
        np.testing.assert_array_equal(got.neighbors, j.neighbors)
        # a narrower m_pad truncates rows, as the JAX loaders do
        np.testing.assert_array_equal(
            load(str(tmp_path / "jax.idx"), m_pad=3).neighbors,
            jrg.load_projection_graph(str(tmp_path / "jax.idx"),
                                      m_pad=3).neighbors)


def test_bipartite_files_byte_identical(lib, tmp_path):
    rng = np.random.default_rng(4)
    nb = _random_adjacency(rng, n=700, m=12)
    idx_t = tbip.BipartiteIndex(neighbors=nb, n_base=300, metric=Metric.IP,
                                dim=8)
    idx_j = jbip.BipartiteIndex(neighbors=nb, n_base=300,
                                metric=jbip.Metric.IP, dim=8)
    idx_t.save(str(tmp_path / "native.bip"))
    tbip.save_bipartite_graph_ref(str(tmp_path / "py.bip"), nb)
    idx_j.save(str(tmp_path / "jax.bip"))
    want = _bytes(tmp_path / "jax.bip")
    assert _bytes(tmp_path / "native.bip") == want
    assert _bytes(tmp_path / "py.bip") == want
    assert _bytes(tmp_path / "native.bip.meta.json") == \
        _bytes(tmp_path / "jax.bip.meta.json")
    j = jbip.BipartiteIndex.load(str(tmp_path / "jax.bip"))
    for load in (tbip.load_bipartite_graph, tbip.load_bipartite_graph_ref):
        np.testing.assert_array_equal(load(str(tmp_path / "jax.bip")),
                                      j.neighbors)
    t = tbip.BipartiteIndex.load(str(tmp_path / "jax.bip"))
    assert (t.n_base, t.metric, t.dim) == (300, Metric.IP, 8)
    # explicit arguments win over the sidecar
    t = tbip.BipartiteIndex.load(str(tmp_path / "jax.bip"), n_base=200,
                                 metric="l2", dim=9)
    assert (t.n_base, t.metric, t.dim) == (200, Metric.L2, 9)


@pytest.mark.parametrize("kind", ["projection", "bipartite"])
def test_trailing_bytes_rejected_on_both_paths(lib, tmp_path, kind):
    rng = np.random.default_rng(5)
    nb = _random_adjacency(rng, n=50, m=4)
    p = str(tmp_path / "bad.idx")
    if kind == "projection":
        trg.save_projection_graph(p, PaddedGraph(neighbors=nb, ep=0))
        loads = (trg.load_projection_graph, trg.load_projection_graph_ref)
    else:
        tbip.save_bipartite_graph(p, nb)
        loads = (tbip.load_bipartite_graph, tbip.load_bipartite_graph_ref)
    with open(p, "ab") as f:
        f.write(b"\x00\x00\x00\x00")
    for load in loads:
        with pytest.raises(ValueError, match="trailing"):
            load(p)


def test_python_path_without_the_library(tmp_path, monkeypatch):
    """With no library the callers take the plain version (the JAX
    package's contract: ``lib()`` returns None without a toolchain)."""
    rng = np.random.default_rng(6)
    g = PaddedGraph(neighbors=_random_adjacency(rng, n=80, m=6), ep=3)
    monkeypatch.setattr(native, "lib", lambda: None)
    before = native.calls["python"]
    trg.save_projection_graph(str(tmp_path / "g.idx"), g)
    got = trg.load_projection_graph(str(tmp_path / "g.idx"))
    assert native.calls["python"] == before + 2
    np.testing.assert_array_equal(got.neighbors, g.neighbors)


@pytest.mark.parametrize("n_nodes", [0, 40])
def test_load_nsg_graph_matches(tmp_path, n_nodes):
    rng = np.random.default_rng(7)
    lists = [rng.choice(40, size=rng.integers(0, 7), replace=False)
             for _ in range(40)]
    p = str(tmp_path / "g.nsg")
    with open(p, "wb") as f:
        f.write(struct.pack("<II", 6, 11))
        for row in lists:
            f.write(struct.pack("<I", len(row)))
            row.astype(np.uint32).tofile(f)
    for m_pad in (None, 3):
        j = jrg.load_nsg_graph(p, n_nodes=n_nodes, m_pad=m_pad)
        t = trg.load_nsg_graph(p, n_nodes=n_nodes, m_pad=m_pad)
        assert t.ep == j.ep == 11
        np.testing.assert_array_equal(t.neighbors, j.neighbors)
    with pytest.raises(ValueError, match="expected 41"):
        trg.load_nsg_graph(p, n_nodes=41)


def test_read_header(lib, tmp_path):
    x = np.zeros((12, 7), np.float32)
    p = str(tmp_path / "x.fbin")
    write_fbin(p, x)
    n, d = ctypes.c_uint32(), ctypes.c_uint32()
    assert lib.msann_read_header(p.encode(), ctypes.byref(n),
                                 ctypes.byref(d)) == 0
    assert (n.value, d.value) == (12, 7)
