"""Port data pipeline — ``io/stream.py`` and ``io/datasets.py`` — against
the JAX package's on the same files and arrays. ``prepare`` is tested only
with the download mocked: nothing here fetches anything.

The machine with the card has no jax, so this file imports the JAX package
only inside the tests that use it; there the ``cuda`` test runs with

    python -m pytest --noconftest -m cuda tests/test_torch_stream.py
"""

import io
import os
import urllib.request

import numpy as np
import pytest
import torch

from mysteryann_tpu_torch import native
from mysteryann_tpu_torch.io import datasets as tds
from mysteryann_tpu_torch.io import read_fbin, write_fbin
from mysteryann_tpu_torch.io import stream as tstream


@pytest.fixture
def jds():
    pytest.importorskip("jax")
    from mysteryann_tpu.io import datasets
    return datasets


@pytest.fixture
def jstream():
    pytest.importorskip("jax")
    from mysteryann_tpu.io import stream
    return stream


def _chunks(gen):
    rows, parts = [], []
    for row, chunk in gen:
        rows.append(row)
        parts.append(chunk)
    return rows, np.concatenate(parts)


@pytest.mark.parametrize("n,chunk", [(1000, 130), (512, 128), (5, 64)])
def test_stream_native_python_and_jax_agree(tmp_path, monkeypatch, n,
                                            chunk, jstream):
    a = np.random.default_rng(n).normal(size=(n, 24)).astype(np.float32)
    p = str(tmp_path / "a.fbin")
    write_fbin(p, a)
    want_rows, want = _chunks(jstream.stream_fbin(p, chunk_rows=chunk))
    before = native.calls["native"]
    rows, got = _chunks(tstream.stream_fbin(p, chunk_rows=chunk))
    assert native.calls["native"] == before + 1
    assert rows == want_rows == list(range(0, n, chunk))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, a)
    monkeypatch.setattr(native, "lib", lambda: None)
    rows, got = _chunks(tstream.stream_fbin(p, chunk_rows=chunk))
    assert rows == want_rows
    np.testing.assert_array_equal(got, a)


def test_stream_ibin_dtype(tmp_path):
    ids = np.arange(300 * 6, dtype=np.uint32).reshape(300, 6)
    p = str(tmp_path / "i.ibin")
    from mysteryann_tpu_torch.io import write_ibin
    write_ibin(p, ids)
    _, got = _chunks(tstream.stream_fbin(p, chunk_rows=64, dtype=np.uint32))
    np.testing.assert_array_equal(got, ids)


@pytest.mark.parametrize("use_native", [True, False])
def test_stream_rejects_trailing_bytes(tmp_path, monkeypatch, use_native):
    p = str(tmp_path / "bad.fbin")
    write_fbin(p, np.zeros((50, 8), np.float32))
    with open(p, "ab") as f:
        f.write(b"\x00" * 12)
    if not use_native:
        monkeypatch.setattr(native, "lib", lambda: None)
    with pytest.raises(ValueError, match="bytes"):
        list(tstream.stream_fbin(p, chunk_rows=16))


def test_load_fbin_to_device_cpu(tmp_path, jstream):
    a = np.random.default_rng(1).normal(size=(300, 16)).astype(np.float32)
    p = str(tmp_path / "c.fbin")
    write_fbin(p, a)
    buf = tstream.load_fbin_to_device(p, chunk_rows=77, device="cpu")
    assert buf.dtype == torch.float32 and buf.device.type == "cpu"
    np.testing.assert_array_equal(buf.numpy(), a)
    np.testing.assert_array_equal(
        buf.numpy(), np.asarray(jstream.load_fbin_to_device(p, 77)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned staging path runs only "
                    "on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_load_fbin_to_device_card(tmp_path, cuda_device):
    a = np.random.default_rng(2).normal(size=(3000, 32)).astype(np.float32)
    p = str(tmp_path / "d.fbin")
    write_fbin(p, a)
    buf = tstream.load_fbin_to_device(p, chunk_rows=257, device=cuda_device)
    np.testing.assert_array_equal(buf.cpu().numpy(), a)


def test_registry_equal_to_jax(jds):
    assert set(tds.REGISTRY) == set(jds.REGISTRY)
    for name, spec in tds.REGISTRY.items():
        j = jds.REGISTRY[name]
        for field in ("name", "dim", "metric", "base_file",
                      "train_query_file", "eval_query_file", "gt_file",
                      "n_base", "notes"):
            assert getattr(spec, field) == getattr(j, field), (name, field)
        assert [(r.url, r.filename, r.byte_range()) for r in spec.remotes] \
            == [(r.url, r.filename, r.byte_range()) for r in j.remotes]
    assert tds.LAION_SHARDS == jds.LAION_SHARDS


@pytest.mark.parametrize("normalize", [False, True])
def test_export_fbin_matches(tmp_path, normalize, jds):
    rng = np.random.default_rng(0)
    shards = []
    for i, n in enumerate((100, 37, 263)):
        p = str(tmp_path / f"s{i}.npy")
        np.save(p, rng.normal(size=(n, 24)) * 5)       # f64 on purpose
        shards.append(p)
    tout, jout = str(tmp_path / "t.fbin"), str(tmp_path / "j.fbin")
    assert tds.export_fbin_from_npy(shards, tout, normalize=normalize,
                                    chunk_rows=50) == (400, 24)
    jds.export_fbin_from_npy(shards, jout, normalize=normalize,
                             chunk_rows=50)
    with open(tout, "rb") as a, open(jout, "rb") as b:
        assert a.read() == b.read()
    np.save(str(tmp_path / "bad.npy"), np.zeros((4, 9), np.float32))
    with pytest.raises(ValueError):
        tds.export_fbin_from_npy([shards[0], str(tmp_path / "bad.npy")],
                                 str(tmp_path / "o.fbin"))


def test_pool_frame_embeddings_match(jds):
    rng = np.random.default_rng(2)
    frames = rng.normal(size=(12, 32)).astype(np.float32) * 3
    np.testing.assert_array_equal(tds.pool_frame_embeddings(frames),
                                  jds.pool_frame_embeddings(frames))
    counts = np.array([3, 7, 1, 12])
    frames = rng.normal(size=(counts.sum(), 16)).astype(np.float32)
    got = tds.pool_frame_embeddings_batch(frames, counts, device="cpu")
    # f32 sums in another order: within a few ulps of the JAX package
    np.testing.assert_allclose(
        got, jds.pool_frame_embeddings_batch(frames, counts),
        rtol=2e-6, atol=2e-7)
    off = 0
    for i, c in enumerate(counts):
        np.testing.assert_allclose(
            got[i], tds.pool_frame_embeddings(frames[off:off + c]),
            rtol=2e-5, atol=2e-6)
        off += c


class _FakeResponse(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def test_prepare_with_mocked_download(tmp_path, monkeypatch):
    """Every remote 'downloads' from a fake urlopen: the T2I byte-range
    files are cut to their head rows with the header rewritten, and the
    staged dataset validates."""
    spec = tds.REGISTRY["t2i-10M"]
    small = {r.filename: 5 for r in spec.remotes}
    seen = []

    def fake_urlopen(req):
        seen.append((req.full_url, req.get_header("Range")))
        name = next(r.filename for r in spec.remotes
                    if r.url == req.full_url)
        if name.startswith("gt"):
            body = (np.array([5, 2], np.uint32).tobytes()
                    + np.zeros(10, np.uint32).tobytes()
                    + np.zeros(10, np.float32).tobytes())
        else:
            n = small[name] + 3           # longer than the byte range
            body = (np.array([n, spec.dim], np.uint32).tobytes()
                    + np.ones((n, spec.dim), np.float32).tobytes())
        return _FakeResponse(body)

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    # shrink the byte ranges so the fake files can satisfy them
    remotes = tuple(
        tds.RemoteFile(r.url, r.filename,
                       head_points=small[r.filename] if r.head_points
                       else None, dim=r.dim) for r in spec.remotes)
    monkeypatch.setitem(tds.REGISTRY, "t2i-10M",
                        tds.DatasetSpec(**{**spec.__dict__,
                                           "remotes": remotes}))
    got = tds.prepare("t2i-10M", str(tmp_path), verbose=False)
    assert got.name == "t2i-10M" and len(seen) == len(spec.remotes)
    ranged = [rng for _, rng in seen if rng]
    assert ranged == [f"bytes=0-{8 + 4 * spec.dim * 5}"] * 2
    ddir = tmp_path / "t2i-10M"
    assert read_fbin(str(ddir / "query.train.10M.fbin")).shape == (5, 200)
    assert read_fbin(str(ddir / "base.10M.fbin")).shape == (8, 200)
    # idempotent: everything exists, nothing is fetched again
    seen.clear()
    tds.prepare("t2i-10M", str(tmp_path), verbose=False)
    assert seen == []


def test_prepare_airgapped_raises_and_unknown(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise OSError("no egress")

    monkeypatch.setattr(urllib.request, "urlopen", boom)
    with pytest.raises(RuntimeError, match="stage these files"):
        tds.prepare("t2i-10M", str(tmp_path))
    with pytest.raises(ValueError):
        tds.prepare("nope")
    assert os.path.isdir(tmp_path / "t2i-10M")
