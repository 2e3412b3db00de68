"""Binary vector file formats (host copy of ``mysteryann_tpu/io/formats.py``:
the same byte layout and the same size checks).

Same on-disk layout as the reference so datasets prepared for it drop in:

- ``.fbin`` / ``.ibin``: ``[npts u32][dim u32][row-major payload]``
  (reference include/efanna2e/util.h:107-211, export_fbin_from_npy.py:28-41).
- ground-truth files: ``[npts u32][k u32][npts*k u32 ids][npts*k f32 dists]``
  (reference util.h:130-177 — ids then dists; size check at util.h:98).
- train→base exact-kNN input: plain ``.ibin`` of shape [npts, k]
  (reference src/index_bipartite.cpp:2622-2639, LoadLearnBaseKNN).

Every reader validates the header against the actual file size, mirroring the
reference's hard size checks (util.h:98-103, 120-125, 150-153, 205-207).
Readers memory-map by default: np.memmap keeps multi-GB datasets off the
Python heap.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

_HEADER = struct.Struct("<II")


def read_meta(path: str) -> Tuple[int, int]:
    """Return (npts, dim) from an fbin/ibin header, validating file size."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        npts, dim = _HEADER.unpack(f.read(8))
    expected = 8 + npts * dim * 4
    if size != expected:
        raise ValueError(
            f"{path}: header says ({npts},{dim}) -> {expected} bytes, file has {size}"
        )
    return npts, dim


def _read_bin(path: str, dtype, mmap: bool) -> np.ndarray:
    npts, dim = read_meta(path)
    if mmap:
        arr = np.memmap(path, dtype=dtype, mode="r", offset=8, shape=(npts, dim))
    else:
        with open(path, "rb") as f:
            f.seek(8)
            arr = np.fromfile(f, dtype=dtype, count=npts * dim).reshape(npts, dim)
    return arr


def read_fbin(path: str, mmap: bool = True) -> np.ndarray:
    return _read_bin(path, np.float32, mmap)


def read_ibin(path: str, mmap: bool = True) -> np.ndarray:
    return _read_bin(path, np.uint32, mmap)


def _write_bin(path: str, arr: np.ndarray, dtype) -> None:
    arr = np.ascontiguousarray(arr, dtype=dtype)
    if arr.ndim != 2:
        raise ValueError(f"expected 2-D array, got shape {arr.shape}")
    with open(path, "wb") as f:
        f.write(_HEADER.pack(arr.shape[0], arr.shape[1]))
        arr.tofile(f)


def write_fbin(path: str, arr: np.ndarray) -> None:
    _write_bin(path, arr, np.float32)


def write_ibin(path: str, arr: np.ndarray) -> None:
    _write_bin(path, arr, np.uint32)


# -- ground truth (ids + distances) -----------------------------------------


def read_gt_with_dist(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a GT file holding ids then dists (reference util.h:130-177)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        npts, k = _HEADER.unpack(f.read(8))
        expected = 8 + npts * k * 8
        if size != expected:
            raise ValueError(
                f"{path}: GT header ({npts},{k}) -> {expected} bytes, file has {size}"
            )
        ids = np.fromfile(f, dtype=np.uint32, count=npts * k).reshape(npts, k)
        dists = np.fromfile(f, dtype=np.float32, count=npts * k).reshape(npts, k)
    return ids, dists


def write_gt_with_dist(path: str, ids: np.ndarray, dists: np.ndarray) -> None:
    ids = np.ascontiguousarray(ids, dtype=np.uint32)
    dists = np.ascontiguousarray(dists, dtype=np.float32)
    if ids.shape != dists.shape or ids.ndim != 2:
        raise ValueError(f"ids/dists shape mismatch: {ids.shape} vs {dists.shape}")
    with open(path, "wb") as f:
        f.write(_HEADER.pack(ids.shape[0], ids.shape[1]))
        ids.tofile(f)
        dists.tofile(f)


# -- train->base kNN input ---------------------------------------------------


def read_knn_ibin(path: str, expected_k: int | None = None) -> np.ndarray:
    """Read the query→base exact kNN file the build consumes.

    Mirrors LoadLearnBaseKNN (reference src/index_bipartite.cpp:2622-2639),
    including its shape check against the requested truncation length.
    """
    knn = read_ibin(path, mmap=False)
    if expected_k is not None and knn.shape[1] < expected_k:
        raise ValueError(
            f"{path}: kNN file has k={knn.shape[1]} < required M_sq={expected_k}"
        )
    return knn


def write_knn_ibin(path: str, knn: np.ndarray) -> None:
    write_ibin(path, knn)


def data_align(x: np.ndarray, multiple: int = 128) -> np.ndarray:
    """Zero-pad the vector dimension to a hardware-friendly multiple.

    Counterpart of the reference's `data_align` (reference
    include/efanna2e/util.h:37-75), which pads dim to a multiple of 8
    floats for AVX loads; 128 suits the binned scan (``precision="scan"``
    needs d % 128 == 0). Zero padding is metric-safe for L2/IP/cosine
    (pads contribute 0 to every product/difference).
    """
    n, d = x.shape
    pad = (-d) % multiple
    if pad == 0:
        return np.ascontiguousarray(x, np.float32)
    out = np.zeros((n, d + pad), np.float32)
    out[:, :d] = x
    return out
