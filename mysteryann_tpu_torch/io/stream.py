"""Streaming fbin reader — port of ``mysteryann_tpu/io/stream.py``.

The reference loads whole corpora into RAM up front (reference
include/efanna2e/util.h:180-211). At 10M-100M scale the right shape is a
pipeline: a C++ reader thread (``native``, ``msann_stream_*``) prefetches
the next disk chunk while the current one is staged to the device. The
Python path (sequential reads) runs when the native library is
unavailable; both validate the header against the file size.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Tuple

import numpy as np
import torch

from mysteryann_tpu_torch import native
from mysteryann_tpu_torch.io.formats import read_meta
from mysteryann_tpu_torch.ops.distances import array_device


def stream_fbin(path: str, chunk_rows: int = 262144,
                dtype=np.float32) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (start_row, chunk [rows<=chunk_rows, d]) over an fbin/ibin
    file. Disk IO for chunk i+1 overlaps consumption of chunk i."""
    elt = np.dtype(dtype).itemsize
    if elt == 4:
        # header-vs-file-size validation runs on BOTH paths (the native
        # opener only reads the 8-byte header)
        read_meta(path)
    L = native.lib()
    if L is None:
        native.note("python")
        n, d = read_meta(path)
        with open(path, "rb") as f:
            f.seek(8)
            row = 0
            while row < n:
                rows = min(chunk_rows, n - row)
                buf = np.fromfile(f, dtype=dtype, count=rows * d)
                yield row, buf.reshape(rows, d)
                row += rows
        return

    h = L.msann_stream_open(path.encode(), chunk_rows, elt)
    if not h:
        raise OSError(f"cannot open {path}")
    native.note("native")
    try:
        n32, d32 = ctypes.c_uint32(), ctypes.c_uint32()
        L.msann_stream_meta(h, ctypes.byref(n32), ctypes.byref(d32))
        n, d = n32.value, d32.value
        out = np.empty((chunk_rows, d), dtype)
        row = 0
        while True:
            got = L.msann_stream_next(h, out.ctypes.data_as(ctypes.c_void_p))
            if got < 0:
                raise OSError(f"short read in {path} at row {row}")
            if got == 0:
                break
            yield row, out[:got].copy()
            row += got
        if row != n:
            raise OSError(f"{path}: read {row} rows, header says {n}")
    finally:
        L.msann_stream_close(h)


def load_fbin_to_device(path: str, chunk_rows: int = 262144,
                        dtype=np.float32,
                        device: torch.device | str | None = None
                        ) -> torch.Tensor:
    """Stream an fbin corpus straight into one preallocated tensor on
    ``device`` (default: the card; ``device="cpu"`` fills a CPU tensor).

    On the card each chunk is staged through one of two pinned host buffers
    and copied asynchronously; a buffer is refilled only after its last
    copy has completed (an event per buffer), so disk prefetch (the native
    thread), the staging copy and the transfers overlap, and peak host
    memory is a few chunks instead of the whole corpus.
    """
    dev = array_device(device)
    n, d = read_meta(path)
    tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
    buf = torch.empty((n, d), dtype=tdtype, device=dev)
    if dev.type != "cuda":
        for row, chunk in stream_fbin(path, chunk_rows, dtype):
            buf[row: row + chunk.shape[0]] = torch.from_numpy(chunk)
        return buf
    staging = [torch.empty((chunk_rows, d), dtype=tdtype, pin_memory=True)
               for _ in range(2)]
    done = [None, None]
    with torch.cuda.device(dev):
        for i, (row, chunk) in enumerate(stream_fbin(path, chunk_rows,
                                                     dtype)):
            slot = i % 2
            if done[slot] is not None:
                done[slot].synchronize()
            rows = chunk.shape[0]
            staging[slot][:rows].numpy()[:] = chunk
            buf[row: row + rows].copy_(staging[slot][:rows], non_blocking=True)
            done[slot] = torch.cuda.Event()
            done[slot].record()
        torch.cuda.current_stream(dev).synchronize()
    return buf
