"""Native host runtime (C++ via ctypes) — port of ``mysteryann_tpu/native``.

``csrc/msann_native.cpp`` (the port's own copy of the JAX package's source)
holds the graph-file (de)serialisation and the double-buffered fbin reader.
It is built with ``g++`` at first use into the package's git-ignored
``build/`` directory, named after the source's content hash
(``ops/_nvcc.compile_library``), and loaded with ``ctypes``. The build
writes a private temporary file and renames it into place, so concurrent
processes on a fresh checkout never load a half-written library.

As in the JAX package, ``lib()`` returns None when there is no toolchain,
and every caller then takes its Python path (the plain version). Callers
record which route they took with ``note``; ``status()`` reports it, so a
run can show that the native path ran rather than a silent fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, Optional

from mysteryann_tpu_torch.ops._nvcc import CSRC, compile_library

SOURCE = os.path.join(CSRC, "msann_native.cpp")
GXX_FLAGS = ["-O3", "-std=c++17", "-pthread", "-shared", "-fPIC"]
EINVAL = -22   # the loaders' return code for trailing bytes

_lock = threading.Lock()
_lib = None
_tried = False
_so: Optional[str] = None
_error: Optional[str] = None
calls: Dict[str, int] = {"native": 0, "python": 0}   # routes taken so far


def _bind(L: ctypes.CDLL) -> ctypes.CDLL:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    L.msann_read_header.argtypes = [ctypes.c_char_p, u32p, u32p]
    L.msann_save_projection.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, i32p,
        ctypes.c_uint32]
    L.msann_scan_projection.argtypes = [
        ctypes.c_char_p, u32p, u32p, u32p, i64p]
    L.msann_load_projection.argtypes = [
        ctypes.c_char_p, i32p, ctypes.c_uint32, ctypes.c_uint32]
    L.msann_save_bipartite.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, i32p, ctypes.c_uint32]
    L.msann_scan_bipartite.argtypes = [ctypes.c_char_p, u32p, u32p]
    L.msann_load_bipartite.argtypes = [
        ctypes.c_char_p, i32p, ctypes.c_uint32, ctypes.c_uint32]
    L.msann_stream_open.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32]
    L.msann_stream_open.restype = ctypes.c_void_p
    L.msann_stream_meta.argtypes = [ctypes.c_void_p, u32p, u32p]
    L.msann_stream_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    L.msann_stream_next.restype = ctypes.c_int64
    L.msann_stream_close.argtypes = [ctypes.c_void_p]
    L.msann_stream_close.restype = None
    for fn in ("msann_read_header", "msann_save_projection",
               "msann_scan_projection", "msann_load_projection",
               "msann_save_bipartite", "msann_scan_bipartite",
               "msann_load_bipartite", "msann_stream_meta"):
        getattr(L, fn).restype = ctypes.c_int
    return L


def lib():
    """Return the loaded native library, or None if unavailable."""
    global _lib, _tried, _so, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            _so, _, _ = compile_library(SOURCE, ["g++", *GXX_FLAGS],
                                        timeout=120)
            _lib = _bind(ctypes.CDLL(_so))
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            # no toolchain (or a failed build): callers take the Python
            # path; status() says why
            _error = f"{type(e).__name__}: {e}"
        return _lib


def note(route: str) -> None:
    """Record that a caller took ``route`` ("native" or "python")."""
    calls[route] += 1


def status() -> dict:
    """Whether the library loaded (``loaded``, ``library``, ``error``) and
    the routes callers have taken so far (``calls``)."""
    return {"loaded": _lib is not None, "library": _so, "error": _error,
            "calls": dict(calls)}


def ptr_i32(a) -> "ctypes._Pointer":
    """int32 pointer to a C-contiguous numpy array (the caller keeps it
    alive across the native call)."""
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
