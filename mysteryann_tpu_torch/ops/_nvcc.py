"""Build one source of the package into a shared library.

Every hand-written kernel of the port is a ``csrc/*.cu`` file with a plain C
entry point. At first use it is compiled for ``sm_90a`` into the package's
``build/`` directory (git-ignored), from the sources in the checkout only,
and the caller binds the entry point with ``ctypes``. The host runtime
(``csrc/msann_native.cpp``) is built the same way with ``g++``
(``native/__init__.py``). A library is named after its source's content
hash (with the headers it includes by a quoted name from its own
directory), so an edited source is rebuilt and an unchanged one is
reused.
Compiling concurrently from several threads or processes is safe: each
build writes a private temporary file and renames it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "csrc/*.cu with the CUDA toolkit")


def _local_includes(text: bytes) -> List[str]:
    return [m.decode() for m in re.findall(rb'^\s*#include\s+"([^"]+)"',
                                            text, re.M)]


def library_path(source: str) -> str:
    """``build/libmsann_<stem>_<hash>.so``, the hash of the source and of
    the headers it includes by a quoted name (from its own directory)."""
    h = hashlib.sha256()
    with open(source, "rb") as f:
        text = f.read()
    h.update(text)
    for name in _local_includes(text):
        with open(os.path.join(os.path.dirname(source), name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"libmsann_{stem}_{digest}.so")


def compile_library(source: str, compiler: List[str], force: bool = False,
                    timeout: float | None = None) -> Tuple[str, float, str]:
    """Run ``compiler + ["-o", tmp, source]`` unless the library of this
    source is already built (or ``force``), then rename it into place.

    Returns (library path, seconds spent compiling — 0 when reused, the
    compiler's output). Raises ``RuntimeError`` when the compiler fails."""
    so = library_path(source)
    secs, log = 0.0, ""
    if force or not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.{time.monotonic_ns()}.tmp"
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([*compiler, "-o", tmp, source],
                                  capture_output=True, text=True,
                                  timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{compiler[0]} failed on {source} ({proc.returncode}):"
                    f"\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        secs = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
    return so, secs, log


def build_library(source: str, force: bool = False
                  ) -> Tuple[ctypes.CDLL, float, str]:
    """Compile a CUDA ``source`` with nvcc (unless a library of the same
    content is already built, or ``force``) and load it.

    Returns (the loaded library, seconds spent compiling — 0 when reused,
    the compiler's output — registers and spills per kernel)."""
    so, secs, log = compile_library(source, [find_nvcc(), *NVCC_FLAGS],
                                    force=force)
    return ctypes.CDLL(so), secs, log
