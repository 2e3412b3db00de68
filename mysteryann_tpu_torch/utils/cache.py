"""Host-side result cache (numpy copy of
``mysteryann_tpu/utils/cache.npz_cached``).

Worlds and exact-kNN ground truths take minutes to make at 4M–50M rows; the
benchmark scripts under ``scripts/`` keep them in ``.bench_cache/`` between runs. The
JAX package's ``enable_compile_cache`` has no counterpart here: nothing in
this package is compiled ahead of a call except the CUDA kernels, which
``ops/_nvcc.py`` caches by source hash.
"""

from __future__ import annotations

import os
from typing import Callable, List, Sequence

import numpy as np


def npz_cached(cache_dir: str, name: str,
               fn: Callable[[], Sequence[np.ndarray]]) -> List[np.ndarray]:
    """Return fn()'s arrays, loading from ``cache_dir/name.npz`` when present."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, name + ".npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return [z[k] for k in z.files]
    out = [np.asarray(a) for a in fn()]
    # np.savez appends ".npz" unless the name already ends with it
    tmp = path[:-4] + f".tmp{os.getpid()}.npz"
    np.savez(tmp, *out)
    os.replace(tmp, path)
    return out
