"""Timing utilities.

Host copy of ``mysteryann_tpu/utils/timers.py``'s context-manager Timer
(the reference's accumulate-and-print ``TimeMetric``, include/efanna2e/
util.h:240-264, is not ported). CUDA work is asynchronous, so a timer that
should measure device work takes a ``sync`` callable (for example
``torch.cuda.synchronize``).
"""

from __future__ import annotations

import time


class Timer:
    """``with Timer("phase") as t: ...`` — elapsed seconds in ``t.elapsed``."""

    def __init__(self, name: str = "", sync=None, verbose: bool = False):
        self.name = name
        self.elapsed = 0.0
        self._sync = sync
        self._verbose = verbose

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            self._sync()
        self.elapsed = time.perf_counter() - self._t0
        if self._verbose:
            print(f"[timer] {self.name}: {self.elapsed:.3f}s")
        return False
