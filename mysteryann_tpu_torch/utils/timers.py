"""Timing utilities.

Host copy of ``mysteryann_tpu/utils/timers.py``: the reference's
accumulate-and-print ``TimeMetric`` (include/efanna2e/util.h:240-264) plus a
context-manager Timer. CUDA work is asynchronous, so a timer that should
measure device work takes a ``sync`` callable (for example
``torch.cuda.synchronize``).
"""

from __future__ import annotations

import time
from typing import Optional


class TimeMetric:
    """Accumulating named timer: reset() / record() / print(); seconds."""

    def __init__(self, name: str = ""):
        self.name = name
        self.total = 0.0
        self._t0: Optional[float] = None

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def record(self) -> None:
        if self._t0 is None:
            raise RuntimeError("record() before reset()")
        self.total += time.perf_counter() - self._t0
        self._t0 = None

    def print(self) -> None:  # noqa: A003 - mirrors reference API
        print(f"[TimeMetric] {self.name}: {self.total:.6f}s")


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
