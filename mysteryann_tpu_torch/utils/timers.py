"""Timing utilities.

A context-manager Timer. CUDA work is asynchronous, so a timer that should
measure device work takes a ``sync`` callable (``device_sync(dev)``).
"""

from __future__ import annotations

import functools
import time

import torch


def device_sync(device: torch.device | str):
    """A ``Timer``'s ``sync`` for work on ``device``: the card's
    synchronize, or None on the CPU, whose work is done when a call
    returns."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return functools.partial(torch.cuda.synchronize, device)


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
