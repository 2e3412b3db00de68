"""Structured tracing: spans, counters and a JSONL export (the port's
counterpart of ``mysteryann_tpu/utils/trace.py``).

Spans are off until switched on (``Tracer.tracing()``, or
``MSANN_TRACE=<path>`` for the process-wide ``tracer()``, which then dumps
itself there when the interpreter exits). An off ``span()`` is a flag test
that returns a shared null context: no clock read, no lock. An on span
records its ``name``, ``t_start``, ``dur_s``, the name of the span it opened
inside (``parent``, None for an outermost span) and a ``call`` id shared by
every span of one outermost span, and it opens
``torch.profiler.record_function(name)`` around its body: a running
profiler shows it on its CPU timeline and, around the kernels launched
inside it, as an annotation on the CUDA timeline.

Times are read with ``time.time_ns``: CLOCK_REALTIME, the clock
``torch.profiler`` stamps its events with (``c10::getTime``). An event
starts at ``t0_ns`` (the dump's last line) + ``t_start`` seconds, so a dump
lies over a profiler trace of the same process.

``record`` (a phase timed outside, such as a build's ``Timer``) and
``count`` record whether spans are on or not. The event list keeps the
newest ``max_events`` events; the counter ``trace.dropped_events`` counts
the rest. Device work is asynchronous: a span that should measure it passes
a ``sync`` callable.

Every span the program opens is named ``msann.<layer>.<part>``.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Any, Deque, Dict, List, Optional

from torch.profiler import record_function

MAX_EVENTS = 1 << 16
DROPPED = "trace.dropped_events"
_OFF = nullcontext()


class _Open(threading.local):
    """A thread's open spans, innermost last: (name, call, attrs)."""

    def __init__(self):
        self.stack: List[tuple] = []


class Tracer:
    def __init__(self, on: bool = False, max_events: int = MAX_EVENTS):
        self.on = on
        self._lock = threading.Lock()
        self._open = _Open()
        self.events: Deque[Dict[str, Any]] = deque(maxlen=max_events)
        self.counters: Dict[str, float] = {}
        self._calls = itertools.count()
        self.t0_ns = time.time_ns()

    @contextmanager
    def tracing(self, on: bool = True):
        """Spans on (or off) inside the block, as they were after it."""
        was, self.on = self.on, on
        try:
            yield self
        finally:
            self.on = was

    def span(self, name: str, sync=None, **attrs):
        """A block recorded as ``name`` with ``attrs``, ``sync`` called at
        its end, while spans are on; the shared null context while off."""
        if not self.on:
            return _OFF
        return self._span(name, sync, attrs)

    @contextmanager
    def _span(self, name: str, sync, attrs: Dict[str, Any]):
        stack = self._open.stack
        parent = stack[-1] if stack else None
        call = parent[1] if parent else next(self._calls)
        start = time.time_ns()
        try:
            with record_function(name):
                stack.append((name, call, attrs))
                try:
                    yield self
                finally:
                    stack.pop()
                    if sync is not None:
                        sync()
        finally:
            end = time.time_ns()
            self._append({
                "name": name,
                "t_start": round((start - self.t0_ns) / 1e9, 6),
                "dur_s": round((end - start) / 1e9, 6),
                "parent": parent[0] if parent else None,
                "call": call,
                **attrs,
            })

    def note(self, **attrs) -> None:
        """Add attributes to the innermost open span of this thread (known
        only once its body has run part way); nothing when off."""
        if self.on and self._open.stack:
            self._open.stack[-1][2].update(attrs)

    def _append(self, event: Dict[str, Any]) -> None:
        with self._lock:
            if len(self.events) == self.events.maxlen:
                self.counters[DROPPED] = self.counters.get(DROPPED, 0.0) + 1
            self.events.append(event)

    def record(self, name: str, dur_s: float, **attrs) -> None:
        """Record an externally-timed span (e.g. from a Timer)."""
        start = time.time_ns() - round(dur_s * 1e9)
        self._append({
            "name": name,
            "t_start": round((start - self.t0_ns) / 1e9, 6),
            "dur_s": round(dur_s, 6),
            **attrs,
        })

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def summary(self) -> Dict[str, Any]:
        with self._lock:  # writers hold it; readers must too
            events = list(self.events)
            counters = dict(self.counters)
        by_name: Dict[str, List[float]] = {}
        for e in events:
            by_name.setdefault(e["name"], []).append(e["dur_s"])
        return {
            "spans": {k: {"n": len(v), "total_s": round(sum(v), 4),
                          "max_s": round(max(v), 4)}
                      for k, v in by_name.items()},
            "counters": counters,
        }

    def dump(self, path: str) -> None:
        """One JSON line an event, then ``{"counters": ..., "t0_ns": ...}``."""
        with self._lock:
            events = list(self.events)
            counters = dict(self.counters)
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
            f.write(json.dumps({"counters": counters,
                                "t0_ns": self.t0_ns}) + "\n")

    def reset(self) -> None:
        with self._lock:
            self.events.clear()
            self.counters.clear()
            self._calls = itertools.count()
            self.t0_ns = time.time_ns()


_global: Optional[Tracer] = None


def tracer() -> Tracer:
    """Process-wide tracer (created on first use, spans off; with
    MSANN_TRACE=<path> spans are on and interpreter exit dumps it there)."""
    global _global
    if _global is None:
        path = os.environ.get("MSANN_TRACE")
        _global = Tracer(on=bool(path))
        if path:
            import atexit
            atexit.register(lambda: _global.dump(path))
    return _global
