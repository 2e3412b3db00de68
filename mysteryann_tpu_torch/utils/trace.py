"""Structured tracing — events + counters, JSONL export (host copy of
``mysteryann_tpu/utils/trace.py``).

The reference's observability is three always-commented-out TimeMetric
instances and cout progress lines (SURVEY §5). Here: a process-wide
tracer with nested spans (wall time) and counters, dumpable as JSONL for
offline analysis. Device work is async — spans that should measure device
time must pass a `sync` callable (e.g. ``torch.cuda.synchronize``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class Tracer:
    def __init__(self):
        self._lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self.counters: Dict[str, float] = {}
        self._t0 = time.perf_counter()

    @contextmanager
    def span(self, name: str, sync=None, **attrs):
        start = time.perf_counter()
        try:
            yield self
        finally:
            if sync is not None:
                sync()
            end = time.perf_counter()
            with self._lock:
                self.events.append({
                    "name": name,
                    "t_start": round(start - self._t0, 6),
                    "dur_s": round(end - start, 6),
                    **attrs,
                })

    def record(self, name: str, dur_s: float, **attrs) -> None:
        """Record an externally-timed span (e.g. from a Timer)."""
        with self._lock:
            self.events.append({
                "name": name,
                "t_start": round(time.perf_counter() - self._t0 - dur_s, 6),
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
        with self._lock:
            events = list(self.events)
            counters = dict(self.counters)
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
            f.write(json.dumps({"counters": counters}) + "\n")

    def reset(self) -> None:
        with self._lock:
            self.events.clear()
            self.counters.clear()
            self._t0 = time.perf_counter()


_global: Optional[Tracer] = None


def tracer() -> Tracer:
    """Process-wide tracer (created on first use; MSANN_TRACE=<path> makes
    interpreter exit dump it automatically)."""
    global _global
    if _global is None:
        _global = Tracer()
        path = os.environ.get("MSANN_TRACE")
        if path:
            import atexit
            atexit.register(lambda: _global.dump(path))
    return _global
