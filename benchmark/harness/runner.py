"""One run of one cell: set-up, the measured window, the traced calls, the
comparison that decides ``correct``, and the metrics.

Traffic is a closed loop with one caller: each call is answered before the
next is sent, and a call ends when its ids and distances are on the host.
Calls take the evaluation pool's rows in order, a batch at a time, and
start again at its first row when it runs out. Set-up draws the world from
the seed, builds the engine, and warms the batch shape up; the window then
runs calls for ``--seconds``. With ``--trace 1`` a short traced stretch of
calls follows the window, under ``torch.profiler``; the per-layer metrics
read it, and the window's own numbers stay untraced.
"""

from __future__ import annotations

import gc
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch

from benchmark.harness import checks
from benchmark.harness import trace as tr
from benchmark.harness.spec import Cell, Spec
from benchmark.harness.world import make_world


@dataclass
class Run:
    """What a metric's reader may read."""
    config: dict
    traffic: dict
    setup_s: float = 0.0
    setup_parts: Dict[str, float] = field(default_factory=dict)
    spans: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    latencies_s: List[float] = field(default_factory=list)
    window_s: float = 0.0
    queries: int = 0
    calls: int = 0
    recall: float | None = None
    trace: tr.Trace | None = None


class ClosedLoop:
    """The pool's rows, ``batch`` at a time, in order, round and round."""

    def __init__(self, traffic: dict, pool: torch.Tensor):
        if traffic.get("generator") != "closed_loop":
            raise ValueError(f"unknown traffic generator "
                             f"{traffic.get('generator')!r}")
        if int(traffic.get("clients", 1)) != 1:
            raise ValueError("the closed loop has one caller")
        self.batch = int(traffic["batch"])
        self.pool = pool
        if pool.shape[0] % self.batch:
            raise ValueError(f"pool of {pool.shape[0]} rows is no whole "
                             f"number of batches of {self.batch}")
        self.next = 0

    def take(self):
        """(offset, queries) of the next call: a view of the pool."""
        s = self.next
        self.next = (s + self.batch) % self.pool.shape[0]
        return s, self.pool[s:s + self.batch]


class Caller:
    """Sends calls to the engine and keeps every answer for the check."""

    def __init__(self, engine, loop: ClosedLoop, log: Callable):
        self.engine, self.loop, self.log = engine, loop, log
        self.answers: List[checks.Answer] = []
        self.failed = 0
        self.sent = 0

    def call(self, name: str = tr.CALL) -> None:
        s, q = self.loop.take()
        self.sent += q.shape[0]
        try:
            with torch.profiler.record_function(name):
                ids, dists = self.engine.search(q)
            with torch.profiler.record_function(tr.COPY):
                ids_h, dists_h = ids.cpu(), dists.cpu()
        except Exception:            # noqa: BLE001 - a failed call is counted
            if not self.failed:
                self.log("a call raised:\n" + traceback.format_exc())
            self.failed += q.shape[0]
            return
        self.answers.append(checks.Answer(s, q.shape[0], ids_h, dists_h))


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _traced(caller: Caller, seconds: float, device: torch.device):
    """Calls for ``seconds`` under the profiler, after one call that lets
    it settle; the ``Trace`` of the traced calls."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        caller.call("bench.prewarm")
        sync(device)
        t0 = time.perf_counter()
        while True:
            caller.call()
            if time.perf_counter() - t0 >= seconds:
                break
        sync(device)
    return tr.from_profiler(prof)


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             log: Callable = print, cell: Cell | None = None):
    """Run ``workload`` once; returns (result line as a dict, the numbers
    compared). ``t_start`` is the host clock at the process's start:
    ``setup_s`` runs from it to the window."""
    cell = cell or Spec(root).cell(workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(config=cell.config, traffic=cell.traffic)

    world = make_world(cell.config["world"], seed, device)
    sync(device)
    log(f"world: {tuple(world.base.shape)} base, {tuple(world.train.shape)} "
        f"train, {tuple(world.pool.shape)} pool "
        f"({time.perf_counter() - t_start:.1f}s)")
    engine = cell.engine.Engine(cell.config, world, device, log)
    caller = Caller(engine, ClosedLoop(cell.traffic, world.pool), log)
    for _ in range(int(cell.traffic["warmup_calls"])):
        caller.call("bench.warmup")
    sync(device)
    caller.answers.clear()
    caller.sent = 0
    engine.reset_counters()
    run.setup_parts = dict(engine.setup_parts)
    run.spans = dict(engine.spans)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    log(f"set-up {run.setup_s:.1f}s: {run.setup_parts}")

    while True:
        c0 = time.perf_counter()
        n_answers, failed = len(caller.answers), caller.failed
        caller.call()
        c1 = time.perf_counter()
        if len(caller.answers) > n_answers:
            run.latencies_s.append(c1 - c0)
            run.queries += caller.answers[-1].size
        elif caller.failed == failed:
            raise RuntimeError("a call neither answered nor failed")
        if c1 - t0 >= seconds:
            break
    run.window_s = c1 - t0
    run.calls = len(run.latencies_s)
    run.counters = dict(engine.counters())
    log(f"window {run.window_s:.2f}s: {run.calls} calls, "
        f"{run.queries} queries")
    if trace:
        run.trace = _traced(caller, float(cell.traffic["trace_seconds"]),
                            device)
        log(f"traced {run.trace.window_s:.3f}s: {run.trace.calls} calls, "
            f"{run.trace.kernels} device operations")

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    engine.close()
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers, run.recall, bad = checks.judge(
        caller.answers, caller.failed, world.pool, world.base, cell.config,
        cell.reference)
    correct = all(v["ok"] for v in numbers.values())

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": caller.sent,
              "failed": bad, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = tr.breakdown(run.trace)
    result["checks"] = {n: {"value": v["value"], "limit": v["limit"]}
                        for n, v in numbers.items()}
    return result, numbers
