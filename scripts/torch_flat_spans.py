"""Read the port's own spans (``msann.*``) in traced stretches of a
benchmark cell, with the reductions a later change of the benchmark's
harness would make its own.

    python3 scripts/torch_flat_spans.py --workload t2i10m-flat.b8192 \
        --seed 3100000021 [--rounds 3] [--out out/spans.jsonl]
    python3 scripts/torch_flat_spans.py --span-cost
    python3 scripts/torch_flat_spans.py --dump trace.jsonl

The cell is set up as ``benchmark/run.py`` sets it up (world, engine,
warm-up calls; no measured window). It is then traced ``--rounds`` times
with the program's tracing off and as often with it on, in turns, each
stretch as ``runner._traced`` makes it: one settling call, then calls for
the mix's ``trace_seconds`` under ``torch.profiler``. Each stretch is
reduced two ways:

- ``harness``: as the harness reduces a trace now
  (``harness/trace.from_profiler``). With the program's tracing on, its
  ranges on the CUDA timeline count there as busy device operations, and
  its host spans become the outermost host operations;
- ``split``: with the ``msann.`` events set apart (``split``), the
  ``Trace`` the harness gets without them, plus the program's host spans
  and their extents on the CUDA timeline.

The cell's per-layer readers read both. From ``split`` come
``flat.entry_idle_ms`` (device-idle ms a traced call in gaps whose middle
lies inside a ``msann.flat.*`` host span, split by the innermost such span;
beside it ``entry_idle_clipped_ms``, the idle inside those spans alone, and
``entry_idle_device_ms``, the idle inside their CUDA-side extents, which
needs no alignment of the two timelines) and ``flat.rerank_roofline`` (the union of device operations inside
``msann.flat.rerank``'s device extents, a call, against ``rerank_bound``).
With tracing on, the Tracer's events are laid over the profiler's own ranges
for them (``clock``: how far apart their ends lie, in µs), its dropped
events are counted, and its dump is written beside ``--out``. Runs on the
card only.

``--span-cost`` times the Tracer's ``span`` on this host, off and on
(without a profiler running), in ns a span. ``--dump`` reads a Tracer's
dump (``MSANN_TRACE=<path>`` writes one when a process exits): each span's
count and its median and largest host ms, the counters and ``t0_ns``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import timeit
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import roofline  # noqa: E402
from benchmark.harness import trace as tr  # noqa: E402

PROGRAM = "msann."
ENTRY = "msann.flat."
RERANK = "msann.flat.rerank"
Event = Tuple[str, float, float, bool]   # (name, start µs, end µs, device)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclass
class Program:
    trace: tr.Trace                  # as the harness reads it, without msann.
    host: List[tr.Interval]          # the program's spans, CPU timeline
    device: List[tr.Interval]        # their extents on the CUDA timeline


def split(events: Iterable[Event]) -> Program:
    """The trace with the program's ``msann.`` events set apart; every other
    event goes where ``harness/trace.from_profiler`` puts it."""
    device, host, spans, p_host, p_dev = [], [], [], [], []
    for name, s, e, on_device in events:
        iv = (name, s, e)
        if name.startswith(PROGRAM):
            (p_dev if on_device else p_host).append(iv)
        elif name.startswith(tr.SPAN_PREFIX):
            if not on_device:
                spans.append(iv)
        elif on_device:
            device.append(iv)
        else:
            host.append(iv)
    return Program(tr.build(device, host, spans), p_host, p_dev)


def profiler_events(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, float(e.time_range.start), float(e.time_range.end),
             e.device_type == cuda) for e in prof.events()]


def _innermost(spans: Sequence[tr.Interval]) -> List[tr.Interval]:
    """The stretch of a timeline the spans cover, cut into disjoint pieces,
    each named by the innermost span covering it."""
    spans = sorted(spans, key=lambda iv: (iv[1], -iv[2]))
    points = sorted({t for _, s, e in spans for t in (s, e)})
    out = []
    for a, b in zip(points, points[1:]):
        mid, inner = 0.5 * (a + b), None
        for iv in spans:
            if iv[1] > mid:
                break
            if mid < iv[2]:
                inner = iv          # a later start inside: more inner
        if inner is not None:
            out.append((inner[0], a, b))
    return out


def entry_idle(p: Program, prefix: str = ENTRY, clip: bool = False,
               on_device: bool = False):
    """(ms, {span: ms}) a traced call of device idle inside the spans
    named ``prefix...`` (their host ranges, or with ``on_device`` their
    CUDA-side extents), by the innermost such span: each gap whole where
    its middle lies (``clip`` False, the harness's rule for its idle gaps),
    or only the part of each gap that a span covers (``clip``); (None, {})
    with no such span or no call."""
    spans = p.device if on_device else p.host
    pieces = _innermost([iv for iv in spans if iv[0].startswith(prefix)])
    t = p.trace
    if not pieces or not t.calls:
        return None, {}
    by: Dict[str, float] = {}
    for s, e in tr.gaps(tr.merge(t.device), t.start_us, t.end_us):
        mid = 0.5 * (s + e)
        for name, a, b in pieces:
            if clip:
                part = min(e, b) - max(s, a)
            else:
                part = e - s if a <= mid < b else 0.0
            if part > 0:
                by[name] = by.get(name, 0.0) + part
    per_call = {n: v / 1e3 / t.calls for n, v in by.items()}
    return sum(per_call.values()), per_call


def busy_inside(p: Program, name: str) -> float:
    """Seconds of the union of device operations inside the device extents
    of the program's span ``name``."""
    ext = tr.merge([iv for iv in p.device if iv[0] == name])
    ops = tr.merge(p.trace.device)
    total = 0.0
    for es, ee in ext:
        for s, e in ops:
            if s >= ee:
                break
            total += max(0.0, min(e, ee) - max(s, es))
    return total / 1e6


def rerank_bound(B: int, kk: int, d: int, k: int) -> Tuple[float, str]:
    """The exact f32 rerank of a head of ``kk`` candidates a query: 2·B·kk·d
    operations at the f32 peak, against B·kk candidate rows and B queries of
    d f32 and B·kk int32 ids read once, and B·k f32 distances and int64 ids
    written once."""
    flops = 2.0 * B * kk * d
    nbytes = (B * kk + B) * d * 4 + B * kk * 4 + B * k * 12
    return roofline.bound_s(flops, nbytes, roofline.PEAK["f32_flop_s"])


def rerank_roofline(p: Program, config: dict, traffic: dict):
    """The rerank's device time a traced call against ``rerank_bound`` at
    the cell's shapes, in percent; None without its extents."""
    t = busy_inside(p, RERANK)
    if t <= 0 or not p.trace.calls:
        return None
    w, s = config["world"], config["serve"]
    k = int(s["k"])
    bound, _ = rerank_bound(int(traffic["batch"]),
                            min(k * int(s["oversample"]), int(w["n_base"])),
                            int(w["dim"]), k)
    return roofline.share_pct(bound, t / p.trace.calls)


def clock(tracer_events: Sequence[dict], t0_ns: int,
          program_host: Sequence[tr.Interval], trace_start_ns: int):
    """How far the Tracer's spans lie from the profiler's own ranges for
    them, in µs: start (profiler minus Tracer) and end (Tracer minus
    profiler), each median and largest; None unless both hold the same
    spans in the same order."""
    ours = sorted(((e["name"], t0_ns / 1e3 + e["t_start"] * 1e6,
                    t0_ns / 1e3 + (e["t_start"] + e["dur_s"]) * 1e6)
                   for e in tracer_events if "call" in e),
                  key=lambda iv: iv[1])
    theirs = sorted(((n, trace_start_ns / 1e3 + s, trace_start_ns / 1e3 + e)
                     for n, s, e in program_host), key=lambda iv: iv[1])
    if not ours or [n for n, _, _ in ours] != [n for n, _, _ in theirs]:
        return None
    d_start = [b[1] - a[1] for a, b in zip(ours, theirs)]
    d_end = [a[2] - b[2] for a, b in zip(ours, theirs)]
    return {"spans": len(ours),
            "start_us": [statistics.median(d_start), max(d_start)],
            "end_us": [statistics.median(d_end), max(d_end)],
            "least_us": min(d_start + d_end)}


def span_cost(n: int = 200_000) -> dict:
    """ns a ``with tracer.span(...)`` block costs on this host, off and on
    (no profiler running)."""
    from mysteryann_tpu_torch.utils.trace import Tracer

    t = Tracer()

    def one():
        with t.span("msann.flat.scan"):
            pass

    out = {}
    for on, count in ((False, n), (True, n // 20)):
        t.on = on
        best = min(timeit.repeat(one, number=count, repeat=5))
        out["on_ns" if on else "off_ns"] = 1e9 * best / count
    return out


def read_dump(path: str) -> dict:
    """A Tracer's dump, summed up by span name."""
    by: Dict[str, List[float]] = {}
    out: dict = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "counters" in rec:
                out.update(rec)
            else:
                by.setdefault(rec["name"], []).append(1e3 * rec["dur_s"])
    out["spans"] = {n: {"n": len(v), "median_ms": statistics.median(v),
                        "max_ms": max(v)} for n, v in by.items()}
    return out


def _stretch(caller, seconds: float, device):
    """``runner._traced``'s calls under the profiler; the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness.runner import sync

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
    return prof


def _readings(p_trace: tr.Trace, cell) -> dict:
    from benchmark.harness.runner import Run

    run = Run(config=cell.config, traffic=cell.traffic, trace=p_trace)
    out = {m.name: m.read(run) for m in cell.per_layer}
    out["busy_s"], out["window_s"] = p_trace.busy_s, p_trace.window_s
    out["idle_gaps"] = tr.breakdown(p_trace)["idle_gaps"]
    return out


def measure(root: str, workload: str, seed: int, rounds: int, device,
            out: str | None = None) -> List[dict]:
    """One record a traced stretch: ``rounds`` with the program's tracing
    off and as many on, in turns, after the cell's set-up and warm-up."""
    import torch

    from benchmark.harness.runner import Caller, ClosedLoop, sync
    from benchmark.harness.spec import Spec
    from benchmark.harness.world import make_world
    from mysteryann_tpu_torch.utils.trace import DROPPED, tracer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Spec(root).cell(workload)
    world = make_world(cell.config["world"], seed, device)
    engine = cell.engine.Engine(cell.config, world, device, log)
    caller = Caller(engine, ClosedLoop(cell.traffic, world.pool), log)
    for _ in range(int(cell.traffic["warmup_calls"])):
        caller.call("bench.warmup")
    sync(device)
    seconds = float(cell.traffic["trace_seconds"])
    prog = tracer()
    records = []
    for r in range(rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            prog.reset()
            with prog.tracing(on):
                prof = _stretch(caller, seconds, device)
            caller.answers.clear()
            p = split(profiler_events(prof))
            idle_ms, idle_split = entry_idle(p)
            clip_ms, clip_split = entry_idle(p, clip=True)
            dev_ms, dev_split = entry_idle(p, clip=True, on_device=True)
            rec = {"workload": workload, "seed": seed, "round": r,
                   "tracing": on, "calls": p.trace.calls,
                   "device_operations": p.trace.kernels,
                   "harness": _readings(tr.from_profiler(prof), cell),
                   "split": _readings(p.trace, cell),
                   "flat.entry_idle_ms": idle_ms,
                   "entry_idle_split_ms": idle_split,
                   "entry_idle_clipped_ms": clip_ms,
                   "entry_idle_clipped_split_ms": clip_split,
                   "entry_idle_device_ms": dev_ms,
                   "entry_idle_device_split_ms": dev_split,
                   "flat.rerank_roofline": rerank_roofline(
                       p, cell.config, cell.traffic),
                   "rerank_ms": (1e3 * busy_inside(p, RERANK)
                                 / max(1, p.trace.calls)),
                   "program_spans": {"host": len(p.host),
                                     "device": len(p.device)}}
            if on:
                rec["clock"] = clock(
                    list(prog.events), prog.t0_ns, p.host,
                    prof.profiler.kineto_results.trace_start_ns())
                rec["dropped_events"] = prog.counters.get(DROPPED, 0.0)
                if out:
                    prog.dump(f"{out}.tracer.r{r}.jsonl")
            records.append(rec)
            log(json.dumps({k: rec[k] for k in (
                "round", "tracing", "calls", "flat.entry_idle_ms",
                "entry_idle_split_ms", "entry_idle_clipped_ms",
                "entry_idle_clipped_split_ms", "entry_idle_device_ms",
                "entry_idle_device_split_ms", "flat.rerank_roofline",
                "rerank_ms",
                "clock") if k in rec}))
    engine.close()
    return records


def summarize(records: Sequence[dict]) -> dict:
    """Each reading's values by tracing off / on, in the rounds' order."""
    out = {}
    for on in (False, True):
        rs = [r for r in records if r["tracing"] == on]
        key = "on" if on else "off"
        for way in ("harness", "split"):
            for m in ("flat.k3f_roofline", "device.idle_pct", "busy_s"):
                out[f"{key}.{way}.{m}"] = [r[way].get(m) for r in rs]
        for m in ("flat.entry_idle_ms", "entry_idle_clipped_ms",
                  "entry_idle_device_ms", "flat.rerank_roofline",
                  "rerank_ms"):
            out[f"{key}.{m}"] = [r[m] for r in rs]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--span-cost", action="store_true")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    if args.span_cost:
        print(json.dumps(span_cost()))
        return 0
    if args.dump:
        print(json.dumps(read_dump(args.dump)))
        return 0
    if args.workload is None or args.seed is None:
        ap.error("--workload and --seed are needed")

    import torch

    from benchmark.tools.series import card

    if not torch.cuda.is_available():
        log("the spans are read on the card")
        return 2
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
    records = measure(ROOT, args.workload, args.seed, args.rounds,
                      torch.device("cuda", 0), args.out)
    if args.out:
        with open(args.out, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "card": card(), "torch": torch.__version__,
                      **summarize(records)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
