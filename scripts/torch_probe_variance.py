"""Serving-QPS variance probe (PyTorch port of scripts/probe_variance.py).

Single trials of a row can fall far below the row's median. This probe
looks for the cause in a fresh process, on bench_torch.py's cached
``p2e4b4`` index and eval queries, with one seeded fused configuration
(L = 56, 40 seeds, expand 4, 8,192-query batches, ``FusedSearcher(
max_degree=48, seed_sample=2)``):

  phase A: back-to-back trials, each 8,192-query batch of a trial timed by
           CUDA events (is a slow trial slow in every batch, or is it one
           batch's stall?);
  phase B: the same after allocating and freeing a build-sized block
           (4 x 1 GiB f32): does the allocator's state bring the fall?
  phase C: the same after ``torch.cuda.empty_cache()`` + ``gc.collect()``
           (the cached blocks handed back) and one warm call.

Each phase's line has, per trial, its QPS, its wall ms, its batches' ms
(``trial_batch_ms``) and its recall@10; then ``per_batch_ms``: every batch
once more, each closed by a sync, after the trials. bench_torch.py's
contention sentinel is taken before A and after C (``sentinel_pre_ms`` on
A's line, ``sentinel_post_ms`` on C's). The queries are on the card before
any clock starts, as in ``FusedSearcher.benchmark``.

Run on an otherwise idle card after bench_torch.py has built its index:
                   python scripts/torch_probe_variance.py
On the CPU (tiny): --device cpu --n_base 2000 --n_train 600 --n_eval 128
                   --cache_dir /tmp/bt   (phase B still churns 4 GiB)
Emits one JSON line per phase.
"""

import argparse
import gc
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import bench_torch as bt  # noqa: E402
from mysteryann_tpu_torch.cli.common import add_device_flag, device_from  # noqa: E402
from _torch_benchrun import card_info, log, sync  # noqa: E402

L, SEEDS, EXPAND, QB = 56, 40, 4, 8192
K = 10
TRIALS = 10
CHURN_BLOCKS, CHURN_GIB = 4, 1.0


def _search(fused, qs: torch.Tensor):
    return fused.search(qs, K, L, query_batch=QB, device_out=True,
                        expand=EXPAND, seeds=SEEDS)


def _mark(dev: torch.device):
    """A point on the stream's clock: a recorded CUDA event on the card, the
    host's clock on the CPU (where every op has finished when it returns)."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) \
        else 1000.0 * (b - a)


def trial(fused, q: torch.Tensor):
    """One trial: every batch of ``q`` back to back, as ``search`` runs
    them. Returns (ids [Q, K] on the host, wall s, ms of each batch)."""
    dev = q.device
    sync(dev)
    t0 = time.perf_counter()
    marks, ids = [_mark(dev)], []
    for s in range(0, q.shape[0], QB):
        ids.append(_search(fused, q[s:s + QB])[0])
        marks.append(_mark(dev))
    sync(dev)
    dt = time.perf_counter() - t0
    return (torch.cat(ids).cpu().numpy(), dt,
            [_ms(a, b) for a, b in zip(marks, marks[1:])])


def trials(fused, q: torch.Tensor, n: int, label: str, gt_i=None) -> dict:
    """``n`` trials, then each batch once more on its own (closed by a
    sync): the phase's JSON record."""
    from mysteryann_tpu_torch.utils.metrics import compute_recall
    rec = {"label": label, "qps": [], "trial_ms": [], "trial_batch_ms": [],
           "recall": [], "per_batch_ms": []}
    for t in range(n):
        ids, dt, batch_ms = trial(fused, q)
        rec["qps"].append(round(q.shape[0] / dt, 1))
        rec["trial_ms"].append(round(1000 * dt, 3))
        rec["trial_batch_ms"].append([round(x, 3) for x in batch_ms])
        if gt_i is not None:
            rec["recall"].append(compute_recall(ids, gt_i, K))
        log(f"{label} trial {t}: {rec['qps'][-1]:.0f} QPS "
            f"({rec['trial_ms'][-1]:.0f} ms; batches {rec['trial_batch_ms'][-1]})")
    dev = q.device
    for s in range(0, q.shape[0], QB):
        sync(dev)
        t0 = time.perf_counter()
        _search(fused, q[s:s + QB])
        sync(dev)
        rec["per_batch_ms"].append(round(1000 * (time.perf_counter() - t0), 3))
    return rec


def alloc_churn(dev: torch.device) -> None:
    """Allocate and free CHURN_BLOCKS f32 blocks of CHURN_GIB GiB each: the
    transient buffers of a 1M fused build are of this size."""
    n = int(CHURN_GIB * 2**30) // 4
    junk = [torch.ones(n, dtype=torch.float32, device=dev) * i
            for i in range(CHURN_BLOCKS)]
    sync(dev)
    del junk


def clear_caches(fused, q: torch.Tensor) -> None:
    """Hand the allocator's cached blocks back to the card and collect
    Python's garbage, then one warm call."""
    if q.device.type == "cuda":
        torch.cuda.empty_cache()
    gc.collect()
    _search(fused, q[:QB])
    sync(q.device)


def run_phases(fused, q: torch.Tensor, gt_i=None, n_trials: int = TRIALS,
               emit=None) -> list:
    """Phases A, B and C on a warmed searcher; ``emit(record)`` is called
    as each phase ends."""
    out = []
    for label, before in (("A_fresh", None),
                          ("B_after_alloc_churn",
                           lambda: alloc_churn(q.device)),
                          ("C_after_empty_cache",
                           lambda: clear_caches(fused, q))):
        if before is not None:
            before()
        out.append(trials(fused, q, n_trials, label, gt_i))
        if emit is not None:
            emit(out[-1])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_base", type=int, default=bt.N_BASE)
    ap.add_argument("--n_train", type=int, default=bt.N_TRAIN)
    ap.add_argument("--n_eval", type=int, default=bt.N_EVAL)
    ap.add_argument("--cache_dir", default=bt.CACHE)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_from(ap, args)
    from mysteryann_tpu_torch.ops.distances import prepare_vectors
    from mysteryann_tpu_torch.search.fused import FusedSearcher

    cache, key = args.cache_dir, bt.world_key(args.n_base, args.n_train)
    index_path, _ = bt.index_paths(cache, key)
    if not os.path.exists(index_path):
        ap.exit(2, f"no index at {index_path}: run bench_torch.py or "
                   f"scripts/torch_probe_build_1m.py first\n")
    base, _, eval_q = bt.world(cache, args.n_base, args.n_train, args.n_eval)
    base_dev = prepare_vectors(base, bt.METRIC, dev)
    gt_i, _ = bt.ground_truth(cache, key, eval_q, base_dev)
    index, _ = bt.load_index(index_path)
    fused = FusedSearcher(index, base_dev, max_degree=bt.SEED_MAX_DEGREE,
                          seed_sample=bt.SEED_SAMPLE)
    q = prepare_vectors(eval_q, bt.METRIC, dev)
    card = card_info(dev)
    pre = bt.contention_sentinel(base_dev)
    _search(fused, q[:QB])          # one warm call
    sync(dev)

    lines = []

    def emit(rec):
        if rec["label"].startswith("A"):
            rec["sentinel_pre_ms"] = pre
        if rec["label"].startswith("C"):
            rec["sentinel_post_ms"] = bt.contention_sentinel(base_dev)
        rec.update(L=L, seeds=SEEDS, expand=EXPAND, query_batch=QB, **card)
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    run_phases(fused, q, gt_i, TRIALS, emit)
    return lines


if __name__ == "__main__":
    main()
