"""50M-scale serving on a corpus with no host copy (PyTorch port of
scripts/bench_50m.py).

Every row of the corpus is a function of its index
(`io/synthetic.CrossModalDeviceSpec`): tiles are generated on the device,
scanned or quantized, and dropped. At 50M x 128 the f32 corpus is never
held; the two single-card modes compared are

  flat-int8: a streamed global-int8 table [N, d] s8, a full scan per batch
             (`ops/knn.int8_global_knn_device`);
  ivf-int8:  `build_ivf_streaming` cluster blocks, grouped cluster-major
             scan at nprobe (K1 fetches the blocks).

Both rerank the merged candidate head with exact f32 rows REGENERATED from
ids on the device, inside the timed region; recall is against an exact
ground truth streamed over generated tiles (clamped full-width windows and
an id-dedup merge, so no row beyond N is ever scored).

Run on the card:  python scripts/torch_bench_50m.py [--n_base 50000000]
On the CPU (tiny): --device cpu --n_base 3000 --n_eval 128 --dim 32
                   --tile 1024 --query_batch 64 --qb_ivf 64 --nprobes 4
Emits one JSON line.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from mysteryann_tpu_torch.cli.common import add_device_flag, device_from
from _torch_benchrun import card_info, default_cache_dir, log, peak_gb, sync

K = 10
SEED = 23
WORLD = dict(n_concepts=20_000, intrinsic_dim=48, noise=0.85)


def make_spec(dim: int, device):
    """The difficulty-calibrated world's geometry with index-keyed draws."""
    from mysteryann_tpu_torch.io.synthetic import CrossModalDeviceSpec
    return CrossModalDeviceSpec(dim, metric="ip", seed=SEED, device=device,
                                **WORLD)


def merge_topk(bd, bi, nd, ni, k: int):
    """Fold a tile's top-k into the running one. Duplicate ids are dropped
    before selection (a clamped tail window feeds its overlap rows in
    twice): the first copy stays, the rest go to +inf. The width is 2k, so
    the pairwise mask is tiny."""
    cd = torch.cat([bd, nd], dim=1)
    ci = torch.cat([bi, ni], dim=1)
    w = ci.shape[1]
    pos = torch.arange(w, device=ci.device)
    later = pos[None, :, None] > pos[None, None, :]
    dup = ((ci[:, :, None] == ci[:, None, :]) & later).any(dim=2)
    cd = torch.where(dup, float("inf"), cd)
    v, p = torch.topk(cd, k, dim=1, largest=False)
    return v, ci.gather(1, p)


def streamed_gt(spec, eval_q: torch.Tensor, n: int, tile: int, k: int = K):
    """Exact top-k of ``eval_q`` over rows [0, n) generated tile by tile →
    (dists [Q, k] f32, ids [Q, k] int32) on the device. The last window is
    clamped to [n - tile, n): full width, and no row ≥ n is ever drawn."""
    from mysteryann_tpu_torch.ops.knn import exact_knn_device
    tile = min(tile, n)
    nq = eval_q.shape[0]
    bd = torch.full((nq, k), float("inf"), device=eval_q.device)
    bi = torch.full((nq, k), n, dtype=torch.int32, device=eval_q.device)
    for s in range(0, n, tile):
        st = min(s, n - tile)
        rows = spec.base_tile(st, tile)
        nd, ni = exact_knn_device(eval_q, rows, k=k, metric="ip",
                                  tile=min(tile, 131072),
                                  precision="highest")
        bd, bi = merge_topk(bd, bi, nd, ni + st, k)
        del rows
    return bd, bi


def regen_rerank(spec, q: torch.Tensor, ids: torch.Tensor,
                 vals: torch.Tensor, k: int, n: int):
    """Exact-f32 rerank from rows regenerated by id (no f32 corpus is
    resident): (ids [B, k], dists [B, k])."""
    B, R = ids.shape
    rows = spec.rows(torch.clamp(ids.reshape(-1), max=n - 1)).reshape(B, R, -1)
    ip = torch.bmm(rows, q[:, :, None])[:, :, 0]
    dist = torch.where(torch.isfinite(vals), -ip, float("inf"))
    v, p = torch.topk(dist, k, dim=1, largest=False)
    return ids.gather(1, p), v


def bench(search_fn, eval_q: torch.Tensor, qb: int, label: str, gt_i, gt_d):
    """One timed pass over all eval batches after a warm-up batch; the
    window is closed by a device synchronize on both sides."""
    from mysteryann_tpu_torch.utils.metrics import compute_recall, compute_rderr
    nq = eval_q.shape[0]
    if nq % qb:
        # a short last batch would change the grouped scan's slot width
        raise ValueError(f"the query batch ({qb}) must divide n_eval ({nq})")
    dev = eval_q.device
    search_fn(eval_q[:qb])
    sync(dev)
    t0 = time.perf_counter()
    outs = [search_fn(eval_q[s: s + qb]) for s in range(0, nq, qb)]
    sync(dev)
    dt = time.perf_counter() - t0
    ids = torch.cat([o[0] for o in outs]).cpu().numpy().astype(np.int64)
    dists = torch.cat([o[1] for o in outs]).cpu().numpy()
    row = {"mode": label, "qps": round(nq / dt, 1),
           "recall": round(compute_recall(ids, gt_i, K), 4),
           "rderr": round(compute_rderr(dists, gt_d, K, "ip"), 6)}
    log(row)
    return row


def ivf_search_fn(idx, spec, n: int, nprobe: int, rerank: int,
                  slot_budget: int = 4):
    def search(qs):
        ids, vals = idx._search_grouped(qs, k=rerank, nprobe=nprobe,
                                        slot_budget=slot_budget)
        return regen_rerank(spec, qs, ids, vals, K, n)
    return search


def build_flat_int8(spec, n: int, dim: int, tile: int):
    """The streamed global-int8 table: one pass for the global scale, one
    to quantize and store → (table int8 [n, dim], gscale)."""
    tile = min(tile, n)
    gmax = 0.0
    for s in range(0, n, tile):
        st = min(s, n - tile)
        gmax = max(gmax, float(spec.base_tile(st, tile).abs().max()))
    gscale = 127.0 / max(gmax, 1e-30)
    tbl = torch.zeros((n, dim), dtype=torch.int8, device=spec.device)
    for s in range(0, n, tile):
        st = min(s, n - tile)
        tbl[st: st + tile] = torch.clamp(
            torch.round(spec.base_tile(st, tile) * gscale),
            -127, 127).to(torch.int8)
    return tbl, gscale


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_base", type=int, default=50_000_000)
    ap.add_argument("--n_eval", type=int, default=16_384)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--tile", type=int, default=1 << 20)
    ap.add_argument("--query_batch", type=int, default=2048)
    ap.add_argument("--rerank", type=int, default=100)
    ap.add_argument("--nprobes", type=int, nargs="+",
                    default=[32, 64, 128, 256])
    ap.add_argument("--n_clusters", type=int, default=0)
    ap.add_argument("--qb_ivf", type=int, default=4096)
    ap.add_argument("--slot_budget", type=int, default=4)
    ap.add_argument("--skip_flat", action="store_true")
    ap.add_argument("--cache_dir", default=default_cache_dir(__file__))
    ap.add_argument("--no_cache", action="store_true",
                    help="compute everything, write nothing to disk")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_from(ap, args)

    from mysteryann_tpu_torch.ivf import build_ivf_streaming
    from mysteryann_tpu_torch.ops.knn import (int8_global_knn_device,
                                              quantize_rows_int8)

    n, dim, n_eval = args.n_base, args.dim, args.n_eval
    cache = None if args.no_cache else args.cache_dir
    spec = make_spec(dim, dev)
    tile = min(args.tile, n)
    eval_q = spec.queries(n_eval)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- exact GT, streamed over generated tiles ---------------------------
    gt_path = (os.path.join(cache, f"torch_synth50m_v3_{n}_{dim}_gt_"
                                   f"{n_eval}.npz") if cache else None)
    gt_secs = None
    if gt_path and os.path.exists(gt_path):
        with np.load(gt_path) as z:
            gt_i, gt_d = z["ids"].astype(np.int64), z["dists"]
    else:
        log("== exact GT (streamed) ==")
        sync(dev)
        t0 = time.time()
        bd, bi = streamed_gt(spec, eval_q, n, tile)
        sync(dev)
        gt_secs = round(time.time() - t0, 1)
        gt_i, gt_d = bi.cpu().numpy().astype(np.int64), bd.cpu().numpy()
        if gt_path:
            os.makedirs(cache, exist_ok=True)
            np.savez(gt_path, ids=gt_i, dists=gt_d)
        log(f"GT in {gt_secs:.0f}s")

    rows = []

    # ---- IVF int8 (cluster blocks) -----------------------------------------
    log("== ivf-int8 streamed build ==")
    sync(dev)
    t0 = time.time()
    idx = build_ivf_streaming(
        spec.base_tile, n, dim, metric="ip", tile=tile, seed=SEED,
        n_clusters=args.n_clusters, rows_fn=spec.rows,
        assign_cache=os.path.join(cache, "torch_synth50m_v3") if cache
        else None, verbose=True)
    sync(dev)
    ivf_build_s = round(time.time() - t0, 1)
    for p in args.nprobes:
        p = min(p, idx.n_clusters)
        # large batches amortize the cluster-block fetches; shrink for a
        # large nprobe to bound the stacked [nc, qmax, kk] candidates
        qb_p = min(n_eval, max(min(1024, args.qb_ivf),
                               args.qb_ivf * 64 // max(p, 64)))
        r = bench(ivf_search_fn(idx, spec, n, p, args.rerank,
                                args.slot_budget),
                  eval_q, qb_p, f"ivf_i8_p{p}", gt_i, gt_d)
        r["nprobe"] = p
        rows.append(r)
    waste = idx.n_clusters * idx.cap / n
    ivf_peak = peak_gb(dev)
    idx.free()
    del idx

    out = {"scale": n, "dim": dim, "n_eval": n_eval, "gt_secs": gt_secs,
           "ivf_build_secs": ivf_build_s, "ivf_waste": round(waste, 3),
           "ivf_peak_gb": ivf_peak, "rerank": args.rerank, "rows": rows}
    if not args.skip_flat:
        # ---- flat int8 (full scan) -----------------------------------------
        log("== flat-int8 streamed build ==")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        sync(dev)
        t0 = time.time()
        tbl, _ = build_flat_int8(spec, n, dim, tile)
        sync(dev)
        out["flat_build_secs"] = round(time.time() - t0, 1)
        log(f"flat-int8 table in {out['flat_build_secs']}s")

        def flat_search(qs):
            q_i8, _ = quantize_rows_int8(qs)
            _, ii = int8_global_knn_device(q_i8, tbl, k=args.rerank,
                                           tile=131072)
            # an ids-only scan: every candidate is valid
            vals = torch.zeros(ii.shape, device=ii.device)
            return regen_rerank(spec, qs, torch.clamp(ii, min=0), vals, K, n)

        rows.append(bench(flat_search, eval_q,
                          min(args.query_batch, n_eval), "flat_i8",
                          gt_i, gt_d))
        out["peak_gb"] = peak_gb(dev)
    out.update(card_info(dev))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
