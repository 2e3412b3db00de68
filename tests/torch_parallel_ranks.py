"""Rank bodies of the port's parallel tests.

``mysteryann_tpu_torch.parallel.launch.run`` calls these in spawned ranks on
the CPU (gloo), so this module imports torch and the port only — never jax.
Every rank walks the same case list in the same order (mesh creation and
the collectives are made by all ranks together) and returns the gathered
global results as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from mysteryann_tpu_torch.graph.adjacency import PaddedGraph
from mysteryann_tpu_torch.graph.roargraph import RoarGraphIndex
from mysteryann_tpu_torch.ivf import IVFIndex
from mysteryann_tpu_torch.ops.distances import Metric, prepare_vectors
from mysteryann_tpu_torch.parallel import (ShardedFusedSearcher, ShardedIVF,
                                           all_gather,
                                           distributed_beam_search,
                                           gather_dp, init_distributed,
                                           make_mesh, make_mesh_distributed,
                                           psum, query_parallel_search,
                                           replicate, scatter_rows_sharded,
                                           shard_base,
                                           sharded_build_roargraph,
                                           sharded_exact_knn,
                                           sharded_prune_rows,
                                           take_rows_sharded)
from mysteryann_tpu_torch.utils.params import BuildConfig

_RESULT_FIELDS = ("ids", "dists", "cmps", "hops", "hist_ids", "hist_d")


def _gathered(mesh, r, axis) -> dict:
    return {f: all_gather(getattr(r, f), mesh, axis).numpy()
            for f in _RESULT_FIELDS if getattr(r, f) is not None}


def _case(mesh, case: dict, world: dict) -> dict:
    kind = case["kind"]
    opts = dict(case.get("opts", {}))
    if kind == "knn":
        d, i = sharded_exact_knn(
            mesh, shard_base(mesh, world["queries"], "dp"),
            shard_base(mesh, world["base"], "mp"), k=case["k"],
            metric=case["metric"])
        return {"dists": gather_dp(mesh, d).numpy(),
                "ids": gather_dp(mesh, i).numpy()}
    if kind == "beam":
        r = distributed_beam_search(
            mesh, shard_base(mesh, world["base"], "mp"),
            shard_base(mesh, world[case["graph"]], "mp"),
            torch.tensor(case["eps"], dtype=torch.int32),
            shard_base(mesh, world["queries"], "dp"), **opts)
        return _gathered(mesh, r, "dp")
    if kind == "query_parallel":
        r = query_parallel_search(
            mesh, replicate(mesh, world["base"]),
            replicate(mesh, world[case["graph"]]),
            torch.tensor(case["eps"], dtype=torch.int32),
            shard_base(mesh, world["queries"], ("dp", "mp")), **opts)
        return _gathered(mesh, r, ("dp", "mp"))
    if kind == "ivf":
        sidx = ShardedIVF(mesh, IVFIndex.from_parts(**world[case["index"]],
                                                     device="cpu"))
        ids, d = sidx.search(shard_base(mesh, world["queries"], "dp"),
                             device_out=True, **opts)
        return {"ids": gather_dp(mesh, ids).numpy(),
                "dists": gather_dp(mesh, d).numpy(),
                "n_clusters": sidx.n_clusters, "nc_real": sidx.nc_real}
    if kind == "sharded_fused":
        sf = _fused_searcher(mesh, world, case)
        out = sf.search(shard_base(mesh, world["queries"], "dp"),
                        device_out=True, **opts)
        return {f: gather_dp(mesh, o).numpy()
                for f, o in zip(_RESULT_FIELDS, out)}
    if kind == "fused_errors":
        return _fused_errors(mesh, world, case)
    if kind == "prune_rows":
        base = prepare_vectors(world["base"], case["metric"], "cpu")
        return {"pruned": sharded_prune_rows(
            mesh, shard_base(mesh, base, "mp"), world["tgt"], world["cand"],
            metric=case["metric"], n=base.shape[0], **opts).numpy()}
    if kind == "take_scatter":
        arr = shard_base(mesh, world["arr"], "mp")
        taken = take_rows_sharded(mesh, arr, world["ids"]).numpy()
        scatter_rows_sharded(mesh, arr, world["ids"], world["rows"])
        return {"taken": taken,
                "scattered": all_gather(arr, mesh, "mp").numpy()}
    if kind == "sharded_build":
        idx = sharded_build_roargraph(mesh, world["base"], world["train"],
                                      world["knn"], BuildConfig(**opts))
        return {"neighbors": idx.graph.neighbors, "ep": idx.graph.ep}
    if kind == "build_errors":
        return _build_errors(mesh, world, opts)
    raise ValueError(f"unknown case kind {kind!r}")


def _fused_searcher(mesh, world, case) -> ShardedFusedSearcher:
    index = RoarGraphIndex(graph=PaddedGraph(world["graph"], world["ep"]),
                           metric=Metric.parse(case["metric"]),
                           dim=world["base"].shape[1])
    return ShardedFusedSearcher(mesh, index, world["base"], **case["init"])


def _fused_errors(mesh, world, case) -> dict:
    """ShardedFusedSearcher.search's argument errors, raised by every rank
    before any collective."""
    bare = _fused_searcher(mesh, world, case)
    sampled = _fused_searcher(mesh, world, dict(case, init=dict(
        case["init"], seed_sample=4)))
    q = shard_base(mesh, world["queries"], "dp")
    got = {}
    for name, sf, kw in (
            ("seeds_without_sample", bare, dict(k=10, L=24, seeds=8)),
            ("seeds_over_L", sampled, dict(k=10, L=24, seeds=30)),
            ("k_over_L", bare, dict(k=30, L=24))):
        try:
            sf.search(q, **kw)
            got[name] = None
        except ValueError as e:
            got[name] = str(e)
    return got


def _build_errors(mesh, world, opts) -> dict:
    """sharded_build_roargraph's refusals: the fused engine, and an N that
    mp does not divide."""
    got = {}
    for name, n, engine in (("fused_engine", None, "fused"),
                            ("n_not_divisible", -1, "classic")):
        try:
            sharded_build_roargraph(
                mesh, world["base"][:n], world["train"], world["knn"],
                BuildConfig(**dict(opts, connectivity_engine=engine)))
            got[name] = None
        except ValueError as e:
            got[name] = str(e)
    return got


def run_cases(worlds: dict, cases: list) -> dict:
    """Each case on its own ``dp x mp`` mesh (made once per shape, in case
    order); returns {case name: gathered results}, plus the message of
    ``make_mesh(dp=16, mp=16)``'s refusal under "mesh_validation", the
    argument errors under "errors" and a mesh over a subset of the ranks
    under "mesh_subset"."""
    init_distributed(device="cpu")
    meshes, out = {}, {}
    for case in cases:
        shape = (case["dp"], case["mp"])
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device="cpu")
        out[case["name"]] = _case(meshes[shape], case, worlds[case["world"]])
    try:
        make_mesh(dp=16, mp=16, device="cpu")
        out["mesh_validation"] = None
    except ValueError as e:
        out["mesh_validation"] = str(e)
    if (2, 4) in meshes:
        out["errors"] = _errors(meshes[(2, 4)])
    out["mesh_subset"] = _subset()
    return out


def _subset() -> list:
    """``make_mesh(1, 4, devices=[4, 5, 6, 7])`` and a psum of rank + 1
    over its mp axis: every rank's (mesh is None, sum, coordinates),
    gathered over the whole group so that all ranks return the same."""
    sub = make_mesh(1, 4, devices=[4, 5, 6, 7], device="cpu")
    mine = (True, None, None) if sub is None else (
        False, psum(torch.tensor([torch.distributed.get_rank() + 1.0]),
                    sub, "mp").item(), (sub.coord("dp"), sub.coord("mp")))
    every = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(every, mine)
    return every


def _errors(mesh) -> dict:
    """The JAX package's argument errors, raised on every rank together:
    base shards of unequal size (mp does not divide N) and L < E."""
    rank_rows = 8 + mesh.coord("mp")
    got = {}
    try:
        sharded_exact_knn(mesh, torch.zeros(4, 8), torch.zeros(rank_rows, 8),
                          k=2)
        got["knn_uneven"] = None
    except ValueError as e:
        got["knn_uneven"] = str(e)
    try:
        distributed_beam_search(
            mesh, torch.zeros(8, 8), torch.zeros(8, 2, dtype=torch.int32),
            torch.arange(3, dtype=torch.int32), torch.zeros(4, 8), k=1, L=2)
        got["beam_l_below_e"] = None
    except ValueError as e:
        got["beam_l_below_e"] = str(e)
    return got


def multihost() -> dict:
    """Two "hosts" of 4 ranks (``LOCAL_WORLD_SIZE=4``): the dp x mp mesh
    keeps each dp row in one host, an mp axis over both hosts is refused,
    and a psum over dp crosses the hosts."""
    mesh = make_mesh_distributed(dp=2, mp=4, device="cpu")
    rows = mesh.device_mesh.mesh.tolist()
    try:
        make_mesh(dp=1, mp=8, device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    host = torch.distributed.get_rank() // 4
    got = psum(torch.full((4, 4), float(host + 1)), mesh, "dp")
    return {"shape": dict(mesh.shape), "rows": rows, "refused": refused,
            "psum_dp": got.numpy(), "coord": (mesh.coord("dp"),
                                              mesh.coord("mp"))}


def ranks_agree(results: list) -> bool:
    """Every rank returned the same gathered results."""
    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        return a == b
    return all(same(results[0], r) for r in results[1:])
