"""The T2I-like cross-modal world, drawn on the device from ``--seed``.

A torch rewrite of the port's ``io/synthetic.make_cross_modal`` (itself a
copy of the JAX package's numpy generator), with the same construction:
points lie on a low-dimensional manifold of concept-mixture Gaussians with
a Zipf (exponent 0.8) concept popularity; the base ("image") side and the
query ("text") side map that latent space to the ambient width through
different linear maps plus a shared offset, so the queries are out of the
base's distribution while their neighbours stay meaningful; every row is
unit-normed for inner product.

The draws are torch's, not numpy's, so the arrays differ from
``make_cross_modal``'s for the same seed; they are drawn by a
``torch.Generator`` on the device, in blocks of ``CHUNK`` rows, so that a
10M-row base costs its own bytes and little scratch. The world itself
(concepts, modality maps, the gap's direction) comes from the
configuration's fixed ``world_seed``. Each part of the rows (the base, the
training queries, the evaluation pool) has a stream of its own, keyed by
``--seed`` and the part's name, so the pool is held out: drawn from the
same world, by another stream.
"""

from __future__ import annotations

import hashlib
import math
from typing import NamedTuple

import torch


CHUNK = 1 << 20


class World(NamedTuple):
    base: torch.Tensor      # f32 [n_base, dim]
    train: torch.Tensor     # f32 [n_train, dim]
    pool: torch.Tensor      # f32 [n_pool, dim], the evaluation queries


def stream_seed(seed: int, part: str) -> int:
    """A 63-bit generator seed for ``part`` of the world of ``seed`` (any
    whole number, also past 64 bits)."""
    digest = hashlib.sha256(f"{int(seed)}/{part}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _gen(seed: int, part: str, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, part))
    return g


def make_world(spec: dict, seed: int, device: torch.device) -> World:
    """The rows of the world of the configuration's ``world`` block:
    ``world_seed``, ``n_base``, ``n_train`` (default 0), ``n_pool``,
    ``dim``, ``metric``, ``n_concepts``, ``intrinsic_dim``,
    ``modality_gap``, ``noise``; the rows drawn by ``seed``."""
    dim = int(spec["dim"])
    n_concepts = int(spec["n_concepts"])
    h = min(int(spec["intrinsic_dim"]), dim)
    gap = float(spec["modality_gap"])
    noise = float(spec["noise"])
    unit = spec["metric"] in ("ip", "cosine")
    f32 = dict(dtype=torch.float32, device=device)

    g = _gen(int(spec["world_seed"]), "world", device)
    concepts = torch.randn(n_concepts, h, generator=g, **f32)
    a_map = torch.randn(h, dim, generator=g, **f32) / math.sqrt(h)
    r_mix = torch.randn(h, h, generator=g, **f32) / math.sqrt(h)
    b_map = (1.0 - gap) * a_map + gap * (r_mix @ a_map)
    gap_dir = torch.randn(1, dim, generator=g, **f32)
    gap_dir = gap_dir / torch.linalg.vector_norm(gap_dir)
    pop = 1.0 / torch.arange(1, n_concepts + 1, **f32) ** 0.8
    cdf = torch.cumsum(pop / pop.sum(), 0)

    def sample(n: int, query_side: bool, part: str) -> torch.Tensor:
        gs = _gen(seed, part, device)
        out = torch.empty(n, dim, **f32)
        for s in range(0, n, CHUNK):
            m = min(CHUNK, n - s)
            u = torch.rand(m, generator=gs, **f32)
            ids = torch.clamp(torch.searchsorted(cdf, u), max=n_concepts - 1)
            z = concepts[ids] + torch.randn(m, h, generator=gs, **f32) * noise
            x = z @ (b_map if query_side else a_map)
            if query_side:
                x = x + gap_dir * (gap * 2.0)
            x = x + torch.randn(m, dim, generator=gs, **f32) * 0.02
            if unit:
                x = x / torch.clamp(torch.linalg.vector_norm(
                    x, dim=1, keepdim=True), min=1e-12)
            out[s:s + m] = x
        return out

    return World(base=sample(int(spec["n_base"]), False, "base"),
                 train=sample(int(spec.get("n_train", 0)), True, "train"),
                 pool=sample(int(spec["n_pool"]), True, "pool"))
