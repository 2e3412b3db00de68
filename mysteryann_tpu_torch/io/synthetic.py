"""Synthetic cross-modal dataset generators.

`make_cross_modal` is a numpy copy of
``mysteryann_tpu/io/synthetic.make_cross_modal``: same draws, so the data is
bit-identical to the JAX package's. `CrossModalDeviceSpec` is the
index-keyed corpus for worlds with no host copy (see below).

The reference validates only on downloaded datasets (prepare_data.sh) —
it has no synthetic fixture. We need one for unit tests and benchmarks:
an out-of-distribution (OOD) query workload resembling text→image retrieval,
where training/search queries come from a *different* distribution than the
base set (the regime RoarGraph targets).

Construction: points live on a low-intrinsic-dimension manifold (real CLIP
embeddings have intrinsic dim of a few dozen — a flat isotropic cloud in
128-d makes top-k near-ties that no graph method can rank, which is not
the workload the reference targets). Latent samples are concept-mixture
Gaussians in ``intrinsic_dim``; the base ("image") modality and the query
("text") modality map that latent space to the ambient dimension through
*different* random linear maps plus a shared-direction offset. Queries are
thus OOD w.r.t. the base cloud (the RoarGraph setting) while their true
neighbors remain semantically meaningful.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mysteryann_tpu_torch.ops.distances import array_device


def make_cross_modal(
    n_base: int,
    n_query: int,
    dim: int,
    n_concepts: int = 256,
    intrinsic_dim: int = 16,
    modality_gap: float = 0.35,
    noise: float = 0.45,
    metric: str = "ip",
    seed: int = 0,
    query_seed: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (base [n_base, dim], queries [n_query, dim]) float32.

    ``query_seed`` draws the query-side samples from an independent RNG
    stream while keeping the WORLD (concepts, modality maps, gap) from
    ``seed`` — the way to get held-out eval queries from the same
    distribution as a train set generated with plain ``seed`` (two
    different ``seed`` values are two unrelated worlds: eval queries
    from one share no latent structure with a base from the other).
    Default ``None`` keeps the original single-stream draws.
    """
    rng = np.random.default_rng(seed)
    h = min(intrinsic_dim, dim)
    concepts = rng.standard_normal((n_concepts, h)).astype(np.float32)

    # modality maps: image map A, text map = A blended with a rotation
    a_map = rng.standard_normal((h, dim)).astype(np.float32) / np.sqrt(h)
    r_mix = rng.standard_normal((h, h)).astype(np.float32) / np.sqrt(h)
    b_map = ((1.0 - modality_gap) * a_map
             + modality_gap * (r_mix @ a_map)).astype(np.float32)
    gap_dir = rng.standard_normal((1, dim)).astype(np.float32)
    gap_dir /= np.linalg.norm(gap_dir)

    # power-law concept popularity (real corpora are Zipfian)
    pop = 1.0 / np.arange(1, n_concepts + 1) ** 0.8
    pop /= pop.sum()

    def sample(n: int, query_side: bool, rng=rng) -> np.ndarray:
        ids = rng.choice(n_concepts, size=n, p=pop)
        z = concepts[ids] + rng.standard_normal((n, h)).astype(np.float32) * noise
        x = z @ (b_map if query_side else a_map)
        if query_side:
            x = x + gap_dir * (modality_gap * 2.0)
        # small ambient noise so points are not exactly on the manifold
        x = x + rng.standard_normal((n, dim)).astype(np.float32) * 0.02
        if metric in ("cosine", "ip"):
            # embeddings in these workloads are ~unit-norm (CLIP-style)
            x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        return x.astype(np.float32)

    base = sample(n_base, False)
    qrng = rng if query_seed is None else np.random.default_rng(query_seed)
    return base, sample(n_query, True, rng=qrng)


# ---------------------------------------------------------------------------
# Index-keyed device corpus. Row i is a pure function of (seed, modality, i):
# tiles can be (re)generated on the device, in any order — a streamed exact
# ground truth or int8 table needs no host copy, and "gather f32 rows" for a
# rerank becomes regeneration from ids. Same design as make_cross_modal
# (concept-mixture manifold, Zipf popularity, modality-gapped query map) with
# counter-based draws, so it is a sibling dataset family of make_cross_modal.
#
# The draws are the JAX package's: threefry2x32 keyed as ``jax.random`` keys
# it under ``jax_threefry_partitionable`` (the default since jax 0.5) —
#   root = fold_in(PRNGKey(seed), 0 | 1)      base | query side
#   k_i  = fold_in(root, i)
#   u_i  = uniform(k_i, ())                   -> concept id by the Zipf cdf
#   eps  = normal(fold_in(k_i, 1), (h + dim,))
# where PRNGKey(s) = (0, s), fold_in(k, x) = threefry(k, counter (0, x)) and
# element j of a draw is out0 ^ out1 of threefry(k, counter (0, j)). The
# uniform draws, and so the concept ids, are the same bits as JAX's; the
# normals are sqrt(2)·erfinv of the same uniforms in (-1, 1), with the erfinv
# polynomial XLA uses, and differ only in the last ulps (log1p, fused
# multiply-adds).
# ---------------------------------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate the 32 bits of an int32 tensor left by ``r`` (the arithmetic
    right shift's sign copies are masked off)."""
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _i32(v: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds, on int32 tensors holding uint32 bits
    (two's-complement adds wrap exactly like uint32 adds). ``k0`` / ``k1``
    are tensors broadcastable against the counters, or Python ints."""
    if not isinstance(k0, torch.Tensor):
        k0 = torch.tensor(_i32(k0), dtype=torch.int32, device=x0.device)
        k1 = torch.tensor(_i32(k1), dtype=torch.int32, device=x0.device)
    ks = (k0, k1, k0 ^ k1 ^ _i32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = x0 + x1
            x1 = _rotl32(x1, r) ^ x0
        x0 = x0 + ks[(g + 1) % 3]
        x1 = x1 + ks[(g + 2) % 3] + (g + 1)
    return x0, x1


def _fold_in(k0, k1, data: torch.Tensor):
    """``jax.random.fold_in``: the new key is threefry(key, (0, data))."""
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def _bits(k0: torch.Tensor, k1: torch.Tensor, count: int) -> torch.Tensor:
    """``count`` 32-bit draws per key ([T] keys -> [T, count]; count 0 is
    the scalar draw, [T]): out0 ^ out1 at counter (0, j)."""
    if count == 0:
        z = torch.zeros_like(k0)
        o0, o1 = threefry2x32(k0, k1, z, z)
        return o0 ^ o1
    j = torch.arange(count, dtype=torch.int32, device=k0.device)[None, :]
    o0, o1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(j), j)
    return o0 ^ o1


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> f32 in [0, 1): the top 23 bits become the mantissa
    of a float in [1, 2), minus 1."""
    mant = ((bits >> 9) & 0x7FFFFF) | 0x3F800000
    return mant.view(torch.float32) - 1.0


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

# Giles' single-precision erfinv ("Approximating the erfinv function",
# 2010): a polynomial in w = −log(1 − x²), one set of coefficients for the
# centre (w < 5) and one for the tails — the form XLA evaluates for f32.
# torch.erfinv is more exact near |x| = 1, where 1 − x² has already lost
# bits, and would leave the draws ~2e-5 away from the JAX package's.
_ERFINV_CENTRE = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    centre = w < 5.0
    w = torch.where(centre, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(centre, _ERFINV_CENTRE[0], _ERFINV_TAIL[0])
    for c, t in zip(_ERFINV_CENTRE[1:], _ERFINV_TAIL[1:]):
        p = torch.where(centre, c, t) + p * w
    return p * x


def _normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal``: a uniform in (-1, 1) — floats · (hi − lo) + lo
    clamped at lo, where hi − lo rounds to 2.0 in f32 — through
    sqrt(2)·erfinv."""
    u = torch.clamp(_unit_floats(bits) * 2.0 + _NORMAL_LO, min=_NORMAL_LO)
    return float(np.float32(np.sqrt(2))) * _erfinv_f32(u)


class CrossModalDeviceSpec:
    """Tiny constant tensors + a seed defining a deterministic corpus on
    ``device`` (default: the card; ``device="cpu"`` for the CPU)."""

    # rows per generation block: bounds the [rows, h + dim] draw scratch
    BLOCK = 1 << 18

    def __init__(self, dim: int, n_concepts: int = 256,
                 intrinsic_dim: int = 16, modality_gap: float = 0.35,
                 noise: float = 0.45, metric: str = "ip", seed: int = 0,
                 device: torch.device | str | None = None):
        rng = np.random.default_rng(seed)
        h = min(intrinsic_dim, dim)
        concepts = rng.standard_normal((n_concepts, h)).astype(np.float32)
        a_map = rng.standard_normal((h, dim)).astype(np.float32) / np.sqrt(h)
        r_mix = rng.standard_normal((h, h)).astype(np.float32) / np.sqrt(h)
        b_map = ((1.0 - modality_gap) * a_map
                 + modality_gap * (r_mix @ a_map)).astype(np.float32)
        gap_dir = rng.standard_normal((1, dim)).astype(np.float32)
        gap_dir /= np.linalg.norm(gap_dir)
        pop = 1.0 / np.arange(1, n_concepts + 1) ** 0.8
        cdf = np.cumsum(pop / pop.sum()).astype(np.float32)

        self.device = array_device(device)
        self.dim, self.h = dim, h
        self.n_concepts = n_concepts
        self.noise = float(noise)
        self.modality_gap = float(modality_gap)
        self.normalize = metric in ("ip", "cosine")
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        self.concepts = put(concepts)
        self.a_map = put(a_map.astype(np.float32))
        self.b_map = put(b_map)
        self.gap_dir = put(gap_dir)
        self.pop_cdf = put(cdf)
        self.seed = seed

    def _keys(self, idx: torch.Tensor, query_side: bool):
        root = _fold_in(0, self.seed, torch.tensor(
            1 if query_side else 0, dtype=torch.int32, device=self.device))
        return _fold_in(root[0], root[1], idx)

    def uniforms(self, idx, query_side: bool = False) -> torch.Tensor:
        """The per-row popularity draws u_i in [0, 1), f32 [T]."""
        k0, k1 = self._keys(self._idx(idx), query_side)
        return _unit_floats(_bits(k0, k1, 0))

    def concept_ids(self, idx, query_side: bool = False) -> torch.Tensor:
        """The concept each row is drawn around, int32 [T]."""
        u = self.uniforms(idx, query_side)
        cid = torch.searchsorted(self.pop_cdf, u)
        return torch.clamp(cid, max=self.n_concepts - 1).to(torch.int32)

    def normals(self, idx, query_side: bool = False) -> torch.Tensor:
        """The per-row normal draws, f32 [T, h + dim]."""
        k0, k1 = self._keys(self._idx(idx), query_side)
        e0, e1 = _fold_in(k0, k1, torch.ones_like(k0))
        return _normal_from_bits(_bits(e0, e1, self.h + self.dim))

    def _idx(self, idx) -> torch.Tensor:
        if not isinstance(idx, torch.Tensor):
            idx = torch.from_numpy(np.ascontiguousarray(idx))
        return idx.to(device=self.device, dtype=torch.int32).reshape(-1)

    def rows(self, idx, query_side: bool = False) -> torch.Tensor:
        """Generate rows for absolute indices ``idx`` (int [T]) -> f32
        [T, dim]. The concept ids do not depend on the batch shape; the
        rows agree across batch shapes up to the float reassociation of the
        small projection matmul (~1e-7)."""
        idx = self._idx(idx)
        if idx.shape[0] <= self.BLOCK:
            return self._rows_block(idx, bool(query_side))
        out = torch.empty((idx.shape[0], self.dim), dtype=torch.float32,
                          device=self.device)
        for s in range(0, idx.shape[0], self.BLOCK):
            out[s: s + self.BLOCK] = self._rows_block(
                idx[s: s + self.BLOCK], bool(query_side))
        return out

    def _rows_block(self, idx: torch.Tensor, query_side: bool) -> torch.Tensor:
        h = self.h
        cid = self.concept_ids(idx, query_side)
        eps = self.normals(idx, query_side)
        # an index_select of the concept table: the same f32 values the JAX
        # package's one-hot matmul picks
        z = self.concepts.index_select(0, cid.long()) + self.noise * eps[:, :h]
        x = z @ (self.b_map if query_side else self.a_map)
        if query_side:
            x = x + self.gap_dir * (self.modality_gap * 2.0)
        x = x + 0.02 * eps[:, h:]
        if self.normalize:
            x = x / torch.clamp(
                torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)
        return x

    def base_tile(self, start: int, size: int) -> torch.Tensor:
        return self.rows(start + torch.arange(size, dtype=torch.int32,
                                              device=self.device))

    def queries(self, n: int) -> torch.Tensor:
        return self.rows(torch.arange(n, dtype=torch.int32,
                                      device=self.device), query_side=True)
