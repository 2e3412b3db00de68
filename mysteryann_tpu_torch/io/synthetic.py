"""Synthetic cross-modal dataset generator (numpy copy of
``mysteryann_tpu/io/synthetic.make_cross_modal``: same draws, so the data is
bit-identical to the JAX package's).

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
