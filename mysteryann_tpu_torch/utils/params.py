"""Configuration objects (host copy of ``mysteryann_tpu/utils/params.py``).

The reference carries a string-keyed ``Parameters`` map (re-parsed with
``Get<uint32_t>("M_pjbp")`` at every use site — reference
include/efanna2e/parameters.h:15-57). We keep typed dataclasses as the real
API and provide a `Parameters` compatibility shim with the same
Set/Get semantics for users migrating driver scripts.

Parameter vocabulary (same names as the reference CLIs,
reference tests/test_build_roargraph.cpp:34-68):

- ``M_sq``   : training-query kNN list truncation length (a.k.a. Nq)
- ``M_pjbp`` : projection-graph degree bound M
- ``L_pjpq`` : build-time search queue length L
- ``L_pq``   : query-time search queue length
- ``M_bp``   : bipartite base-side degree bound (bipartite variant)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """RoarGraph build hyper-parameters (reference run_roargraph_test.sh:5-10)."""

    M_sq: int = 100          # truncate each training query's kNN list to this
    M_pjbp: int = 35         # projection graph degree bound
    L_pjpq: int = 500        # connectivity-pass search queue length
    metric: str = "ip"       # {"l2", "ip", "cosine"}
    # device batching knobs (no reference analogue — OpenMP picked thread
    # counts)
    query_batch: int = 8192      # phase-A queries pruned per device batch
    search_batch: int = 1024     # phase-D nodes searched per device batch
    connectivity_iters: int = 0  # 0 = auto (fixed 16 rounds)
    # phase-D search engine: "fused" packs the live supply graph into
    # int8 neighbor-block byte rows each round; "classic" traverses f32
    # vectors directly (no table memory). "auto" picks fused when the
    # packed table fits the JAX package's 10 GB table budget (the same
    # rule in both packages).
    connectivity_engine: str = "auto"
    # phase-D throughput knobs:
    # - connectivity_expand: closest-unexpanded pops per traversal step
    #   (search/fused.py ``expand``; honored by BOTH engines — the
    #   classic beam accepts the same knob). Total pops stay ~L_pjpq, so
    #   the DMA bytes are unchanged, but per-step fixed costs (pool
    #   merge, loop overhead) amortize over `expand` expansions — the
    #   phase-D search time lever. Traversal order differs slightly from
    #   expand=1 (the 2nd pop in a step ignores the 1st pop's results),
    #   like the reference's OpenMP interleaving, so expand changes the
    #   built graph under either engine; the prune still sees the same
    #   kind of expansion history.
    # - connectivity_bits: traversal-row quantization for the repacked
    #   supply table (8 = int8, 4 = packed int4 — half the per-expansion
    #   row bytes and half the table memory). Fused-only: the classic
    #   engine has no packed table. The prune recomputes exact f32
    #   distances over the collected pool either way, so row bits
    #   affect traversal order only.
    connectivity_expand: int = 1
    connectivity_bits: int = 8
    # phase-D entry-point seeding (fused engine): each node's search
    # starts from its top-`connectivity_seeds` neighbors in a strided
    # 1-in-`connectivity_seed_sample` bf16 sample scan of the base
    # (search/seeding.py) instead of walking from the medoid — the walk
    # skips the ~40-hop navigation prefix, cutting phase-D search time.
    # The expansion pool then holds mostly near-field nodes; the medoid
    # walk's far-field expansions (whose long-range edges the occlusion
    # prune keeps for navigability) are still represented because the
    # seed list spans the whole sample stride. 0 = medoid walk
    # (reference behavior, src/index_bipartite.cpp:1310-1316).
    connectivity_seeds: int = 0
    connectivity_seed_sample: int = 4
    # number of full phase-D sweeps. The reference does exactly one; a
    # second pass re-searches every node over the COMPLETED graph (the
    # densest, best-navigable state) and merges novel edges under the
    # same 2*M_pjbp degree bound — a beyond-reference quality knob that
    # costs one extra phase-D of build time.
    connectivity_passes: int = 1
    # rounds for passes >= 2 (0 = auto: max(2, first-pass rounds / 4)).
    # Pass 1's incremental rounds bootstrap a sparse post-projection
    # graph (each chunk's searches see earlier chunks' edges); by pass 2
    # the graph is converged, so the intra-pass incremental effect is
    # marginal — fewer rounds buy the same quality for a fraction of the
    # per-round fold/pack cost.
    connectivity_iters_later: int = 0
    # phase-D expansion-history length, as a multiple of L_pjpq. The
    # reference's full_retset is unbounded (every expanded node,
    # src/index_bipartite.cpp:1318); 3x captures nearly all expansions
    # at typical hop counts — raise if build hops routinely exceed it.
    history_mult: int = 3
    seed: int = 0

    def __post_init__(self):
        if self.metric not in ("l2", "ip", "cosine"):
            raise ValueError(f"unknown metric {self.metric!r}")
        if self.connectivity_engine not in ("auto", "fused", "classic"):
            raise ValueError(
                f"unknown connectivity_engine {self.connectivity_engine!r}")
        if self.connectivity_bits not in (8, 4):
            raise ValueError(
                f"connectivity_bits must be 8 or 4, got "
                f"{self.connectivity_bits}")
        if self.connectivity_expand < 1:
            raise ValueError(
                f"connectivity_expand must be >= 1, got "
                f"{self.connectivity_expand}")
        if self.connectivity_iters_later < 0:
            raise ValueError(
                f"connectivity_iters_later must be >= 0, got "
                f"{self.connectivity_iters_later}")
        if self.connectivity_seeds < 0:
            raise ValueError(
                f"connectivity_seeds must be >= 0, got "
                f"{self.connectivity_seeds}")
        if self.connectivity_seeds and self.connectivity_seeds > self.L_pjpq:
            raise ValueError(
                f"connectivity_seeds ({self.connectivity_seeds}) must be "
                f"<= L_pjpq ({self.L_pjpq})")
        if self.connectivity_seed_sample < 1:
            raise ValueError(
                f"connectivity_seed_sample must be >= 1, got "
                f"{self.connectivity_seed_sample}")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Query-time knobs (reference run_roargraph_search_test.sh:1-15)."""

    k: int = 10
    L_pq: int = 100          # beam / candidate pool length
    metric: str = "ip"
    query_batch: int = 1024  # queries traversed in lockstep per device call
    max_hops: int = 0        # 0 = auto cap derived from L_pq

    def __post_init__(self):
        if self.L_pq < self.k:
            raise ValueError(f"L_pq ({self.L_pq}) must be >= k ({self.k})")


class Parameters:
    """String-map compatibility shim mirroring efanna2e::Parameters.

    Values are stored as-is and coerced on Get, mirroring the reference's
    stringify-on-Set / parse-on-Get behavior (parameters.h:17-41). Raises
    KeyError on missing keys like the reference throws.
    """

    def __init__(self, **kwargs: Any):
        self._params: Dict[str, Any] = dict(kwargs)

    def set(self, name: str, value: Any) -> None:
        self._params[name] = value

    # C++-style aliases
    Set = set

    def get(self, name: str, ty: type = int) -> Any:
        if name not in self._params:
            raise KeyError(f"Parameter '{name}' not set")
        return ty(self._params[name])

    Get = get

    @staticmethod
    def _coerce(cls, kw_src: Dict[str, Any]) -> Dict[str, Any]:
        # coerce by the dataclass field's declared type (string knobs like
        # metric / connectivity_engine must not go through int())
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in kw_src:
                v = kw_src[f.name]
                kw[f.name] = str(v) if f.type in ("str", str) else int(v)
        return kw

    def to_build_config(self) -> BuildConfig:
        return BuildConfig(**self._coerce(BuildConfig, self._params))

    def to_search_config(self) -> SearchConfig:
        return SearchConfig(**self._coerce(SearchConfig, self._params))
