"""Index registry + protocol — the framework's counterpart of the
reference's `efanna2e::Index` base class (reference
include/efanna2e/index.h:19-69, src/index.cpp:8-27).

The reference base class does three things: declares the abstract
Build/Search/Save/Load surface, dispatches Metric→Distance (index.cpp:
11-25 — L2→DistanceL2, COSINE/INNER_PRODUCT→DistanceInnerProduct), and
holds the vector data pointers. Here the metric dispatch lives in
`ops.distances.Metric`/`prepare_vectors` (cosine = normalize-then-IP,
exactly the reference's convention), and the surface splits in two —
index DATA (host/device tensors + save/load) is separate from the SEARCH
engine bound to it. Port of ``mysteryann_tpu/index.py``. Registered:
``roargraph`` and ``flat``; the kinds not yet ported (bipartite, ivf)
are not registered here:

| reference                  | here                                      |
|----------------------------|-------------------------------------------|
| IndexBipartite::BuildRoarGraph | graph.build_roargraph → RoarGraphIndex |
| Save/LoadProjectionGraph   | RoarGraphIndex.save/.load                 |
| SearchRoarGraph            | search.Searcher / search.FusedSearcher    |
| (no counterpart)           | flat.FlatIndex (exact scan serving)       |

This module's registry maps a string kind → container class, used by
CLIs and tooling to resolve an index by name.
"""

from __future__ import annotations

from typing import Dict, Tuple, Type


_REGISTRY: Dict[str, Type] = {}


def register_index(kind: str):
    """Class decorator: register an index container under `kind`.

    A registered class carries `metric` and `dim` attributes; containers
    with persistence expose `save(path)` / classmethod `load(path)`;
    self-serving indexes (flat, ivf) expose `search(queries, k, ...)`
    returning (ids [Q, k] i32, dists [Q, k] f32[, ...]) in the
    reference's smaller-is-better convention (IP negated,
    reference distance.h:223).
    """
    def deco(cls):
        _REGISTRY[kind] = cls
        cls.index_kind = kind
        return cls
    return deco


def index_kinds() -> Tuple[str, ...]:
    _ensure_registered()
    return tuple(sorted(_REGISTRY))


def get_index_cls(kind: str) -> Type:
    _ensure_registered()
    if kind not in _REGISTRY:
        raise ValueError(f"unknown index kind {kind!r}; have "
                         f"{tuple(sorted(_REGISTRY))}")
    return _REGISTRY[kind]


def _ensure_registered() -> None:
    # import sites apply the decorators
    import mysteryann_tpu_torch.graph.roargraph  # noqa: F401
    import mysteryann_tpu_torch.flat  # noqa: F401
