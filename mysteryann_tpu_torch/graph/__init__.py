from mysteryann_tpu_torch.graph.adjacency import PaddedGraph, from_lists, to_lists  # noqa: F401
from mysteryann_tpu_torch.graph.prune import batched_occlusion_prune, dists_to_src  # noqa: F401
from mysteryann_tpu_torch.graph.bipartite import (  # noqa: F401
    BipartiteIndex,
    BipartiteSearcher,
    build_bipartite,
)
from mysteryann_tpu_torch.graph.roargraph import (  # noqa: F401
    RoarGraphIndex,
    build_roargraph,
    compute_medoid,
    save_projection_graph,
    load_projection_graph,
    load_nsg_graph,
)
