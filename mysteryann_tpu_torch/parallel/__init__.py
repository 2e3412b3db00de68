from mysteryann_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_gather,
    gather_dp,
    init_distributed,
    make_mesh,
    make_mesh_distributed,
    psum,
    replicate,
    shard_base,
)
from mysteryann_tpu_torch.parallel.sharded_knn import sharded_exact_knn  # noqa: F401
from mysteryann_tpu_torch.parallel.sharded_search import (  # noqa: F401
    distributed_beam_search,
    query_parallel_search,
)
from mysteryann_tpu_torch.parallel.sharded_ivf import ShardedIVF  # noqa: F401
from mysteryann_tpu_torch.parallel.sharded_build import (  # noqa: F401
    scatter_rows_sharded,
    sharded_build_roargraph,
    sharded_prune_rows,
    take_rows_sharded,
)
from mysteryann_tpu_torch.parallel.sharded_fused import (  # noqa: F401
    ShardedFusedSearcher,
)
