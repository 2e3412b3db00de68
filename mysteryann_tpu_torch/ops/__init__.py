from mysteryann_tpu_torch.ops.distances import (  # noqa: F401
    Metric,
    pairwise_dist,
    point_dist,
    normalize_rows,
    squared_norms,
    prepare_vectors,
)
from mysteryann_tpu_torch.ops.gather import gather_rows, gather_rows_any, gather_rows_ref  # noqa: F401
from mysteryann_tpu_torch.ops.knn import exact_knn, exact_knn_device, compute_ground_truth  # noqa: F401
