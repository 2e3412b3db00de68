from mysteryann_tpu_torch.ops.distances import (  # noqa: F401
    Metric,
    pairwise_dist,
    point_dist,
    normalize_rows,
    squared_norms,
    prepare_vectors,
)
from mysteryann_tpu_torch.ops.gather import gather_rows, gather_rows_any, gather_rows_ref  # noqa: F401
from mysteryann_tpu_torch.ops.knn import (  # noqa: F401
    exact_knn,
    exact_knn_device,
    compute_ground_truth,
    quantize_rows_int8,
    quantize_global_int8,
    int8_global_knn_device,
    int8_knn_device,
)
from mysteryann_tpu_torch.ops.scan import binned_scan, flat_scan_topk, make_scan_table  # noqa: F401
