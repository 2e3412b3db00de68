from mysteryann_tpu_torch.io.formats import (  # noqa: F401
    read_fbin,
    read_ibin,
    write_fbin,
    write_ibin,
    read_meta,
    read_gt_with_dist,
    write_gt_with_dist,
    read_knn_ibin,
    write_knn_ibin,
    data_align,
)
from mysteryann_tpu_torch.io.synthetic import make_cross_modal  # noqa: F401
