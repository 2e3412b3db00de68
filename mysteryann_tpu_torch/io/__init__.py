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
from mysteryann_tpu_torch.io.datasets import (  # noqa: F401
    REGISTRY,
    DatasetSpec,
    export_fbin_from_npy,
    pool_frame_embeddings,
    pool_frame_embeddings_batch,
    prepare,
)
from mysteryann_tpu_torch.io.stream import stream_fbin, load_fbin_to_device  # noqa: F401
