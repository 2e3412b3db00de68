"""mysteryann_tpu_torch — the PyTorch + CUDA port of mysteryann_tpu.

A second package beside the JAX one, for an NVIDIA H100. It mirrors the
JAX package's module paths and public names; the JAX package stays the
reference, and tests hold each ported module against it on the same
inputs. This package imports torch, numpy and the standard library only —
never jax, and nothing of ``mysteryann_tpu``.

Ported so far:

- the RoarGraph build-then-search path — ``make_cross_modal`` →
  ``exact_knn`` → ``build_roargraph`` (classic or fused phase-D engine;
  "auto" picks as the JAX package does) → ``RoarGraphIndex.save``/``load``
  → ``Searcher.search`` or seeded ``FusedSearcher.search`` (quantized
  neighbour blocks inline in one byte row per node) → ``compute_recall``;
- flat serving — ``FlatIndex`` in f32, bf16, int8 and scan precision, with
  the int8 kNN scans and an exact f32 rerank;
- ``io.formats`` (fbin / ibin / ground-truth files) and the CLIs
  ``compute_gt``, ``build_roargraph``, ``search_roargraph`` (classic and
  fused engines) and ``search_flat``, run as ``python -m
  mysteryann_tpu_torch.cli.<name>``.

Two hand-written CUDA kernels carry these paths, each built with nvcc at
first use on a CUDA device: the row gather (``ops.gather``, source
``csrc/gather.cu``) for every row fetch — the fused engine's byte rows
included — and the binned scan (``ops.scan``,
``csrc/scan.cu``) for ``FlatIndex(precision="scan")``. ROADMAP.md lists
what is still to come.
"""

__version__ = "0.1.0"

from mysteryann_tpu_torch.utils.params import BuildConfig, SearchConfig, Parameters  # noqa: F401
from mysteryann_tpu_torch.utils.timers import Timer  # noqa: F401
from mysteryann_tpu_torch.utils.metrics import compute_recall, compute_rderr  # noqa: F401
from mysteryann_tpu_torch.index import index_kinds, get_index_cls, register_index  # noqa: F401
from mysteryann_tpu_torch.ops.distances import (  # noqa: F401
    Metric,
    pairwise_dist,
    point_dist,
    normalize_rows,
    squared_norms,
    prepare_vectors,
)
from mysteryann_tpu_torch.ops.gather import gather_rows, gather_rows_any  # noqa: F401
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
from mysteryann_tpu_torch.graph.adjacency import PaddedGraph, from_lists, to_lists  # noqa: F401
from mysteryann_tpu_torch.graph.prune import batched_occlusion_prune, dists_to_src  # noqa: F401
from mysteryann_tpu_torch.graph.roargraph import (  # noqa: F401
    RoarGraphIndex,
    build_roargraph,
    compute_medoid,
    save_projection_graph,
    load_projection_graph,
)
from mysteryann_tpu_torch.search.beam import beam_search, search_batched, SearchResult  # noqa: F401
from mysteryann_tpu_torch.search.searcher import Searcher  # noqa: F401
from mysteryann_tpu_torch.search.fused import FusedSearcher, pack_neighbor_table  # noqa: F401
from mysteryann_tpu_torch.io.synthetic import make_cross_modal  # noqa: F401
from mysteryann_tpu_torch.io.formats import (  # noqa: F401
    read_fbin,
    read_ibin,
    write_fbin,
    write_ibin,
    read_gt_with_dist,
    write_gt_with_dist,
)
from mysteryann_tpu_torch.flat import FlatIndex  # noqa: F401
