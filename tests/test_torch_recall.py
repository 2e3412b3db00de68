"""Port build-then-search recall against the JAX package's on
make_cross_modal data, at the sizes of tests/test_roargraph_build.py (classic
phase-D engine). Each package runs its own chain — exact kNN, build,
Searcher — and the port's recall@10 at L=64 must be within 0.01 of the JAX
package's: float32 sums in another order may move single edges, not the
quality of the graph.
"""

import numpy as np
import pytest
import torch

from mysteryann_tpu.graph import build_roargraph as j_build
from mysteryann_tpu.io import make_cross_modal
from mysteryann_tpu.ops import exact_knn as j_knn
from mysteryann_tpu.search import Searcher as JSearcher
from mysteryann_tpu.utils.metrics import compute_recall
from mysteryann_tpu.utils.params import BuildConfig as JConfig
import mysteryann_tpu_torch as port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test processes run side by side (pytest-xdist); torch's own thread
    pool on top of them oversubscribes the cores, and its parallel ops then
    wait on each other. These tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_recall_within_001_of_jax():
    base, train_q = make_cross_modal(4000, 1500, 48, metric="ip", seed=11)
    _, eval_q = make_cross_modal(10, 300, 48, metric="ip", seed=99)
    kw = dict(M_sq=32, M_pjbp=12, L_pjpq=64, metric="ip", query_batch=512,
              search_batch=512, connectivity_engine="classic")
    _, gt = j_knn(eval_q, base, k=10, metric="ip", precision="highest")

    _, j_train_knn = j_knn(train_q, base, k=32, metric="ip",
                           precision="highest")
    j_index = j_build(base, train_q, j_train_knn, JConfig(**kw),
                      verbose=False)
    j_ids, *_ = JSearcher(j_index, base).search(eval_q, k=10, L=64,
                                                query_batch=300)

    _, t_train_knn = port.exact_knn(train_q, base, k=32, metric="ip",
                                    device="cpu")
    t_index = port.build_roargraph(base, train_q, t_train_knn,
                                   port.BuildConfig(**kw), verbose=False,
                                   device="cpu")
    t_index.graph.validate()
    assert t_index.graph.degree_stats()["zero"] == 0
    t_ids, *_ = port.Searcher(t_index, base, device="cpu").search(
        eval_q, k=10, L=64, query_batch=300)

    j_rec = compute_recall(j_ids, gt, 10)
    t_rec = port.compute_recall(t_ids, gt, 10)
    assert abs(t_rec - j_rec) <= 0.01, (t_rec, j_rec)
    assert t_rec > 0.85, t_rec
    assert np.array_equal(port.compute_recall(t_ids, gt, 10),
                          compute_recall(t_ids, gt, 10))
