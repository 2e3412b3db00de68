"""Twin of tests/test_reachability.py through the port: phase E leaves
every node reachable from the entry point and none with in-degree zero,
on the same sparse-training world (4,000 x 32, 400 train queries)."""

import numpy as np

from mysteryann_tpu_torch.graph import build_roargraph
from mysteryann_tpu_torch.io import make_cross_modal
from mysteryann_tpu_torch.ops import exact_knn
from mysteryann_tpu_torch.utils.params import BuildConfig


def _reachable_count(graph, ep):
    n = graph.n_nodes
    seen = np.zeros(n, bool)
    seen[ep] = True
    frontier = np.array([ep])
    while frontier.size:
        nxt = graph.neighbors[frontier]
        nxt = np.unique(nxt[nxt < n])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return int(seen.sum())


def test_full_reachability_sparse_training():
    # deliberately sparse training coverage (Nq << N) on clustered data:
    # the regime that strands tail nodes without phase E
    base, train_q = make_cross_modal(4000, 400, 32, metric="ip", seed=61)
    _, knn = exact_knn(train_q, base, k=16, metric="ip", precision="highest",
                       device="cpu")
    cfg = BuildConfig(M_sq=16, M_pjbp=8, L_pjpq=32, metric="ip",
                      query_batch=512, search_batch=512,
                      connectivity_iters=4)
    idx = build_roargraph(base, train_q, knn, cfg, verbose=False,
                          device="cpu")
    assert _reachable_count(idx.graph, idx.graph.ep) == 4000
    # and in-degree zero nowhere
    nb = np.asarray(idx.graph.neighbors)
    indeg = np.bincount(nb[nb < 4000], minlength=4000)
    assert (indeg == 0).sum() == 0
