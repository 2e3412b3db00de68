from mysteryann_tpu_torch.search.beam import beam_search, search_batched, SearchResult  # noqa: F401
from mysteryann_tpu_torch.search.searcher import Searcher  # noqa: F401
from mysteryann_tpu_torch.search.fused import FusedSearcher, pack_neighbor_table  # noqa: F401
