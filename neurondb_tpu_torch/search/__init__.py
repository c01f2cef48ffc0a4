"""Search orchestration: BM25, hybrid fusion, sparse retrieval, the
planner and the rerankers."""

from neurondb_tpu_torch.search.bm25 import BM25Index  # noqa: F401
from neurondb_tpu_torch.search.hybrid import (  # noqa: F401
    HybridSearcher,
    faceted_vector_search,
    hybrid_search,
    mmr_diverse_search,
    reciprocal_rank_fusion,
    temporal_vector_search,
)
