from .pipeline import (  # noqa: F401
    cluster_large_exact,
    hybrid_topk_edges,
    nw_rescore_pairs,
    similarity_hybrid,
    similarity_hybrid_sparse,
)
