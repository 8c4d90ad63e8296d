from . import reference_r  # noqa: F401
from .pipeline import (  # noqa: F401
    Pipeline,
    PipelineResult,
    cluster_large_exact,
    hybrid_topk_edges,
    nw_rescore_pairs,
    similarity_hybrid,
    similarity_hybrid_sparse,
)
from .reference_r import (  # noqa: F401
    apply_hash,
    compute_distance_matrix,
    compute_signature_matrix,
    create_char_matrix,
    create_hash_parameters,
    create_vocab,
    minhash,
    shingle,
)
