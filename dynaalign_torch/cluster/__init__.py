from .louvain import louvain, modularity, LouvainResult  # noqa: F401
from .graph import (  # noqa: F401
    adjacency_from_matrix,
    quantile_threshold,
    threshold_matrix,
)
from .clusterbreak import (  # noqa: F401
    ClusterBreakResult,
    clusterbreak,
    louvain_mod,
    netcluster,
)
