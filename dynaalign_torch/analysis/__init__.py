from .stats import SimilarityStats, compute_similarity_stats  # noqa: F401
from .plotting import consensus_plot, plot_similarity_matrix  # noqa: F401
