from .msa import nw_align_pair, progressive_msa  # noqa: F401
from .consensus import cluster_consensus, consensus_sequence  # noqa: F401
