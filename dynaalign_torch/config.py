"""Dataclass configuration mirroring the reference's function defaults.

The reference has no config system — configuration is function defaults
(R/RcppExports.R:15,34; R/clusterbreak.R:180-188) plus closure injection
of ``sim_fn`` / ``cluster_fn``.  These dataclasses carry the same
defaults; the closure-injection extension point is preserved as
first-class arguments of :func:`dynaalign_torch.cluster.clusterbreak`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MinHashConfig:
    """similarityMH defaults (R/RcppExports.R:15-17)."""

    k: int = 4
    n_hash: int = 50
    seed: int = 0  # reference is unseeded/nondeterministic (src/minHash.cpp:73)


@dataclasses.dataclass(frozen=True)
class NWConfig:
    """similarityNW defaults (R/RcppExports.R:34-36)."""

    matrix_name: str = "BLOSUM62"
    gap_open: int = 10
    gap_ext: int = 4


@dataclasses.dataclass(frozen=True)
class ClusterBreakConfig:
    """clusterbreak defaults (R/clusterbreak.R:180-188)."""

    thresh_p: float = 0.8
    size_max: int = 10
    size_min: int = 3
    max_itr: int = 10000
    resolution: float = 1.05  # Louvain resolution (R/clusterbreak.R:115)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    """clusterconsensus equivalents (DECIPHER defaults documented in
    consensus/consensus.py)."""

    matrix_name: str = "BLOSUM62"
    threshold: float = 0.05


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """MH prefilter + NW rescoring (the viral-panel hybrid config,
    BASELINE.md config 4): pairs at or above the MH quantile threshold
    are rescored exactly with NW; the rest stay 0.

    ``prefilter_threshold`` (absolute MH similarity) bypasses the
    quantile when set — the knob shared with the sparse path
    (models.similarity_hybrid_sparse); ``top_k`` only applies there."""

    prefilter_quantile: float = 0.8
    prefilter_threshold: float | None = None
    top_k: int = 64


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    minhash: MinHashConfig = MinHashConfig()
    nw: NWConfig = NWConfig()
    clusterbreak: ClusterBreakConfig = ClusterBreakConfig()
    consensus: ConsensusConfig = ConsensusConfig()
    hybrid: HybridConfig = HybridConfig()
    similarity: str = "mh"  # "mh" | "nw" | "hybrid"
