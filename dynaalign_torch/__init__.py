"""dynaalign_torch — the PyTorch/CUDA port of the JAX package.

Peptide and protein similarity and clustering on an NVIDIA Hopper card:

* exact Needleman–Wunsch percent identity (Gotoh affine gaps, BLOSUM
  scoring, greedy-traceback match count), all pairs or an explicit pair
  list, through hand-written CUDA kernels (``csrc/nw_gotoh.cu``, a group of
  lanes per pair with the DP state in registers, and
  ``csrc/nw_gotoh_xl.cu``, one warp per pair for long sequences, at any
  length), with a plain PyTorch version of the same function for the CPU;
* MinHash similarity (seeded murmur3 signatures, all-pairs agreement) and
  the top-k neighbour graph, as PyTorch tensor code on the card;
* Louvain, ``netcluster`` and the recursive ``clusterbreak`` on the host;
* the hybrid pipelines: a MinHash prefilter, dense or top-k, whose
  surviving pairs are rescored exactly by the NW kernels;
* progressive MSA and IUPAC consensus per cluster on the host
  (``cluster_consensus``, on the native row DP of ``cpp/msa_dp.cpp``), and
  the ``Pipeline`` that chains similarity → clusterbreak → consensus;
* a command-line interface, ``python -m dynaalign_torch …``.

The root has every public name of the JAX package's root: ``encode`` is the
encoding module, ``encode_sequences`` its function.  ``parallel`` runs the
all-pairs work across processes joined by ``torch.distributed``.

Outputs equal the JAX package's and the C++ oracle's element for element.
Every entry point takes ``device=None``, which means the card and raises
without one; ``device="cpu"`` runs on the host.

This package imports neither JAX nor the JAX package.
"""

from . import blosum, encode  # noqa: F401
from .encode import EncodedSeqs, encode as encode_sequences  # noqa: F401

__version__ = "0.1.0"

from .api import (  # noqa: F401,E402
    MinHashEngine,
    similarity_mh,
    similarity_nw,
    similarity_nw_bucketed,
)
from .blosum import MATRIX_NAMES, get_matrix  # noqa: F401,E402
from .cluster import (  # noqa: F401,E402
    ClusterBreakResult,
    clusterbreak,
    louvain,
    louvain_mod,
    netcluster,
)
from .consensus import (  # noqa: F401,E402
    cluster_consensus,
    consensus_sequence,
    progressive_msa,
)
from .analysis import (  # noqa: F401,E402
    compute_similarity_stats,
    consensus_plot,
    plot_similarity_matrix,
)
from .models import (  # noqa: F401,E402
    Pipeline,
    PipelineResult,
    cluster_large_exact,
    minhash,
    nw_rescore_pairs,
    shingle,
    similarity_hybrid,
    similarity_hybrid_sparse,
)
from .ops.topk_graph import cluster_large  # noqa: F401,E402
