"""dynaalign_torch — the PyTorch/CUDA port of the JAX package.

Exact Needleman–Wunsch percent identity (Gotoh affine gaps, BLOSUM scoring,
greedy-traceback match count), all pairs or an explicit pair list, on an
NVIDIA Hopper card through hand-written CUDA kernels (``csrc/nw_gotoh.cu``,
one thread per pair, and ``csrc/nw_gotoh_xl.cu``, one warp per pair for
long sequences, at any length), with a plain PyTorch version of the same
function for the CPU.  Outputs equal the JAX package's and the C++
oracle's element for element.

This package imports neither JAX nor the JAX package.
"""

from .api import similarity_nw, similarity_nw_bucketed  # noqa: F401
from .blosum import MATRIX_NAMES, get_matrix  # noqa: F401
from .encode import encode  # noqa: F401
from .models import nw_rescore_pairs  # noqa: F401

__version__ = "0.1.0"
