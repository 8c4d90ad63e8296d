"""BLOSUM substitution matrices as int32 tensors.

The six standard BLOSUM tables (45/50/62/80/90/100; Henikoff & Henikoff
1992) over the 24-symbol alphabet of :mod:`dynaalign_torch.encode`.  Values
match the reference's hardcoded tables (src/pairwiseSeqAlign.cpp:23-186)
and are bundled as ``_blosum_tables.npz``.

``get_matrix`` mirrors the reference's ``getSubstitutionMatrix`` dispatch
(src/pairwiseSeqAlign.cpp:190-206): all six names are valid, unknown names
raise.  Tables come padded to 32x32 (zero rows/columns cover PAD_ID), so an
alphabet index times 32 plus another addresses one entry.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .encode import ALPHABET_SIZE

_NPZ = os.path.join(os.path.dirname(__file__), "_blosum_tables.npz")

MATRIX_NAMES = (
    "BLOSUM45",
    "BLOSUM50",
    "BLOSUM62",
    "BLOSUM80",
    "BLOSUM90",
    "BLOSUM100",
)

PADDED_SIZE = 32  # next power of two above 24; PAD_ID rows are zero


@functools.cache
def _tables() -> dict[str, np.ndarray]:
    with np.load(_NPZ) as z:
        return {k: z[k].astype(np.int32) for k in z.files}


def get_matrix(
    name: str = "BLOSUM62", *, padded: bool = True, device="cpu"
) -> torch.Tensor:
    """Return a BLOSUM table by name as an int32 tensor on ``device``.

    Args:
      name: one of MATRIX_NAMES.
      padded: if True (default) a [32, 32] table with the 24x24 one in the
        top-left corner and zeros elsewhere; otherwise the raw [24, 24].

    Raises:
      ValueError: for unknown names (reference ``Rcpp::stop`` at :204).
    """
    tables = _tables()
    if name not in tables:
        raise ValueError(f"Invalid substitution matrix name: {name}")
    mat = tables[name]
    if padded:
        out = np.zeros((PADDED_SIZE, PADDED_SIZE), dtype=np.int32)
        out[:ALPHABET_SIZE, :ALPHABET_SIZE] = mat
        mat = out
    return from_numpy(mat, device)


def from_numpy(sub_np: np.ndarray, device="cpu") -> torch.Tensor:
    """An integer substitution table (e.g. [32, 32]) as an int32 tensor."""
    arr = np.ascontiguousarray(sub_np, dtype=np.int32)
    return torch.tensor(arr, dtype=torch.int32, device=device)
