"""Pipeline steps built on the similarity entry points.

This slice ports the exact rescoring step of the hybrid pipelines,
:func:`nw_rescore_pairs` (the JAX package's ``models/pipeline.py``): its
result, not its TPU batching.  The pairs stream through the same launches
as ``similarity_nw``, so each batch goes to the kernel its padded width
needs, at any length.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import blosum
from ..api import DEFAULT_CHUNK, _pairs_nw, _ratio, _resolve_device
from ..encode import encode


def nw_rescore_pairs(
    sequences: Sequence[str],
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    *,
    matrix_name: str = "BLOSUM62",
    gap_open: int = 10,
    gap_ext: int = 4,
    device=None,
    chunk: int | None = None,
) -> np.ndarray:
    """Exact NW percent identity of each pair (sequences[pair_i[k]],
    sequences[pair_j[k]]), the first as the reference's sequence 1:
    float64 [len(pair_i)].  Runs on ``device`` as ``similarity_nw`` does.
    """
    pi = np.asarray(pair_i, dtype=np.int64).reshape(-1)
    pj = np.asarray(pair_j, dtype=np.int64).reshape(-1)
    if pi.shape != pj.shape:
        raise ValueError(
            f"pair_i and pair_j differ in length: {pi.size} and {pj.size}"
        )
    dev = _resolve_device(device)
    sub = blosum.get_matrix(matrix_name, device=dev)
    enc = encode(sequences)
    n = len(enc.lengths)
    if pi.size == 0:
        return np.zeros(0, dtype=np.float64)
    if min(pi.min(), pj.min()) < 0 or max(pi.max(), pj.max()) >= n:
        raise IndexError(f"pair indices must lie in [0, {n})")
    idx = torch.from_numpy(enc.indices).to(dev)
    lens = torch.from_numpy(enc.lengths).to(dev)
    mt, ln = _pairs_nw(idx, lens, idx, lens, torch.from_numpy(pi).to(dev),
                       torch.from_numpy(pj).to(dev), sub, gap_open, gap_ext,
                       chunk or DEFAULT_CHUNK)
    return _ratio(mt, ln)
