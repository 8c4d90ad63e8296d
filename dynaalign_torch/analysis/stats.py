"""Similarity-matrix statistics (reference compute_similarity_stats,
R/similarity.R:11-34)."""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np


@dataclasses.dataclass
class SimilarityStats:
    """S3-class "similarity_stats" equivalent (R/similarity.R:32)."""

    mean_similarity: float
    median_similarity: float
    min_similarity: float
    max_similarity: float
    most_similar_pair: tuple[int, int]
    least_similar_pair: tuple[int, int]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (
            "similarity_stats("
            f"mean={self.mean_similarity:.4f}, "
            f"median={self.median_similarity:.4f}, "
            f"min={self.min_similarity:.4f}, "
            f"max={self.max_similarity:.4f}, "
            f"most_similar={self.most_similar_pair}, "
            f"least_similar={self.least_similar_pair})"
        )


def compute_similarity_stats(x: np.ndarray) -> SimilarityStats:
    """Summary stats over the strict upper triangle of a similarity matrix.

    Pair indices are 1-based (row, col) like the reference's
    ``which(..., arr.ind=TRUE)[1,]`` — the first matrix cell (column-major,
    as R scans) equal to the extreme value.
    """
    x = np.asarray(x)
    if x.ndim != 2:
        raise ValueError("Input must be a matrix")
    if x.shape[0] != x.shape[1] or not np.allclose(x, x.T, equal_nan=True):
        warnings.warn(
            "Input matrix is not symmetric. Results may be unexpected."
        )
    iu = np.triu_indices(x.shape[0], k=1)
    vals = x[iu]
    vmax = vals.max()
    vmin = vals.min()

    def first_colmajor(value) -> tuple[int, int]:
        # R scans column-major for which(); mimic with Fortran order
        flat = np.argmax((x == value).ravel(order="F"))
        r = flat % x.shape[0]
        c = flat // x.shape[0]
        return (int(r) + 1, int(c) + 1)

    return SimilarityStats(
        mean_similarity=float(vals.mean()),
        median_similarity=float(np.median(vals)),
        min_similarity=float(vmin),
        max_similarity=float(vmax),
        most_similar_pair=first_colmajor(vmax),
        least_similar_pair=first_colmajor(vmin),
    )
