"""``dynaalign_torch.similarity_nw``: exact all-pairs NW percent identity.

Work: the pairs of the upper triangle, diagonal included, that every call
aligns, n(n+1)/2.  Judged: the returned [n, n] float64 matrix, by sample
(``portbench/matrix.py``), against ``reference/nw.py``.
"""

from __future__ import annotations

import numpy as np

from .. import counts, matrix
from ..reference import nw as ref

UNIT = "pairs"
# the reference in float32, the precision below the float64 stated
CONTROLS = ("float32",)


class Entry(matrix.MatrixEntry):
    INFO = "pairs_aligned"

    def __init__(self, *args):
        super().__init__(*args)
        self._counts = {}

    def call(self, seqs):
        from dynaalign_torch import similarity_nw

        s = self.settings
        return similarity_nw(seqs, s["matrix_name"], s["gap_open"],
                             s["gap_ext"], device=self.device)

    def work(self) -> int:
        n = len(self.seqs)
        return n * (n + 1) // 2

    def bounds(self) -> dict[str, float]:
        lens = np.array([len(s) for s in self.seqs], dtype=np.float64)
        cells = (lens.sum() ** 2 + (lens ** 2).sum()) / 2
        pairs, width = self.work(), max(int(lens.max()), 1)
        nbytes = 4 * (2 * pairs * width + 4 * pairs + 32 * 32)
        return {"nw_dp": counts.nw_bound_s(cells, nbytes)}

    def values(self, rows, dtype=np.float64) -> np.ndarray:
        key = rows.tobytes()
        if key not in self._counts:
            self._counts[key] = ref.pair_counts(
                self.seqs, self.pairs[rows], self.settings, self.device)
        return ref.ratio(*self._counts[key], dtype)
