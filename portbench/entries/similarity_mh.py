"""``dynaalign_torch.similarity_mh``: the all-pairs MinHash matrix.

Work: n(n-1)/2 pairs a call (the off-diagonal upper triangle, as the
upstream's pair loop counts them).  Judged: the returned [n, n] float64
matrix, by sample (``portbench/matrix.py``), against
``reference/minhash.py``.
"""

from __future__ import annotations

import numpy as np

from .. import counts, matrix
from ..reference import minhash as ref

UNIT = "pairs"
# the reference in float32, the precision below the float64 stated
CONTROLS = ("float32",)


class Entry(matrix.MatrixEntry):
    INFO = "pairs_counted"

    def __init__(self, *args):
        super().__init__(*args)
        self._agree = None

    def call(self, seqs):
        from dynaalign_torch import similarity_mh

        s = self.settings
        return similarity_mh(seqs, s["k"], s["n_hash"], seed=s["seed"],
                             device=self.device)

    def work(self) -> int:
        n = len(self.seqs)
        return n * (n - 1) // 2

    def bounds(self) -> dict[str, float]:
        s, n = self.settings, len(self.seqs)
        k, h = s["k"], s["n_hash"]
        lens = np.array([len(x) for x in self.seqs], dtype=np.int64)
        windows = int(np.maximum(lens - k + 1, 0).sum())
        sig = counts.signature_bound_s(
            windows, h, k, lens.sum() + 4 * n + 4 * n * h)
        pairs = self.work()
        agree = counts.compare_bound_s(pairs, h, 4 * n * h + 4 * pairs)
        return {"compare": sig + agree}

    def values(self, rows, dtype=np.float64) -> np.ndarray:
        s = self.settings
        if self._agree is None:
            sigs = ref.signatures(self.seqs, s["k"], s["n_hash"], s["seed"],
                                  self.device)
            self._agree = ref.pair_agreements(sigs, self.pairs)
            del sigs
        return ref.similarity(self._agree[rows], self.pairs[rows],
                              s["n_hash"], dtype)
