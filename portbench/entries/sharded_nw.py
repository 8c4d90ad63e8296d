"""``dynaalign_torch.parallel.sharded_nw_allpairs``: exact all-pairs NW
percent identity over the ranks of a cell of more than one chip.

Every rank makes the call on the same inputs, at the port's defaults (pair
tiles of 16 x 16, 1,024 tiles a dispatch), and its mesh is every rank of
the process group.  Work, reference and controls are ``similarity_nw``'s:
n(n+1)/2 pairs a call, and rank 0's returned [n, n] float64 matrix judged
by sample against ``reference/nw.py``.  The bound is one rank's share of
the call: its DP cells and bytes over the ranks, ``nw_dp_per_chip``.
"""

from __future__ import annotations

from . import similarity_nw

UNIT = similarity_nw.UNIT
CONTROLS = similarity_nw.CONTROLS


class Entry(similarity_nw.Entry):
    def __init__(self, *args):
        super().__init__(*args)
        from dynaalign_torch import parallel

        self.mesh = parallel.make_mesh(device=self.device)

    def call(self, seqs):
        from dynaalign_torch import blosum, parallel
        from dynaalign_torch.encode import encode

        s = self.settings
        enc = encode(seqs)
        return parallel.sharded_nw_allpairs(
            enc.indices, enc.lengths, blosum.get_matrix(s["matrix_name"]),
            gap_open=s["gap_open"], gap_ext=s["gap_ext"], mesh=self.mesh)

    def bounds(self) -> dict[str, float]:
        (whole,) = super().bounds().values()
        return {"nw_dp_per_chip": whole / self.mesh.size}
