"""The yardstick's peaks and operation counts, frozen here so that no
change to the program moves them.

Peaks: NVIDIA H100 SXM data sheet (dense, at the 700 W power limit).  An
SM has 64 INT32 ALU lanes (half of the 128 FP32 lanes behind the 67
TFLOP/s float32 figure) at the 1.98 GHz boost clock, on 132 SMs; integer
rates are not tabulated, so the ALU rate is built from those numbers.

NW: 8 integer operations per DP cell on the ALU lanes (the add-max of Ix
and of Iy, the two maxima of the diagonal, the D > U > L compare and the
selects of the traceback word), the count ``NW_ALU_OPS_PER_CELL`` that
``dynaalign_torch/csrc/nw_cell.cuh`` derives for its cell update (its 12
operations in all, ``NW_OPS_PER_CELL``, at the 128-a-clock issue rate take
less time, so they never bound).  A kernel that packs two cells into one
32-bit operation would read over 100% against it: such a kernel needs
this count changed first.

MinHash: ``ops_per_hash`` integer operations per murmur3 hash of a
k-mer under one seed, each as one instruction of the card (each 4-byte
block: the xor into the state 1, the rotate 1 as one funnel shift, the
multiply by 5 and add of the constant 1 as one multiply-add; the tail's
xor 1; the finaliser: xor with k 1, three shift-and-xor 6, two
multiplies 2; the minimum over windows 1; a block's own mixing depends on
the window alone and is shared by the seeds); and one compare and one
add per signature slot of each of the n(n-1)/2 distinct pairs, since the
matrix is symmetric and its diagonal is 1 by definition.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 64 * 132 * 1.98e9  # 1.6727e13
NW_ALU_OPS_PER_CELL = 8


def nw_bound_s(cells: float, nbytes: float) -> float:
    """Least seconds for ``cells`` DP cells that read and write ``nbytes``:
    the larger of the operations at the ALU rate and the bytes at the HBM
    rate."""
    return max(NW_ALU_OPS_PER_CELL * cells / ALU_OPS_PER_S,
               nbytes / HBM_BYTES_PER_S)


def ops_per_hash(k: int) -> int:
    return 3 * (k // 4) + (1 if k & 3 else 0) + 9 + 1


def signature_bound_s(windows: int, n_hash: int, k: int, nbytes: float):
    """Least seconds to hash ``windows`` k-mer windows under ``n_hash``
    seeds and take each slot's minimum."""
    return max(windows * n_hash * ops_per_hash(k) / ALU_OPS_PER_S,
               nbytes / HBM_BYTES_PER_S)


def compare_bound_s(pairs: int, n_hash: int, nbytes: float):
    """Least seconds to count the agreeing slots of ``pairs`` pairs: one
    compare and one add a slot."""
    return max(2.0 * pairs * n_hash / ALU_OPS_PER_S,
               nbytes / HBM_BYTES_PER_S)
