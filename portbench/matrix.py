"""Checking a dense all-pairs matrix against the reference by sample.

A run keeps one result at a time, so after each call it reads a sample of
entries and frees the matrix.  The sample is drawn from ``--seed``: a pool
of pairs (every pair of the upper triangle where there are at most
``pool`` of them; else ``pool`` pairs drawn at random, the two longest
sequences' pair first), and after each call ``per_call`` pairs of the pool,
read in both orientations, so the symmetric fill is judged as well.  Once
the window has closed the reference computes the pairs read, and every
entry read has to equal it bit for bit (NaN where it gives NaN).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Reading:
    pool_rows: np.ndarray  # indices into the pool
    upper: np.ndarray  # float64 entries [i, j]
    lower: np.ndarray  # float64 entries [j, i]


def pool(seqs: list[str], size: int, seed: int) -> np.ndarray:
    """int64 [P, 2] pairs (i <= j) that the run may read."""
    n = len(seqs)
    if n * (n + 1) // 2 <= size:
        return np.stack(np.triu_indices(n), axis=1).astype(np.int64)
    rng = np.random.default_rng([seed, 1])
    ij = np.sort(rng.integers(0, n, size=(size, 2)), axis=1)
    longest = np.argsort([-len(s) for s in seqs], kind="stable")[:2]
    ij[0] = np.sort(longest)
    return ij


def read(out, pairs: np.ndarray, per_call: int, seed: int,
         call: int) -> Reading:
    """The entries of ``out`` at ``per_call`` pool pairs drawn for ``call``."""
    if per_call >= len(pairs):
        rows = np.arange(len(pairs))
    else:
        rows = np.random.default_rng([seed, 2, call]).choice(
            len(pairs), size=per_call, replace=False)
    i, j = pairs[rows, 0], pairs[rows, 1]
    return Reading(rows, np.array(out[i, j], dtype=np.float64),
                   np.array(out[j, i], dtype=np.float64))


def well_formed(out, n: int) -> bool:
    return (isinstance(out, np.ndarray) and out.shape == (n, n)
            and out.dtype == np.float64)


def rows_read(readings: list[Reading]) -> np.ndarray:
    """The pool rows any call read, sorted, once each."""
    if not readings:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.concatenate([r.pool_rows for r in readings]))


def mismatches(readings: list[Reading], rows: np.ndarray,
               want: np.ndarray) -> tuple[int, int]:
    """(entries unequal to ``want``, entries compared); ``want`` holds the
    reference's value of each pool row in ``rows``."""
    at = {int(r): k for k, r in enumerate(rows)}
    bad = seen = 0
    for r in readings:
        w = want[[at[int(x)] for x in r.pool_rows]]
        for got in (r.upper, r.lower):
            same = (got == w) | (np.isnan(got) & np.isnan(w))
            bad += int((~same).sum())
            seen += len(w)
    return bad, seen


def judge(readings: list[Reading], values, dtype=np.float64):
    """(entries unequal to the reference, entries compared, pool rows
    computed); ``values(rows, dtype)`` gives the reference's value of pool
    rows.  With ``dtype`` other than float64 the readings are replaced by
    the reference's own in that precision: a control."""
    rows = rows_read(readings)
    want = values(rows)
    if dtype is not np.float64:
        got = values(rows, dtype)
        at = {int(r): k for k, r in enumerate(rows)}
        readings = [Reading(r.pool_rows, *2 * [
            got[[at[int(x)] for x in r.pool_rows]]]) for r in readings]
    bad, seen = mismatches(readings, rows, want)
    return bad, seen, len(rows)


class MatrixEntry:
    """What the dense-matrix entry points share: the pool, the readings
    and the judging.  A subclass gives ``call``, ``work``, ``bounds``,
    ``values(rows, dtype)`` (the reference's value of pool rows) and
    ``INFO`` (the name of what ``values`` computed)."""

    INFO = "pairs"

    def __init__(self, seqs, settings, traffic, seed, device):
        self.settings = settings
        self.seqs = seqs
        self.device = device
        self.seed = seed
        self.check = traffic["check"]
        self.pairs = pool(seqs, self.check["pool"], seed)

    def read(self, out, call: int):
        if not well_formed(out, len(self.seqs)):
            return None
        return read(out, self.pairs, self.check["per_call"], self.seed,
                    call)

    def judge(self, readings, control=None):
        """{name: (value, limit)} and what was compared; the control
        "float32" puts the reference in float32 in the program's place."""
        dtype = np.float32 if control == "float32" else np.float64
        bad, seen, rows = judge(readings, self.values, dtype)
        return ({"mismatched_entries": (bad, 0)},
                {"entries_compared": seen, self.INFO: rows})
