"""Progressive multiple sequence alignment (host-side, numpy).

Capability parity with the reference's consensus path, which delegates to
``DECIPHER::AlignSeqs`` (R/clusterbreak.R:315).  DECIPHER itself is a
progressive aligner; this module implements the same architecture:

1. guide tree: UPGMA over fast k-mer Jaccard distances (the same
   "k-mer distance first tree" strategy MUSCLE/DECIPHER use);
2. progressive profile-profile alignment along the tree with affine gap
   (Gotoh) scoring against a BLOSUM matrix.

MSA runs on the host by design: clusters are bounded by ``size_max`` and
consensus is not in the hot path; the all-pairs similarity on the card is
where the work lives.  Each pairwise/profile alignment runs the row DP of
``cpp/msa_dp.cpp`` (:func:`._native.native_row_dp`), always: a failed
build raises.  Its plain version, :func:`_numpy_row_dp`, computes the
identical traceback with a vectorised row sweep; tests swap it in
through ``_row_dp`` to hold the two equal.
"""

from __future__ import annotations

import numpy as np

from .. import blosum
from ..encode import ALPHABET_SIZE, encode
from ._native import native_row_dp

GAP = -1  # gap sentinel in aligned index arrays
NEG = np.int32(np.iinfo(np.int32).min // 2)
_NEGF = -1e18

# Scoring-only substitutions for IUPAC letters outside the reference's
# 24-symbol alphabet (src/pairwiseSeqAlign.cpp:15-21 has no J/U/O, but
# the reference's consensus path goes through DECIPHER::AAStringSet,
# which accepts them — h3n2sample itself contains 'J').  The original
# letters are preserved in the aligned output; only the BLOSUM lookup
# sees the substitute (J = Leu/Ile -> L, U = selenocysteine -> C,
# O = pyrrolysine -> K).
_SCORING_SUBSTITUTES = str.maketrans({"J": "L", "U": "C", "O": "K"})


def _numpy_row_dp(score_rows, go: float, ge: float):
    """Affine-gap global DP over a precomputed score matrix [m, n].

    Returns the traceback matrix tb [m+1, n+1] (0=D, 1=U, 2=L) following
    the reference's priority D > U > L (src/pairwiseSeqAlign.cpp:271-279)
    and border conventions (:222-235).

    NOTE: the reference's greedy
    single-matrix traceback — following each cell's overwritten max —
    is NOT guaranteed affine-optimal (e.g. YTM vs HLQIG walks a -25
    path where the true optimum is -17: the optimal trailing gap run
    passes through an Iy value below the cell max, so the greedy walk
    leaves it).  This is the reference's own semantics (the C++ oracle
    and the TPU kernel agree bit-for-bit, and nw_align_pair's percent
    identity equals oracle.nw_pair on fuzzed pairs), kept deliberately.

    Vectorization: per row, Ix and the diagonal candidates depend only on
    the previous row; the in-row chain
        Iy[j] = max(M[j-1] - (go+ge), Iy[j-1] - ge)
    unrolls to a prefix running-max of pre[j'] + j'*ge, where
    pre = max(mnew, Ix) are the non-Iy candidates, so each row is O(n)
    numpy work with no Python inner loop.

    cpp/msa_dp.cpp transcribes these formulas in the same IEEE-double
    order; this is its plain version.
    """
    score_rows = np.asarray(score_rows, dtype=np.float64)
    go, ge = float(go), float(ge)
    m, n = score_rows.shape
    tb = np.zeros((m + 1, n + 1), dtype=np.uint8)
    tb[1:, 0] = 1  # 'U'
    tb[0, 1:] = 2  # 'L'

    j_idx = np.arange(1, n + 1, dtype=np.float64)
    m_prev = np.full(n + 1, _NEGF)
    ix_prev = np.full(n + 1, _NEGF)
    iy_prev = np.full(n + 1, _NEGF)
    m_prev[0] = 0.0
    iy_prev[1:] = -go - (j_idx - 1) * ge

    for i in range(1, m + 1):
        sc = score_rows[i - 1]
        ix = np.maximum(m_prev[1:] - (go + ge), ix_prev[1:] - ge)
        diag = np.maximum(
            m_prev[:-1], np.maximum(ix_prev[:-1], iy_prev[:-1])
        )
        mnew = diag + sc
        pre = np.maximum(mnew, ix)
        # prefix-scan for Iy: candidates from the border and from pre[<j]
        border = -go - (i - 1) * ge  # M/Ix/Iy column-0 values enter via
        # Iy[j] chain through M[i][0]?  M[i][0] = sentinel; Iy[i][0] =
        # sentinel; Ix[i][0] = border — reference col-0 has only Ix live.
        # The in-row chain seeds from M[i][0] = NEG, so effectively only
        # pre[] terms matter; use a -inf seed.
        run = np.maximum.accumulate(
            np.concatenate(([_NEGF], pre[:-1] + j_idx[:-1] * ge))
        )
        iy = run - (go + ge) - (j_idx - 1) * ge
        # reference quirk: column 0 stores Ix (border), and Iy[i][j] may
        # also extend from Iy[i][0] = NEG -> ignored; M[i][0] = NEG.
        mrow = np.where((mnew >= ix) & (mnew >= iy), mnew,
                        np.where(ix >= iy, ix, iy))
        trow = np.where((mnew >= ix) & (mnew >= iy), 0,
                        np.where(ix >= iy, 1, 2)).astype(np.uint8)
        tb[i, 1:] = trow

        m_prev = np.concatenate(([_NEGF], mrow))
        ix_prev = np.concatenate(([border], ix))
        iy_prev = np.concatenate(([_NEGF], iy))
    return tb


# the row DP the aligner runs: always the native one (a failed build
# raises).  Tests and chip_smoke.py swap in _numpy_row_dp to hold the two
# equal.
_row_dp = native_row_dp


def _traceback_path(tb: np.ndarray):
    """Walk tb from (m, n) to (0, 0); returns aligned position lists
    (index into each side, GAP for gaps)."""
    i, j = tb.shape[0] - 1, tb.shape[1] - 1
    pa: list[int] = []
    pb: list[int] = []
    while i > 0 or j > 0:
        t = tb[i, j]
        if t == 0:
            pa.append(i - 1)
            pb.append(j - 1)
            i -= 1
            j -= 1
        elif t == 1:
            pa.append(i - 1)
            pb.append(GAP)
            i -= 1
        else:
            pa.append(GAP)
            pb.append(j - 1)
            j -= 1
    pa.reverse()
    pb.reverse()
    return np.array(pa, dtype=np.int64), np.array(pb, dtype=np.int64)


def _sub_f64(matrix_name: str) -> np.ndarray:
    """The raw [24, 24] BLOSUM table as float64 (unknown names raise)."""
    return blosum.get_matrix(matrix_name, padded=False).numpy().astype(
        np.float64)


def nw_align_pair(
    s1: str,
    s2: str,
    matrix_name: str = "BLOSUM62",
    gap_open: float = 10,
    gap_ext: float = 4,
) -> tuple[str, str]:
    """Global alignment of two sequences; returns the gapped strings."""
    sub = _sub_f64(matrix_name)
    e = encode(
        [s1.translate(_SCORING_SUBSTITUTES),
         s2.translate(_SCORING_SUBSTITUTES)],
        pad_to=max(len(s1), len(s2)),
    )
    i1 = e.indices[0, : len(s1)]
    i2 = e.indices[1, : len(s2)]
    scores = sub[np.ix_(i1, i2)]
    tb = _row_dp(scores, gap_open, gap_ext)
    pa, pb = _traceback_path(tb)
    a = "".join("-" if p == GAP else s1[p] for p in pa)
    b = "".join("-" if p == GAP else s2[p] for p in pb)
    return a, b


# ---------------------------------------------------------------------------
# Profiles
# ---------------------------------------------------------------------------
N_CHANNELS = ALPHABET_SIZE + 1  # 24 residues + gap channel
GAP_CH = ALPHABET_SIZE


def _seq_profile(idx: np.ndarray) -> np.ndarray:
    """One sequence as a [L, 25] count profile."""
    p = np.zeros((len(idx), N_CHANNELS), dtype=np.float64)
    p[np.arange(len(idx)), idx] = 1.0
    return p


def _profile_scores(
    p1: np.ndarray, p2: np.ndarray, sub: np.ndarray
) -> np.ndarray:
    """Expected substitution score between profile columns: normalized
    residue frequencies through BLOSUM via two matmuls (BLAS)."""
    f1 = p1[:, :ALPHABET_SIZE]
    f2 = p2[:, :ALPHABET_SIZE]
    n1 = f1.sum(axis=1, keepdims=True)
    n2 = f2.sum(axis=1, keepdims=True)
    f1 = f1 / np.maximum(n1, 1e-9)
    f2 = f2 / np.maximum(n2, 1e-9)
    return (f1 @ sub) @ f2.T


def _merge_profiles(
    p1: np.ndarray,
    p2: np.ndarray,
    sub: np.ndarray,
    gap_open: float,
    gap_ext: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Align two profiles; returns (merged profile, pos-map1, pos-map2)."""
    scores = _profile_scores(p1, p2, sub)
    tb = _row_dp(scores, gap_open, gap_ext)
    pa, pb = _traceback_path(tb)
    w1 = p1.sum(axis=1).max() if len(p1) else 1.0
    w2 = p2.sum(axis=1).max() if len(p2) else 1.0
    length = len(pa)
    merged = np.zeros((length, N_CHANNELS), dtype=np.float64)
    for pos, (a, b) in enumerate(zip(pa, pb)):
        col = np.zeros(N_CHANNELS)
        if a == GAP:
            col[GAP_CH] += w1
        else:
            col += p1[a]
        if b == GAP:
            col[GAP_CH] += w2
        else:
            col += p2[b]
        merged[pos] = col
    return merged, pa, pb


def _kmer_distance(seqs: list[str], k: int = 3) -> np.ndarray:
    """Binary k-mer Jaccard distance matrix (guide-tree metric)."""
    vocab: dict[str, int] = {}
    rows = []
    for s in seqs:
        kmers = {s[i : i + k] for i in range(max(0, len(s) - k + 1))}
        ids = []
        for km in kmers:
            if km not in vocab:
                vocab[km] = len(vocab)
            ids.append(vocab[km])
        rows.append(ids)
    n = len(seqs)
    mat = np.zeros((n, len(vocab) or 1), dtype=np.float32)
    for i, ids in enumerate(rows):
        mat[i, ids] = 1.0
    inter = mat @ mat.T
    sizes = mat.sum(axis=1)
    union = sizes[:, None] + sizes[None, :] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        jac = np.where(union > 0, inter / np.maximum(union, 1e-9), 1.0)
    return 1.0 - jac


def _upgma_order(dist: np.ndarray) -> list[tuple[int, int]]:
    """UPGMA join order as a list of (cluster_a, cluster_b) merges.

    Cluster ids: 0..n-1 leaves, then n, n+1, ... for internal merges.
    Vectorized: the working distance matrix lives in one [n, n] array with
    slots reused in place, so each of the n-1 joins is O(n) numpy work.
    """
    n = dist.shape[0]
    d = dist.astype(np.float64).copy()
    np.fill_diagonal(d, np.inf)
    alive = np.ones(n, dtype=bool)
    sizes = np.ones(n, dtype=np.float64)
    ids = np.arange(n)  # external cluster id of each slot
    joins: list[tuple[int, int]] = []
    next_id = n
    for _ in range(n - 1):
        sub = np.where(alive[:, None] & alive[None, :], d, np.inf)
        flat = np.argmin(sub)
        i, j = divmod(flat, n)
        if i > j:
            i, j = j, i
        joins.append((int(ids[i]), int(ids[j])))
        si, sj = sizes[i], sizes[j]
        # merged cluster occupies slot i
        new_row = (d[i] * si + d[j] * sj) / (si + sj)
        d[i] = new_row
        d[:, i] = new_row
        d[i, i] = np.inf
        alive[j] = False
        sizes[i] = si + sj
        ids[i] = next_id
        next_id += 1
    return joins


def progressive_msa(
    seqs: list[str],
    matrix_name: str = "BLOSUM62",
    gap_open: float = 10,
    gap_ext: float = 2,
) -> list[str]:
    """Progressive MSA; returns gapped strings, all equal length."""
    n = len(seqs)
    if n == 0:
        return []
    if n == 1:
        return [seqs[0]]
    sub = _sub_f64(matrix_name)
    enc = encode(
        [s.translate(_SCORING_SUBSTITUTES) for s in seqs], validate=True
    )
    idxs = [enc.indices[i, : enc.lengths[i]] for i in range(n)]

    dist = _kmer_distance(seqs)
    joins = _upgma_order(dist)

    # cluster state: id -> (profile, list[(seq_index, pos_map)])
    state: dict[int, tuple[np.ndarray, list[tuple[int, np.ndarray]]]] = {}
    for i in range(n):
        state[i] = (
            _seq_profile(idxs[i]),
            [(i, np.arange(len(idxs[i]), dtype=np.int64))],
        )
    next_id = n
    for a, b in joins:
        pa_prof, pa_members = state.pop(a)
        pb_prof, pb_members = state.pop(b)
        merged, map_a, map_b = _merge_profiles(
            pa_prof, pb_prof, sub, gap_open, gap_ext
        )
        # remap member positions through the new alignment
        inv_a = np.full(len(pa_prof), -1, dtype=np.int64)
        inv_b = np.full(len(pb_prof), -1, dtype=np.int64)
        for pos, src in enumerate(map_a):
            if src != GAP:
                inv_a[src] = pos
        for pos, src in enumerate(map_b):
            if src != GAP:
                inv_b[src] = pos
        members = []
        for si, pm in pa_members:
            members.append((si, np.where(pm >= 0, inv_a[np.clip(pm, 0, None)], -1)))
        for si, pm in pb_members:
            members.append((si, np.where(pm >= 0, inv_b[np.clip(pm, 0, None)], -1)))
        state[next_id] = (merged, members)
        next_id += 1

    (_, members), = state.values()
    total_len = state[next_id - 1][0].shape[0]
    out = [""] * n
    for si, pm in members:
        row = ["-"] * total_len
        s = seqs[si]
        for src_pos, dst_pos in enumerate(pm):
            if dst_pos >= 0:
                row[dst_pos] = s[src_pos]
        out[si] = "".join(row)
    return out
