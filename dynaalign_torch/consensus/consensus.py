"""Consensus sequences from alignments; cluster_consensus per cluster.

Capability parity with the reference's ``clusterconsensus``
(R/clusterbreak.R:309-320), which runs
``DECIPHER::AlignSeqs`` + ``DECIPHER::ConsensusSequence`` per cluster.

``consensus_sequence`` implements the documented parameter surface of
``DECIPHER::ConsensusSequence`` for amino-acid alignments:

* ``threshold`` (default 0.05): at most this fraction of the column's
  residue information may be lost — the consensus set is the smallest
  set of residues (by descending frequency) covering ``>= 1 - threshold``
  of the column's residue mass.
* ``ambiguity`` (default True): input IUPAC ambiguity letters contribute
  fractional mass to their constituents (B -> {N, D}, Z -> {Q, E},
  J -> {I, L}, X -> all twenty standard residues), and a consensus set
  that is exactly a standard ambiguity group emits its IUPAC code
  (Asx = B, Glx = Z, Xle = J); any other multi-residue set emits X.
  With ``ambiguity=False`` every letter counts as itself and a
  multi-residue consensus set emits ``no_consensus_char``.
* ``min_information`` (default ``1 - threshold``): minimum fraction of
  the column's total mass the consensus set must explain; below it the
  column emits ``no_consensus_char`` ('+', DECIPHER's amino-acid
  default).
* ``include_terminal_gaps`` (default False): leading/trailing gaps of
  each row are treated as missing data (excluded from the column's
  denominator) rather than as gap characters.
* a column whose gap mass exceeds 0.5 of its non-missing mass emits '-'.

Deliberate divergences from DECIPHER (documented, since the project runs
no R and so cannot diff against DECIPHER): DECIPHER additionally weights
information by positional secondary-structure probabilities for its
staggered alignments — irrelevant for the reference's usage, which calls
it with defaults on plain AA sets; DECIPHER's ``ignoreNonBases``
applies to nucleotide inputs only; and the ``min_information`` test
divides the consensus set's residue mass by the column's TOTAL
non-missing mass *including interior gaps* (so e.g. a unanimous-D
column with 40% interior gap mass emits ``no_consensus_char`` under
defaults).  The gap-inclusive denominator is pinned by the doc-derived
golden suite (tests/test_consensus_decipher_goldens.py, which
tests/test_torch_consensus.py runs against this module too): the
documentation's threshold clause ("less than threshold fraction of the
sequence information can be lost") together with its gap handling
(gaps are characters carrying information — a gap-majority column's
consensus is a gap) admits only the gap-inclusive reading; the
gap-exclusive alternative (compare ``cum`` against ``res_total``)
would silently drop a 40% gap share.  Each golden names the
documentation clause it encodes; none were produced by running
DECIPHER, which remains the honest residual gap.
"""

from __future__ import annotations

import numpy as np

from .msa import progressive_msa

_STD20 = "ARNDCQEGHILKMFPSTWYV"

# fractional-mass expansion of input letters (ambiguity=True)
_EXPAND = {
    "B": (("N", 0.5), ("D", 0.5)),
    "Z": (("Q", 0.5), ("E", 0.5)),
    "J": (("I", 0.5), ("L", 0.5)),
    "X": tuple((aa, 1.0 / 20.0) for aa in _STD20),
}

# consensus-set -> IUPAC code (any subset of a group's constituents,
# with more than one distinct residue, collapses to the group's code)
_GROUPS = (
    (frozenset("ND"), "B"),
    (frozenset("QE"), "Z"),
    (frozenset("IL"), "J"),
)


def _column_masses(
    col: np.ndarray,
    missing: np.ndarray,
    ambiguity: bool,
) -> tuple[dict, float, float]:
    """(residue mass dict, gap mass, total non-missing mass) of a column."""
    mass: dict[str, float] = {}
    gap = 0.0
    total = 0.0
    for ch, is_missing in zip(col, missing):
        if is_missing:
            continue
        total += 1.0
        if ch == "-":
            gap += 1.0
            continue
        if ambiguity and ch in _EXPAND:
            for aa, w in _EXPAND[ch]:
                mass[aa] = mass.get(aa, 0.0) + w
        else:
            mass[ch] = mass.get(ch, 0.0) + 1.0
    return mass, gap, total


def _set_to_code(residues: frozenset, ambiguity: bool, no_consensus: str) -> str:
    if len(residues) == 1:
        return next(iter(residues))
    if ambiguity:
        for members, code in _GROUPS:
            if residues <= members:
                return code
        return "X"
    return no_consensus


def consensus_sequence(
    aligned: list[str],
    threshold: float = 0.05,
    *,
    ambiguity: bool = True,
    min_information: float | None = None,
    no_consensus_char: str = "+",
    include_terminal_gaps: bool = False,
) -> str:
    """IUPAC consensus of equal-length gapped sequences (see module doc)."""
    if not aligned:
        return ""
    length = len(aligned[0])
    if any(len(s) != length for s in aligned):
        raise ValueError("aligned sequences must have equal length")
    if min_information is None:
        min_information = 1.0 - threshold
    n = len(aligned)
    cols = np.array([list(s) for s in aligned])  # [n, L]

    # terminal-gap mask: True where a row's position lies before its
    # first or after its last non-gap character
    if include_terminal_gaps:
        missing = np.zeros((n, length), dtype=bool)
    else:
        is_res = cols != "-"
        any_res = is_res.any(axis=1)
        first = np.where(any_res, is_res.argmax(axis=1), length)
        last = np.where(
            any_res, length - 1 - is_res[:, ::-1].argmax(axis=1), -1
        )
        pos = np.arange(length)
        missing = (pos[None, :] < first[:, None]) | (
            pos[None, :] > last[:, None]
        )

    out = []
    for c in range(length):
        mass, gap, total = _column_masses(
            cols[:, c], missing[:, c], ambiguity
        )
        if total == 0.0:
            out.append("-")  # column is entirely terminal gaps
            continue
        if gap > 0.5 * total:
            out.append("-")
            continue
        res_total = sum(mass.values())
        if res_total == 0.0:
            out.append(no_consensus_char)
            continue
        # smallest residue set covering >= (1 - threshold) of residue mass
        ranked = sorted(mass.items(), key=lambda kv: (-kv[1], kv[0]))
        need = (1.0 - threshold) * res_total - 1e-12
        cum = 0.0
        chosen: list[str] = []
        for aa, w in ranked:
            chosen.append(aa)
            cum += w
            if cum >= need:
                break
        if (cum + 0.0) / total < min_information - 1e-12:
            out.append(no_consensus_char)
            continue
        out.append(
            _set_to_code(frozenset(chosen), ambiguity, no_consensus_char)
        )
    return "".join(out)


def cluster_consensus(
    df: np.ndarray | list[tuple[str, str]],
    *,
    matrix_name: str = "BLOSUM62",
    threshold: float = 0.05,
    **consensus_kwargs,
) -> np.ndarray:
    """Per-cluster MSA + consensus (reference clusterconsensus,
    R/clusterbreak.R:309-320).

    Args:
      df: [n, 2] array-like — column 0 sequences, column 1 cluster ids
        (the ``clustered_seq`` output of :func:`clusterbreak`).

    Returns:
      [m, 2] object array: (cluster_id, consensus_sequence), in first-seen
      cluster-id order (matching the reference's ``unique`` order).
    """
    arr = np.asarray(df, dtype=object)
    if arr.ndim != 2 or arr.shape[1] < 2:
        raise ValueError("df must be an [n, 2] (sequence, cluster) array")
    seen: list = []
    for cid in arr[:, 1]:
        if cid not in seen:
            seen.append(cid)
    rows = []
    for cid in seen:
        seqs = [str(s) for s in arr[arr[:, 1] == cid, 0]]
        aligned = progressive_msa(seqs, matrix_name=matrix_name)
        rows.append(
            (cid, consensus_sequence(aligned, threshold, **consensus_kwargs))
        )
    return np.array(rows, dtype=object)
