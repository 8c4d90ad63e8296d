"""Amino-acid sequence encoding (host side, numpy).

The 24-symbol alphabet (20 canonical AAs + ambiguity codes B, Z, X and the
stop symbol '*') and its index order mirror the reference's ``aa_to_index``
map (reference: src/pairwiseSeqAlign.cpp:15-21) so that BLOSUM table lookups
agree index-for-index.

Two encodings are produced:

* **ASCII bytes**: raw uint8 character codes, as the reference hashes them
  for MinHash (src/minHash.cpp:21-64).
* **Alphabet indices**: int32 indices into the 24-symbol alphabet, used by
  the Needleman–Wunsch path for substitution-matrix lookups.

Both are fixed-shape padded ``[N, L]`` arrays plus a ``[N]`` lengths vector;
the callers copy them to the device once.  ``bucket_by_length`` groups
ragged inputs into a few padded buckets to limit padding waste.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# Alphabet in the reference's index order (src/pairwiseSeqAlign.cpp:15-21).
ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"
ALPHABET_SIZE = len(ALPHABET)  # 24
PAD_ID = ALPHABET_SIZE  # padding index; BLOSUM tables are padded to cover it

_CHAR_TO_INDEX = np.full(256, -1, dtype=np.int32)
for _i, _c in enumerate(ALPHABET):
    _CHAR_TO_INDEX[ord(_c)] = _i


class InvalidSequenceError(ValueError):
    """Raised when a sequence contains a character outside the alphabet.

    Mirrors the reference's ``Rcpp::stop("Invalid amino acid in sequence...")``
    (src/pairwiseSeqAlign.cpp:241-243, 248-250).
    """


@dataclasses.dataclass(frozen=True)
class EncodedSeqs:
    """A batch of sequences in padded form.

    Attributes:
      ascii: uint8 [N, L] raw character codes, zero-padded.
      indices: int32 [N, L] alphabet indices, PAD_ID-padded.
      lengths: int32 [N] true sequence lengths.
    """

    ascii: np.ndarray
    indices: np.ndarray
    lengths: np.ndarray

    @property
    def max_len(self) -> int:
        return self.ascii.shape[1]

    @property
    def n(self) -> int:
        return self.ascii.shape[0]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def encode(
    sequences: Sequence[str],
    *,
    pad_to: int | None = None,
    pad_multiple: int = 1,
    validate: bool = True,
) -> EncodedSeqs:
    """Encode a list of AA strings into padded arrays.

    Args:
      sequences: list of amino-acid strings.
      pad_to: pad every sequence to exactly this length (must be >= max len).
      pad_multiple: round the padded length up to a multiple of this.
      validate: if True, reject characters outside the 24-symbol alphabet.

    Returns:
      EncodedSeqs with ascii uint8 [N, L], indices int32 [N, L], lengths [N].
    """
    if len(sequences) == 0:
        raise ValueError("Input sequences vector cannot be empty")
    lengths = np.array([len(s) for s in sequences], dtype=np.int32)
    max_len = int(lengths.max())
    target = pad_to if pad_to is not None else max_len
    if target < max_len:
        raise ValueError(f"pad_to={target} < longest sequence ({max_len})")
    target = max(_round_up(max(target, 1), pad_multiple), 1)

    n = len(sequences)
    ascii_arr = np.zeros((n, target), dtype=np.uint8)
    for i, s in enumerate(sequences):
        b = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
        ascii_arr[i, : len(b)] = b

    indices = _CHAR_TO_INDEX[ascii_arr]
    # only positions within each sequence's true length must be valid
    pos = np.arange(target)[None, :] < lengths[:, None]
    if validate:
        bad = (indices < 0) & pos
        if bad.any():
            i, j = np.argwhere(bad)[0]
            raise InvalidSequenceError(
                f"Invalid amino acid {chr(ascii_arr[i, j])!r} in sequence {i}"
            )
    # invalid characters (validate=False) and padding positions -> PAD_ID
    indices = np.where(pos & (indices >= 0), indices, PAD_ID).astype(np.int32)
    return EncodedSeqs(ascii=ascii_arr, indices=indices, lengths=lengths)


def decode(indices: np.ndarray, length: int | None = None) -> str:
    """Inverse of encode() for one index row (padding stripped)."""
    chars = []
    for v in np.asarray(indices).ravel():
        if v == PAD_ID:
            break
        chars.append(ALPHABET[int(v)])
    s = "".join(chars)
    return s[:length] if length is not None else s


def bucket_by_length(
    sequences: Sequence[str],
    *,
    bucket_edges: Sequence[int] = (16, 32, 64, 128, 256, 512, 1024, 2048),
    pad_multiple: int = 1,
) -> list[tuple[np.ndarray, EncodedSeqs]]:
    """Group sequences into length buckets to limit padding waste.

    Returns a list of (original_positions, EncodedSeqs) per non-empty bucket.
    Each bucket is padded to its edge (times pad_multiple rounding).
    """
    lengths = np.array([len(s) for s in sequences], dtype=np.int64)
    edges = np.asarray(bucket_edges, dtype=np.int64)
    if len(lengths) and lengths.max() > edges[-1]:
        raise ValueError(
            f"sequences longer than max bucket edge {edges[-1]}: "
            f"max len {lengths.max()}"
        )
    # bucket b holds lengths in (edges[b-1], edges[b]]; bucket 0 takes 0 too
    assigned = np.searchsorted(edges, lengths, side="left")
    out: list[tuple[np.ndarray, EncodedSeqs]] = []
    for bi, edge in enumerate(edges):
        pos = np.nonzero(assigned == bi)[0]
        if len(pos) == 0:
            continue
        enc = encode(
            [sequences[p] for p in pos],
            pad_to=int(edge),
            pad_multiple=pad_multiple,
        )
        out.append((pos, enc))
    return out
