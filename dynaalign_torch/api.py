"""User-facing NW similarity entry points.

``similarity_nw`` mirrors the reference's R-level API and defaults
(R/RcppExports.R:34-36):

    similarityNW(sequences, matrixName = "BLOSUM62", gapOpen = 10, gapExt = 4)

and returns a dense symmetric [N, N] float64 matrix in [0, 1].  The work
runs on ``device`` (default ``"cuda"``); pass ``device="cpu"`` to run the
plain PyTorch version on the host.  Without a card, the default raises
instead of falling back.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import blosum
from .encode import bucket_by_length, encode
from .ops import nw_batch, pair_bytes

# most pairs per kernel launch
DEFAULT_CHUNK = 1 << 17
# most device bytes per launch: gathered inputs plus the kernel's scratch
# (ops.pair_bytes).  131,072 pairs of h3n2 HA (M = N = 566) take 0.6 GB,
# all of it inputs; at M = N = 12,288 it allows 29,123 pairs, where
# DEFAULT_CHUNK would take 38.7 GB.
LAUNCH_BYTES = 8 << 30
# the JAX package's default bucket edges (its api.PALLAS_BUCKET_EDGES),
# copied so that both packages bucket, and refuse, the same sets
BUCKET_EDGES = (15, 31, 63, 127, 255, 383, 511, 639, 767, 1023, 1535, 2047)


def _resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device needs a card present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version on the host"
        )
    return dev


def _ratio(matches: np.ndarray, length: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore", divide="ignore"):
        return matches.astype(np.float64) / length


def _gather(idx_a, len_a, idx_b, len_b, r, c):
    """One launch's pair batch: sequences ``r`` of a beside ``c`` of b."""
    return idx_a[r], len_a[r], idx_b[c], len_b[c]


def _fetch(mt, ln):
    """The launches' results as two host arrays, in one copy each."""
    return torch.cat(mt).cpu().numpy(), torch.cat(ln).cpu().numpy()


def _fill(n: int, vals: np.ndarray) -> np.ndarray:
    """Symmetric [n, n] matrix from its row-major upper triangle
    (src/pairwiseSeqAlign.cpp:349-350)."""
    iu_np = np.triu_indices(n)
    sims = np.zeros((n, n), dtype=np.float64)
    sims[iu_np] = vals
    sims.T[iu_np] = vals
    return sims


def _pairs_nw(idx_a, len_a, idx_b, len_b, rows, cols, sub, gap_open,
              gap_ext, chunk):
    """(matches, length) of pairs (idx_a[rows[k]], idx_b[cols[k]]), all on
    the device, streamed in launches of at most ``chunk`` pairs and
    LAUNCH_BYTES bytes, and fetched once."""
    per_pair = pair_bytes(idx_a.shape[1], idx_b.shape[1])
    chunk = max(1, min(chunk, LAUNCH_BYTES // per_pair))
    mt, ln = [], []
    for s in range(0, rows.numel(), chunk):
        batch = _gather(idx_a, len_a, idx_b, len_b, rows[s : s + chunk],
                        cols[s : s + chunk])
        res = nw_batch(*batch, sub, gap_open=gap_open, gap_ext=gap_ext)
        mt.append(res.matches)
        ln.append(res.length)
    return _fetch(mt, ln)


def similarity_nw(
    sequences: Sequence[str],
    matrix_name: str = "BLOSUM62",
    gap_open: int = 10,
    gap_ext: int = 4,
    *,
    device=None,
    chunk: int | None = None,
) -> np.ndarray:
    """Exact NW percent-identity similarity matrix (reference similarityNW).

    Bit-identical to the reference semantics (validated against the C++
    oracle): affine-gap Gotoh DP, traceback-path percent identity, priority
    D > U > L, border/interior gap asymmetry.  Every pair of the upper
    triangle, diagonal included (src/pairwiseSeqAlign.cpp:342), is aligned
    with the lower index as sequence 1.  The encoded set goes to the device
    once; the pair list is streamed in ``chunk``-pair launches.
    """
    n = len(sequences)
    if n == 0:
        raise ValueError("Input sequences vector cannot be empty")
    dev = _resolve_device(device)
    sub = blosum.get_matrix(matrix_name, device=dev)
    enc = encode(sequences)
    idx = torch.from_numpy(enc.indices).to(dev)
    lens = torch.from_numpy(enc.lengths).to(dev)
    iu = torch.triu_indices(n, n, device=dev)  # row-major, rows <= cols
    mt, ln = _pairs_nw(idx, lens, idx, lens, iu[0], iu[1], sub, gap_open,
                       gap_ext, chunk or DEFAULT_CHUNK)
    return _fill(n, _ratio(mt, ln))


def similarity_nw_bucketed(
    sequences: Sequence[str],
    matrix_name: str = "BLOSUM62",
    gap_open: int = 10,
    gap_ext: int = 4,
    *,
    bucket_edges: Sequence[int] = BUCKET_EDGES,
    device=None,
    chunk: int | None = None,
) -> np.ndarray:
    """Length-bucketed exact NW all-pairs, equal to :func:`similarity_nw`.

    Sequences are grouped into padded length buckets and every pair runs at
    its bucket pair's (smaller) padded shape, so mixed workloads (12-mer
    probes + ~566 aa proteins) do not pay worst-case padding on every pair.
    Each pair keeps the reference's orientation: the smaller global index is
    sequence 1, since tie-breaking is not symmetric under a swap
    (src/pairwiseSeqAlign.cpp:340-343).
    """
    seqs = list(sequences)
    n = len(seqs)
    if n == 0:
        raise ValueError("Input sequences vector cannot be empty")
    dev = _resolve_device(device)
    sub = blosum.get_matrix(matrix_name, device=dev)
    buckets = bucket_by_length(seqs, bucket_edges=bucket_edges)
    which = np.zeros(n, dtype=np.int64)  # global index -> bucket id
    local = np.zeros(n, dtype=np.int64)  # global index -> index in bucket
    on_dev = []
    for b, (pos, enc_b) in enumerate(buckets):
        which[pos] = b
        local[pos] = np.arange(len(pos))
        on_dev.append((torch.from_numpy(enc_b.indices).to(dev),
                       torch.from_numpy(enc_b.lengths).to(dev)))

    gi, gj = np.triu_indices(n)  # includes the diagonal, like the reference
    group = which[gi] * len(buckets) + which[gj]
    matches = np.zeros((n, n), dtype=np.int64)
    length = np.zeros((n, n), dtype=np.int64)
    for g in np.unique(group):
        sel = np.nonzero(group == g)[0]
        ba, bb = divmod(int(g), len(buckets))
        rows = torch.from_numpy(local[gi[sel]]).to(dev)
        cols = torch.from_numpy(local[gj[sel]]).to(dev)
        mt, ln = _pairs_nw(*on_dev[ba], *on_dev[bb], rows, cols, sub,
                           gap_open, gap_ext, chunk or DEFAULT_CHUNK)
        matches[gi[sel], gj[sel]] = mt
        length[gi[sel], gj[sel]] = ln
        matches[gj[sel], gi[sel]] = mt
        length[gj[sel], gi[sel]] = ln
    return _ratio(matches, length)
