"""User-facing similarity entry points.

``similarity_mh`` / ``similarity_nw`` mirror the reference's R-level API
and defaults (R/RcppExports.R:15-17, 34-36):

    similarityMH(sequences, k = 4, n_hash = 50)
    similarityNW(sequences, matrixName = "BLOSUM62", gapOpen = 10, gapExt = 4)

and return dense symmetric [N, N] float64 matrices in [0, 1].  The work
runs on ``device`` (default ``"cuda"``); pass ``device="cpu"`` to run the
plain PyTorch version on the host.  Without a card, the default raises
instead of falling back.  ``similarity_mh`` also takes an explicit RNG
``seed`` (the reference's hash family is nondeterministic,
src/minHash.cpp:73).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import blosum
from .device import resolve_device as _resolve_device
from .encode import bucket_by_length, encode
from .ops import nw_batch, pair_bytes
from .ops.minhash import (
    as_signatures,
    counts_to_similarity,
    fetch_counts,
    minhash_signatures,
    signature_agreement_counts,
    signature_similarity,
)
from .utils.profiling import span

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


def labels_1n(n: int) -> list[str]:
    """Reference-style dimnames "1".."n" (src/minHash.cpp:181-186)."""
    return [str(i + 1) for i in range(n)]


def _check_mh_args(sequences, k: int, n_hash: int) -> None:
    """Validation of src/minHash.cpp:121-131."""
    if len(sequences) == 0:
        raise ValueError("Input sequences vector cannot be empty")
    if k <= 0:
        raise ValueError("'k' must be a positive integer")
    if n_hash <= 0:
        raise ValueError("Number of hash functions must be positive")


def similarity_mh(
    sequences: Sequence[str],
    k: int = 4,
    n_hash: int = 50,
    *,
    seed: int = 0,
    device=None,
    chunk: int | None = None,
    block: int | None = None,
) -> np.ndarray:
    """MinHash Jaccard-estimate similarity matrix (reference similarityMH).

    ``chunk`` (sequences per signature build) and ``block`` (rows per
    agreement compare) default to what the byte budgets of
    :mod:`.ops.minhash` allow.

    Unlike the reference the result is reproducible: the murmur seed
    family is drawn from a seeded mt19937 bit-compatible with a seeded C++
    HashFamily.
    """
    _check_mh_args(sequences, k, n_hash)
    dev = _resolve_device(device)
    with span("similarity_mh"):
        with span("mh.encode"):
            # MH hashes raw bytes; any character is hashable (the
            # reference accepts arbitrary strings too)
            enc = encode(sequences, validate=False)
        sigs = minhash_signatures(
            enc.ascii, enc.lengths, k=k, n_hash=n_hash, seed=seed,
            chunk=chunk, device=dev,
        )
        return signature_similarity(sigs, block=block)


class MinHashEngine:
    """Signature-caching MinHash similarity engine for recursive callers.

    ``similarity_mh`` rebuilds per-sequence signatures on every call, so
    a recursive caller like :func:`dynaalign_torch.cluster.clusterbreak`
    would pay the signature build once per recursion subset.  A
    sequence's signature depends only on (sequence, k, n_hash, seed), not
    on which batch it is computed in (src/minHash.cpp:143-157 is
    per-sequence), so this engine builds signatures once for the full set
    and serves any subset's similarity matrix from the cached rows.
    Equal to ``similarity_mh`` on the same subset.

    Duplicate sequences share one signature row (same string, same
    signature, exactly as recomputation would give).  Calling it with a
    sequence outside the constructor set raises KeyError.  Every call
    returns a fresh array, which the caller may overwrite (``clusterbreak``
    zeroes the entries under its threshold in place in the engine it
    builds itself).

    Usage: ``clusterbreak(pep, sim_fn=MinHashEngine(pep, k=2))``, or leave
    ``sim_fn=None``: clusterbreak builds one itself.
    """

    def __init__(
        self,
        sequences: Sequence[str],
        k: int = 4,
        n_hash: int = 50,
        *,
        seed: int = 0,
        device=None,
        chunk: int | None = None,
        block: int | None = None,
        cache_counts: bool | None = None,
    ):
        _check_mh_args(sequences, k, n_hash)
        dev = _resolve_device(device)
        with span("mh.encode"):
            enc = encode(sequences, validate=False)
        sigs = minhash_signatures(
            enc.ascii, enc.lengths, k=k, n_hash=n_hash, seed=seed,
            chunk=chunk, device=dev,
        )
        self._setup(sequences, sigs, k, n_hash, seed, block, cache_counts)

    @classmethod
    def from_signatures(
        cls,
        sequences: Sequence[str],
        sigs: np.ndarray,
        *,
        k: int,
        n_hash: int,
        seed: int,
        device=None,
        block: int | None = None,
        cache_counts: bool | None = None,
    ) -> "MinHashEngine":
        """An engine over signatures computed elsewhere: ``sigs`` is the
        uint32 [N, n_hash] array of ``sequences`` under (k, n_hash, seed),
        row i for ``sequences[i]``."""
        _check_mh_args(sequences, k, n_hash)
        sigs = np.asarray(sigs)
        if sigs.shape != (len(sequences), n_hash):
            raise ValueError(
                f"signatures of shape {sigs.shape} for {len(sequences)} "
                f"sequences and n_hash={n_hash}"
            )
        self = cls.__new__(cls)
        self._setup(sequences, as_signatures(sigs, _resolve_device(device)),
                    k, n_hash, seed, block, cache_counts)
        return self

    def _setup(self, sequences, sigs, k, n_hash, seed, block, cache_counts):
        self._sigs = sigs  # int32 [N, H] bit patterns, on the device
        self._index: dict[str, int] = {}
        for i, s in enumerate(sequences):
            self._index.setdefault(str(s), i)
        self.k = k
        self.n_hash = n_hash
        self.seed = seed
        self._block = block
        # full-matrix count cache: clusterbreak's recursion subsets are
        # all subsets of one set, so every subset similarity is a slice of
        # the full [N, N] agreement counts, computed on the device once.
        # Auto-on up to 16,384 rows: 256 MiB of host counts at n_hash <=
        # 255 (fetch_counts' uint8), 512 MiB of int16, 1 GiB of int32.
        if cache_counts is None:
            cache_counts = len(sigs) <= 16384
        self._cache_counts = cache_counts
        self._counts: np.ndarray | None = None

    def _full_counts(self) -> np.ndarray:
        if self._counts is None:
            self._counts = fetch_counts(signature_agreement_counts(
                self._sigs, block=self._block
            ), self.n_hash)
        return self._counts

    def __call__(self, subset: Sequence[str]) -> np.ndarray:
        if len(subset) == 0:
            raise ValueError("Input sequences vector cannot be empty")
        try:
            rows = np.array(
                [self._index[str(s)] for s in subset], dtype=np.int64
            )
        except KeyError as e:
            raise KeyError(
                f"sequence {e.args[0]!r} not in this MinHashEngine's "
                "signature set"
            ) from None
        if self._cache_counts:
            return counts_to_similarity(
                self._full_counts()[np.ix_(rows, rows)], self.n_hash
            )
        picked = self._sigs[torch.from_numpy(rows).to(self._sigs.device)]
        return signature_similarity(picked, block=self._block)


def _ratio(matches: np.ndarray, length: np.ndarray) -> np.ndarray:
    with span("nw.ratio"), np.errstate(invalid="ignore", divide="ignore"):
        return matches.astype(np.float64) / length


def _gather(idx_a, len_a, idx_b, len_b, r, c):
    """One launch's pair batch: sequences ``r`` of a beside ``c`` of b."""
    return idx_a[r], len_a[r], idx_b[c], len_b[c]


def _fetch(mt, ln):
    """The launches' results as two host arrays, in one copy each."""
    with span("nw.fetch") as sp:
        mt, ln = torch.cat(mt).cpu().numpy(), torch.cat(ln).cpu().numpy()
        sp["bytes"] = mt.nbytes + ln.nbytes
    return mt, ln


def _fill(n: int, vals: np.ndarray) -> np.ndarray:
    """Symmetric [n, n] matrix from its row-major upper triangle
    (src/pairwiseSeqAlign.cpp:349-350)."""
    with span("nw.fill"):
        iu_np = np.triu_indices(n)
        sims = np.zeros((n, n), dtype=np.float64)
        sims[iu_np] = vals
        sims.T[iu_np] = vals
    return sims


def _pairs_nw(idx_a, len_a, idx_b, len_b, rows, cols, sub, gap_open,
              gap_ext, chunk, progress=False):
    """(matches, length) of pairs (idx_a[rows[k]], idx_b[cols[k]]), all on
    the device, streamed in launches of at most ``chunk`` pairs and
    LAUNCH_BYTES bytes, and fetched once; ``progress`` prints a line as
    each launch is enqueued."""
    per_pair = pair_bytes(idx_a.shape[1], idx_b.shape[1])
    chunk = max(1, min(chunk, LAUNCH_BYTES // per_pair))
    n_launch = -(-rows.numel() // chunk)
    mt, ln = [], []
    for k, s in enumerate(range(0, rows.numel(), chunk)):
        with span("nw.launch"):
            batch = _gather(idx_a, len_a, idx_b, len_b, rows[s : s + chunk],
                            cols[s : s + chunk])
            res = nw_batch(*batch, sub, gap_open=gap_open, gap_ext=gap_ext)
        mt.append(res.matches)
        ln.append(res.length)
        if progress:
            print(f"nw: launch {k + 1}/{n_launch} ({chunk} pairs each)",
                  flush=True)
    return _fetch(mt, ln)


def similarity_nw(
    sequences: Sequence[str],
    matrix_name: str = "BLOSUM62",
    gap_open: int = 10,
    gap_ext: int = 4,
    *,
    progress: bool = False,
    device=None,
    chunk: int | None = None,
) -> np.ndarray:
    """Exact NW percent-identity similarity matrix (reference similarityNW).

    Bit-identical to the reference semantics (validated against the C++
    oracle): affine-gap Gotoh DP, traceback-path percent identity, priority
    D > U > L, border/interior gap asymmetry.  Every pair of the upper
    triangle, diagonal included (src/pairwiseSeqAlign.cpp:342), is aligned
    with the lower index as sequence 1.  The encoded set goes to the device
    once; the pair list is streamed in ``chunk``-pair launches, and
    ``progress`` prints one line per launch.
    """
    n = len(sequences)
    if n == 0:
        raise ValueError("Input sequences vector cannot be empty")
    dev = _resolve_device(device)
    sub = blosum.get_matrix(matrix_name, device=dev)
    with span("similarity_nw"):
        with span("nw.encode"):
            enc = encode(sequences)
            idx = torch.from_numpy(enc.indices).to(dev)
            lens = torch.from_numpy(enc.lengths).to(dev)
            iu = torch.triu_indices(n, n, device=dev)  # row-major, i <= j
        mt, ln = _pairs_nw(idx, lens, idx, lens, iu[0], iu[1], sub,
                           gap_open, gap_ext, chunk or DEFAULT_CHUNK,
                           progress)
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
    with span("nw.encode"):
        buckets = bucket_by_length(seqs, bucket_edges=bucket_edges)
        which = np.zeros(n, dtype=np.int64)  # global index -> bucket id
        local = np.zeros(n, dtype=np.int64)  # global index -> index in it
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
        with span("nw.fill"):
            matches[gi[sel], gj[sel]] = mt
            length[gi[sel], gj[sel]] = ln
            matches[gj[sel], gi[sel]] = mt
            length[gj[sel], gi[sel]] = ln
    return _ratio(matches, length)
