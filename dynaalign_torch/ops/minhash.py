"""MinHash signatures and signature agreement, as PyTorch tensor code.

Behavioural spec: reference src/minHash.cpp:119-188 (``similarityMH``).
The reference's two hot loops are two functions here:

* HOT LOOP 1 (signature build, src/minHash.cpp:143-157) is a ``[n, P, H]``
  hash tensor min-reduced over window positions, chunked over sequences by
  a byte budget (``HASH_BYTES``).
* HOT LOOP 2 (pair similarity, src/minHash.cpp:160-178) is a blocked
  all-pairs agreement count: each row block compares ``[b, 1, H]`` with
  ``[1, N, H]`` and sums over H.  Eager PyTorch materialises the
  ``[b, N, H]`` booleans, so the block is sized from a byte budget too
  (``COMPARE_BYTES``).

Signatures are uint32 values carried as ``torch.int32`` bit patterns
(see :mod:`.murmur3`); :func:`signatures_to_numpy` gives the uint32 array.

Edge-case parity (preserved deliberately): a sequence shorter than k keeps
the all-UINT32_MAX init signature and therefore scores similarity 1.0
against any other too-short sequence.

Reproducibility: unlike the reference (seeded from std::random_device,
src/minHash.cpp:73), the hash family takes an explicit ``seed`` (default
0) drawn through an mt19937 bit-compatible with a seeded build of the
reference (utils/mt19937.py).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve_device
from ..utils.mt19937 import hash_family_seeds
from ..utils.profiling import span
from .murmur3 import murmur3_kmer_hashes, seeds_tensor

# most bytes of one chunk's [chunk, P, H] int32 hash tensor; eager PyTorch
# holds about four temporaries of that size while it hashes
HASH_BYTES = 1 << 30
# most bytes of one row block's [block, N, H] boolean compare
COMPARE_BYTES = 1 << 30
# least float64 output bytes of one pooled row block in
# counts_to_similarity: a matrix under two blocks (about 724 x 724) divides
# on the calling thread, where starting threads would cost what they save
SIMILARITY_BLOCK_BYTES = 1 << 21

_INT32_MIN = -(1 << 31)
_INT32_MAX = (1 << 31) - 1


def _signatures_chunk(ascii_tokens, lengths, seeds, k: int) -> torch.Tensor:
    hashes = murmur3_kmer_hashes(ascii_tokens, k, seeds)  # [n, P, H]
    p = hashes.shape[1]
    pos = torch.arange(p, dtype=torch.int32, device=hashes.device)[None, :]
    valid = (pos + k) <= lengths[:, None]  # [n, P]
    # the min is unsigned: flipping the sign bit maps uint32 order onto
    # int32 order, and UINT32_MAX (invalid windows) onto INT32_MAX
    hashes = hashes ^ _INT32_MIN
    hashes.masked_fill_(~valid[:, :, None], _INT32_MAX)
    return hashes.amin(dim=1) ^ _INT32_MIN


def minhash_signatures(
    ascii_tokens: np.ndarray | torch.Tensor,
    lengths: np.ndarray | torch.Tensor,
    *,
    k: int = 4,
    n_hash: int = 50,
    seed: int = 0,
    chunk: int | None = None,
    device=None,
) -> torch.Tensor:
    """MinHash signatures int32 [N, H] (uint32 bit patterns) on ``device``
    for a padded ascii batch.

    Chunked over sequences; ``chunk=None`` (default) takes as many as keep
    the [chunk, P, H] hash tensor within ``HASH_BYTES``.  The chunks'
    results are joined on the device.
    """
    if k <= 0:
        raise ValueError("'k' must be a positive integer")
    if n_hash <= 0:
        raise ValueError("Number of hash functions must be positive")
    dev = resolve_device(device)
    ascii_tokens = torch.as_tensor(ascii_tokens, dtype=torch.uint8).to(dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32).to(dev)
    n, length = ascii_tokens.shape
    if length < k:
        # every sequence is shorter than k: all-max signatures
        return torch.full((n, n_hash), -1, dtype=torch.int32, device=dev)
    if chunk is None:
        chunk = max(1, HASH_BYTES // (4 * (length - k + 1) * n_hash))
    with span("mh.signatures"):
        seeds = seeds_tensor(hash_family_seeds(n_hash, seed), dev)
        return torch.cat([
            _signatures_chunk(ascii_tokens[s : s + chunk],
                              lengths[s : s + chunk], seeds, k)
            for s in range(0, n, chunk)
        ])


def signatures_to_numpy(sigs: torch.Tensor) -> np.ndarray:
    """Signatures as the uint32 [N, H] host array the oracle produces."""
    return sigs.cpu().numpy().view(np.uint32)


def as_signatures(sigs: np.ndarray | torch.Tensor, device=None):
    """Signatures as an int32 [N, H] tensor of bit patterns.  A tensor
    stays on its own device unless ``device`` names one; a host array
    (uint32) goes to ``device``, by default the card."""
    if isinstance(sigs, torch.Tensor):
        if sigs.dtype != torch.int32 or sigs.dim() != 2:
            raise ValueError("signature tensors are int32 [N, H] bit "
                             f"patterns, got {sigs.dtype} {tuple(sigs.shape)}")
        return sigs if device is None else sigs.to(resolve_device(device))
    bits = np.array(sigs, dtype=np.uint32, order="C")  # a writable copy
    if bits.ndim != 2:
        raise ValueError(f"signatures are [N, H], got shape {bits.shape}")
    return torch.from_numpy(bits.view(np.int32)).to(resolve_device(device))


def row_block(n: int, n_hash: int) -> int:
    """Rows of a block whose [block, n, n_hash] compare fits
    ``COMPARE_BYTES``."""
    return max(1, COMPARE_BYTES // max(n * n_hash, 1))


def block_counts(sigs: torch.Tensor, start: int, stop: int,
                 other: torch.Tensor | None = None) -> torch.Tensor:
    """int32 [stop - start, M]: agreeing slots of rows start:stop against
    every row of ``other`` (default ``sigs``, M = N)."""
    other = sigs if other is None else other
    eq = sigs[start:stop, None, :] == other[None, :, :]  # [b, M, H]
    return eq.sum(dim=-1, dtype=torch.int32)


def signature_agreement_counts(
    sigs: np.ndarray | torch.Tensor, *, block: int | None = None,
    device=None,
) -> torch.Tensor:
    """int32 [N, N] count of agreeing signature slots per pair, on the
    device.  ``block=None`` sizes the row block from ``COMPARE_BYTES``."""
    sigs = as_signatures(sigs, device)
    n, n_hash = sigs.shape
    block = block or row_block(n, n_hash)
    with span("mh.compare"):
        out = torch.empty((n, n), dtype=torch.int32, device=sigs.device)
        for s in range(0, n, block):
            out[s : s + block] = block_counts(sigs, s, min(s + block, n))
    return out


def count_dtype(n_hash: int) -> torch.dtype:
    """The narrowest integer dtype that holds every count 0..n_hash."""
    if n_hash <= 255:
        return torch.uint8
    if n_hash <= 32767:
        return torch.int16
    return torch.int32


def fetch_counts(counts: torch.Tensor, n_hash: int) -> np.ndarray:
    """The [N, N] counts as a host array, in one copy, cast first on the
    device to the narrowest integer dtype that holds ``n_hash``."""
    with span("mh.fetch") as sp:
        out = counts.to(count_dtype(n_hash)).cpu().numpy()
        sp["bytes"] = out.nbytes
    return out


def _row_bounds(n: int, m: int) -> list[tuple[int, int]]:
    """Row ranges of the divide: as many as the process's intra-op threads,
    each at least ``SIMILARITY_BLOCK_BYTES`` of output; one below that."""
    blocks = min(torch.get_num_threads(),
                 n * m * 8 // SIMILARITY_BLOCK_BYTES, n)
    if blocks <= 1:
        return [(0, n)]
    cuts = [n * i // blocks for i in range(blocks + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def counts_to_similarity(counts: np.ndarray, n_hash: int) -> np.ndarray:
    """A fresh float64 [n, m] array of count / n_hash, diagonal 1.0.

    One IEEE float64 divide an entry straight into the result (the C++
    double division, src/minHash.cpp:174), in row blocks on a thread pool
    above ``SIMILARITY_BLOCK_BYTES``; numpy's divide releases the GIL.
    """
    n, m = counts.shape
    with span("mh.similarity") as sp:
        sims = np.empty((n, m), np.float64)
        d = float(n_hash)

        def divide(bounds):
            a, b = bounds
            np.divide(counts[a:b], d, out=sims[a:b], dtype=np.float64)

        bounds = _row_bounds(n, m)
        if len(bounds) == 1:
            divide(bounds[0])
            sp["workers"] = 0
        else:
            with ThreadPoolExecutor(len(bounds)) as pool:
                list(pool.map(divide, bounds))
            sp["workers"] = len(bounds)
        np.fill_diagonal(sims, 1.0)
    return sims


def signature_similarity(
    sigs: np.ndarray | torch.Tensor, *, block: int | None = None,
    device=None,
) -> np.ndarray:
    """Symmetric [N, N] float64 similarity = fraction of agreeing slots.

    matches/n_hash is divided in float64 on the host, matching the C++
    double division (src/minHash.cpp:174) bit for bit.  Diagonal is
    exactly 1.0 (reference sets it explicitly, src/minHash.cpp:161).
    """
    sigs = as_signatures(sigs, device)
    n_hash = sigs.shape[1]
    counts = signature_agreement_counts(sigs, block=block)
    return counts_to_similarity(fetch_counts(counts, n_hash), n_hash)
