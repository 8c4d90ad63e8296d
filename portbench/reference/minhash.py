"""Plain MinHash, the yardstick of the MinHash cells.

The semantics are the upstream's ``similarityMH`` (DynaAlign
src/minHash.cpp:119-188) with a seeded hash family: the murmur seeds are
the first ``n_hash`` outputs of ``std::mt19937(seed)`` (:73-81), each
k-mer's bytes are hashed by MurmurHash3-32 (:21-64), a signature slot is
the unsigned minimum over the sequence's windows (UINT32_MAX without one),
and a pair's similarity is its agreeing slots over n_hash in double, the
diagonal 1 (:160-178).

Written for this folder and importing nothing of the port: the hash runs
on int64 tensors masked to 32 bits after every step, where the port
carries int32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
# most int64 elements of one chunk's [c, P, H] hash tensor
HASH_ELEMENTS = 1 << 26


def mt19937_outputs(seed: int, count: int) -> list[int]:
    """The first ``count`` outputs of std::mt19937(seed) (Matsumoto and
    Nishimura 1998, init_genrand seeding)."""
    mt = [seed & M32]
    for i in range(1, 624):
        mt.append((1812433253 * (mt[-1] ^ (mt[-1] >> 30)) + i) & M32)
    out, pos = [], 624
    for _ in range(count):
        if pos == 624:
            for i in range(624):
                y = (mt[i] & 0x80000000) | (mt[(i + 1) % 624] & 0x7FFFFFFF)
                mt[i] = mt[(i + 397) % 624] ^ (y >> 1) ^ (
                    0x9908B0DF if y & 1 else 0)
            pos = 0
        y = mt[pos]
        pos += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        out.append(y & M32)
    return out


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x, c below 2**32, in halves of c so that no
    int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def murmur3_windows(tokens: torch.Tensor, k: int,
                    seeds: torch.Tensor) -> torch.Tensor:
    """int64 [n, P, H]: MurmurHash3-32 of every length-k window of the
    uint8 ``tokens`` [n, L] under each seed, P = L - k + 1."""
    n, length = tokens.shape
    p = length - k + 1
    byte = [tokens[:, o : o + p].long() for o in range(k)]
    h = seeds[None, None, :].expand(n, p, -1)
    for b in range(k // 4):
        blk = (byte[4 * b] | (byte[4 * b + 1] << 8) | (byte[4 * b + 2] << 16)
               | (byte[4 * b + 3] << 24))
        kv = _mul(_rotl(_mul(blk, 0xCC9E2D51), 15), 0x1B873593)
        h = h ^ kv[:, :, None]
        h = (_rotl(h, 13) * 5 + 0xE6546B64) & M32
    rem = k & 3
    if rem:
        k1 = byte[4 * (k // 4)]
        for t in range(1, rem):
            k1 = k1 ^ (byte[4 * (k // 4) + t] << (8 * t))
        k1 = _mul(_rotl(_mul(k1, 0xCC9E2D51), 15), 0x1B873593)
        h = h ^ k1[:, :, None]
    h = h ^ k
    h = h ^ (h >> 16)
    h = _mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def signatures(seqs: list[str], k: int, n_hash: int, seed: int,
               device) -> torch.Tensor:
    """int64 [N, n_hash] MinHash signatures (uint32 values) on ``device``."""
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    width = int(lens.max()) if len(seqs) else 0
    out = torch.full((len(seqs), n_hash), M32, dtype=torch.int64,
                     device=device)
    if width < k:
        return out
    seeds = torch.tensor(mt19937_outputs(seed, n_hash), dtype=torch.int64,
                         device=device)
    tok = np.zeros((len(seqs), width), dtype=np.uint8)
    for r, s in enumerate(seqs):
        tok[r, : len(s)] = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
    p = width - k + 1
    chunk = max(1, HASH_ELEMENTS // (p * n_hash))
    for s in range(0, len(seqs), chunk):
        t = torch.from_numpy(tok[s : s + chunk]).to(device)
        h = murmur3_windows(t, k, seeds)
        n_win = torch.from_numpy(lens[s : s + chunk] - k + 1).to(device)
        valid = torch.arange(p, device=device)[None, :] < n_win[:, None]
        h = h.masked_fill(~valid[:, :, None], M32)
        out[s : s + chunk] = h.amin(dim=1)
    return out


def pair_agreements(sigs: torch.Tensor, pairs: np.ndarray) -> np.ndarray:
    """int64 [P]: agreeing slots of each pair (i, j) of ``pairs``."""
    pairs = torch.from_numpy(np.asarray(pairs, dtype=np.int64).reshape(
        -1, 2)).to(sigs.device)
    out = []
    for s in range(0, len(pairs), 1 << 16):
        p = pairs[s : s + (1 << 16)]
        out.append((sigs[p[:, 0]] == sigs[p[:, 1]]).sum(dim=1))
    if not out:
        return np.zeros(0, dtype=np.int64)
    return torch.cat(out).cpu().numpy()


def similarity(agree: np.ndarray, pairs: np.ndarray, n_hash: int,
               dtype=np.float64) -> np.ndarray:
    """agreeing slots / n_hash in ``dtype`` (the upstream's double), as
    float64; a pair (i, i) is 1."""
    pairs = np.asarray(pairs).reshape(-1, 2)
    sim = (agree.astype(dtype) / dtype(n_hash)).astype(np.float64)
    sim[pairs[:, 0] == pairs[:, 1]] = 1.0
    return sim
