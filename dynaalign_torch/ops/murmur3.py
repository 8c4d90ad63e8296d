"""Vectorised MurmurHash3-32 over k-mer windows, as int32 tensor ops.

The reference hashes every k-mer string through murmur3_32 one at a time
(src/minHash.cpp:21-64, called from the signature loop at :143-157).  Here
the hash is arithmetic over a ``[N, P, H]`` tensor (sequences x k-mer
positions x hash seeds); the only loop is the static unroll over the k
bytes of the window.

The arithmetic is unsigned 32-bit, carried in ``torch.int32`` (PyTorch's
``uint32`` has too few operators): a wrapping multiply, add, xor or left
shift of two's-complement words gives the same low 32 bits as the unsigned
operation, and a right shift is made logical by masking off the sign bits
the arithmetic shift drags in.  A tensor of this module therefore holds the
uint32 *bit pattern* of each value: read it on the host with
``.numpy().view(np.uint32)``.

Bit-parity: the reference interprets k-mer bytes as little-endian 4-byte
blocks (x86 ``reinterpret_cast``); blocks are assembled explicitly from
bytes in little-endian order, so hashes match the C++ oracle for any k.
"""

from __future__ import annotations

import numpy as np
import torch


def _i32(x: int) -> int:
    """The Python int whose int32 two's-complement pattern is uint32 x."""
    return x - (1 << 32) if x >= (1 << 31) else x


_C1 = _i32(0xCC9E2D51)
_C2 = _i32(0x1B873593)
_MIX1 = _i32(0x85EBCA6B)
_MIX2 = _i32(0xC2B2AE35)
_N = _i32(0xE6546B64)


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns."""
    return (x >> r) & ((1 << (32 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 32 - r)


def seeds_tensor(seeds: np.ndarray, device) -> torch.Tensor:
    """uint32 [H] murmur seeds as an int32 tensor of the same bits."""
    bits = np.ascontiguousarray(seeds, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(bits).to(device)


def murmur3_kmer_hashes(
    ascii_tokens: torch.Tensor, k: int, seeds: torch.Tensor
) -> torch.Tensor:
    """Hash every length-k window of every sequence under every seed.

    Args:
      ascii_tokens: uint8 [N, L] raw character codes (padding arbitrary:
        callers mask invalid windows afterwards).
      k: k-mer length (>= 1).
      seeds: int32 [H] murmur seeds as bit patterns (:func:`seeds_tensor`),
        on the same device.

    Returns:
      int32 [N, P, H] hash bit patterns, P = L - k + 1 window positions.
    """
    if k < 1:
        raise ValueError("'k' must be a positive integer")
    n, length = ascii_tokens.shape
    if length < k:
        raise ValueError(f"padded length {length} < k={k}")
    p = length - k + 1

    tok = ascii_tokens.to(torch.int32)
    # byte o of each window: [N, P]
    byte = [tok[:, o : o + p] for o in range(k)]

    h = seeds.to(torch.int32)[None, None, :].expand(n, p, -1)

    nblocks = k // 4
    for bi in range(nblocks):
        blk = (
            byte[4 * bi]
            | (byte[4 * bi + 1] << 8)
            | (byte[4 * bi + 2] << 16)
            | (byte[4 * bi + 3] << 24)
        )
        kv = _rotl(blk * _C1, 15) * _C2
        h = h ^ kv[:, :, None]
        h = _rotl(h, 13) * 5 + _N

    rem = k & 3
    if rem:
        k1 = byte[4 * nblocks]
        if rem >= 2:
            k1 = k1 ^ (byte[4 * nblocks + 1] << 8)
        if rem == 3:
            k1 = k1 ^ (byte[4 * nblocks + 2] << 16)
        k1 = _rotl(k1 * _C1, 15) * _C2
        h = h ^ k1[:, :, None]

    h = h ^ k
    h = h ^ _shr(h, 16)
    h = h * _MIX1
    h = h ^ _shr(h, 13)
    h = h * _MIX2
    h = h ^ _shr(h, 16)
    return h
