"""ctypes binding to the serial C++ NW oracle (cpp/oracle.cpp).

The oracle pins down the bit-exact NW percent-identity semantics of the
reference (src/pairwiseSeqAlign.cpp): D>U>L tie-breaks, border/interior gap
asymmetry, the INT_MIN/2 sentinel.  Tests and ``chip_smoke.py`` hold the
port against it; the port's own compute path never calls it.

It also exposes the oracle's MinHash side (murmur3, the seeded hash
family, signatures, the similarity matrix), which the MinHash modules are
held against.

The library is built on demand into ``build/oracle/`` at the repository
root (:func:`dynaalign_torch.utils.native.build_library`), without
OpenMP: the serial all-pairs loop is the baseline anyway.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .utils.native import build_library


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library("oracle", ("oracle.cpp",
                                               "blosum_tables.h")))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.dyna_murmur3_32.restype = ctypes.c_uint32
    lib.dyna_murmur3_32.argtypes = [u8p, ctypes.c_int64, ctypes.c_uint32]
    lib.dyna_hash_family.restype = None
    lib.dyna_hash_family.argtypes = [ctypes.c_int, ctypes.c_uint32, u32p]
    lib.dyna_minhash_signatures.restype = None
    lib.dyna_minhash_signatures.argtypes = [
        u8p, i64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, u32p,
    ]
    lib.dyna_minhash_similarity.restype = None
    lib.dyna_minhash_similarity.argtypes = [
        u8p, i64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, f64p,
    ]
    lib.dyna_nw_pair.restype = ctypes.c_int
    lib.dyna_nw_pair.argtypes = [
        u8p, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
    ]
    lib.dyna_nw_allpairs.restype = ctypes.c_int
    lib.dyna_nw_allpairs.argtypes = [
        u8p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def _bytes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("ascii"), dtype=np.uint8).copy()


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _flatten(sequences: list[str]):
    """(one byte buffer, int64 [n+1] offsets, pointers to both)."""
    data = _bytes("".join(sequences))
    if data.size == 0:
        data = np.zeros(1, dtype=np.uint8)  # a valid pointer, never read
    offsets = np.zeros(len(sequences) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in sequences], out=offsets[1:])
    return (data, offsets, _u8p(data),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))


def murmur3_32(key: bytes, seed: int) -> int:
    """MurmurHash3 x86 32-bit of ``key`` under ``seed``."""
    buf = np.frombuffer(key, dtype=np.uint8).copy()
    if len(buf) == 0:
        buf = np.zeros(1, dtype=np.uint8)
    return int(_lib().dyna_murmur3_32(_u8p(buf), len(key),
                                      seed & 0xFFFFFFFF))


def hash_family(n_hash: int, seed: int) -> np.ndarray:
    """The ``n_hash`` murmur seeds ``std::mt19937(seed)`` draws: uint32."""
    out = np.zeros(n_hash, dtype=np.uint32)
    _lib().dyna_hash_family(
        n_hash, seed & 0xFFFFFFFF,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out


def minhash_signatures(
    sequences: list[str], k: int, n_hash: int, seed: int
) -> np.ndarray:
    """MinHash signatures uint32 [N, n_hash] of the seeded hash family."""
    data, offsets, dp, op = _flatten(sequences)
    out = np.zeros((len(sequences), n_hash), dtype=np.uint32)
    _lib().dyna_minhash_signatures(
        dp, op, len(sequences), k, n_hash, seed & 0xFFFFFFFF,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out


def minhash_similarity(
    sequences: list[str], k: int = 4, n_hash: int = 50, seed: int = 0
) -> np.ndarray:
    """Seeded similarityMH: float64 [N, N], unit diagonal."""
    data, offsets, dp, op = _flatten(sequences)
    n = len(sequences)
    out = np.zeros((n, n), dtype=np.float64)
    _lib().dyna_minhash_similarity(
        dp, op, n, k, n_hash, seed & 0xFFFFFFFF,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def _check(rc: int, matrix_name: str) -> None:
    if rc == -2:
        raise ValueError(f"Invalid substitution matrix name: {matrix_name}")
    if rc != 0:
        raise ValueError("Invalid amino acid in sequence")


def nw_pair(
    s1: str, s2: str, matrix_name: str = "BLOSUM62",
    gap_open: int = 10, gap_ext: int = 4,
) -> float:
    """Percent identity of one pair, ``s1`` as the reference's sequence 1."""
    b1, b2 = _bytes(s1), _bytes(s2)
    out = ctypes.c_double(0.0)
    rc = _lib().dyna_nw_pair(
        _u8p(b1), len(b1), _u8p(b2), len(b2), matrix_name.encode(),
        gap_open, gap_ext, ctypes.byref(out),
    )
    _check(rc, matrix_name)
    return out.value


def nw_similarity(
    sequences: list[str], matrix_name: str = "BLOSUM62",
    gap_open: int = 10, gap_ext: int = 4,
) -> np.ndarray:
    """All-pairs NW percent-identity matrix [N, N] in float64, serial like
    the reference's similarityNW driver (src/pairwiseSeqAlign.cpp:340-352).
    """
    data, offsets, dp, op = _flatten(sequences)
    n = len(sequences)
    out = np.zeros((n, n), dtype=np.float64)
    rc = _lib().dyna_nw_allpairs(
        dp, op, n, matrix_name.encode(), gap_open, gap_ext, 1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    _check(rc, matrix_name)
    return out
