"""ctypes binding to the serial C++ NW oracle (cpp/oracle.cpp).

The oracle pins down the bit-exact NW percent-identity semantics of the
reference (src/pairwiseSeqAlign.cpp): D>U>L tie-breaks, border/interior gap
asymmetry, the INT_MIN/2 sentinel.  Tests and ``chip_smoke.py`` hold the
port against it; the port's own compute path never calls it.

The library is built on demand with ``g++`` into ``build/oracle/`` at the
repository root, named by the hash of its sources.  The build leaves out
``cpp/Makefile``'s ``-fopenmp``, which a toolchain without libgomp cannot
link; the source guards OpenMP with ``#ifdef _OPENMP``, and the serial
all-pairs driver is the baseline anyway.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = [os.path.join(_ROOT, "cpp", f)
            for f in ("oracle.cpp", "blosum_tables.h")]
_BUILD_DIR = os.path.join(_ROOT, "build", "oracle")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


def _build() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    so = os.path.join(_BUILD_DIR, f"liboracle-{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *CXX_FLAGS, _SOURCES[0], "-o", tmp],
                       check=True)
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    return so


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build())
    u8p = ctypes.POINTER(ctypes.c_uint8)
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
    data = _bytes("".join(sequences))
    offsets = np.zeros(len(sequences) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in sequences], out=offsets[1:])
    n = len(sequences)
    out = np.zeros((n, n), dtype=np.float64)
    rc = _lib().dyna_nw_allpairs(
        _u8p(data), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, matrix_name.encode(), gap_open, gap_ext, 1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    _check(rc, matrix_name)
    return out
