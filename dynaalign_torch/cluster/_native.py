"""ctypes binding to the native greedy Louvain pass (cpp/louvain_pass.cpp).

Built on demand into ``build/louvain/``
(:func:`dynaalign_torch.utils.native.build_library`); a failed build
raises.  The native pass is an exact IEEE-double transcription of the numpy
pass in :mod:`.louvain`, so memberships are bit-identical.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..utils.native import build_library

_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library("louvain", ("louvain_pass.cpp",)))
    lib.dyna_louvain_pass.restype = ctypes.c_int64
    lib.dyna_louvain_pass.argtypes = [
        _I64P, _I64P, _F64P, ctypes.c_int64, _F64P,
        ctypes.c_double, ctypes.c_double,
        _I64P, _I64P, _F64P,
    ]
    return lib


def louvain_native_available() -> bool:
    """True once the native pass is built and loaded; a failed build
    raises (nothing falls back to the numpy pass)."""
    return _lib() is not None


def _checked(a: np.ndarray, dtype, size: int, name: str) -> np.ndarray:
    if a.dtype != dtype or not a.flags.c_contiguous or a.shape != (size,):
        raise ValueError(
            f"{name} must be a contiguous {np.dtype(dtype).name} [{size}], "
            f"got {a.dtype} {a.shape}"
        )
    return a


def native_louvain_pass(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    strengths: np.ndarray,
    two_m: float,
    gamma: float,
    order: np.ndarray,
    comm: np.ndarray,
    sum_tot: np.ndarray,
) -> bool:
    """Run one greedy pass in place; returns whether any node moved.

    CSR arrays and ``order`` are contiguous int64 / float64; ``comm``
    (int64) and ``sum_tot`` (float64) are modified in place.
    """
    n = len(comm)
    _checked(indptr, np.int64, n + 1, "indptr")
    nnz = int(indptr[-1])
    _checked(indices, np.int64, nnz, "indices")
    _checked(data, np.float64, nnz, "data")
    _checked(strengths, np.float64, n, "strengths")
    _checked(order, np.int64, n, "order")
    _checked(comm, np.int64, n, "comm")
    _checked(sum_tot, np.float64, n, "sum_tot")
    moved = _lib().dyna_louvain_pass(
        indptr.ctypes.data_as(_I64P),
        indices.ctypes.data_as(_I64P),
        data.ctypes.data_as(_F64P),
        ctypes.c_int64(n),
        strengths.ctypes.data_as(_F64P),
        ctypes.c_double(two_m),
        ctypes.c_double(gamma),
        order.ctypes.data_as(_I64P),
        comm.ctypes.data_as(_I64P),
        sum_tot.ctypes.data_as(_F64P),
    )
    return bool(moved)
