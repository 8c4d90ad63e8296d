"""ctypes binding to the native MSA profile-DP row sweep (cpp/msa_dp.cpp).

Built on demand into ``build/msadp/``
(:func:`dynaalign_torch.utils.native.build_library`); a failed build
raises, and there is no switch that turns it off.  The native sweep is an
exact IEEE-double transcription of the numpy row DP in :mod:`.msa`
(``_numpy_row_dp``), so tracebacks are bit-identical; that rests on the
strict ``-std=c++17`` of the build, which keeps multiply-adds from being
contracted.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..utils.native import build_library

_F64P = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library("msadp", ("msa_dp.cpp",)))
    lib.dyna_msa_row_dp.restype = None
    lib.dyna_msa_row_dp.argtypes = [
        _F64P, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, _U8P,
    ]
    return lib


def native_row_dp(score_rows: np.ndarray, go: float, ge: float) -> np.ndarray:
    """Traceback matrix tb [m+1, n+1] (0=D, 1=U, 2=L) of the affine-gap
    global DP over the score matrix ``score_rows`` [m, n]."""
    sr = np.ascontiguousarray(score_rows, dtype=np.float64)
    if sr.ndim != 2:
        raise ValueError(f"score_rows must be 2-D, got shape {sr.shape}")
    m, n = sr.shape
    tb = np.zeros((m + 1, n + 1), dtype=np.uint8)
    _lib().dyna_msa_row_dp(
        sr.ctypes.data_as(_F64P), ctypes.c_int64(m), ctypes.c_int64(n),
        ctypes.c_double(go), ctypes.c_double(ge), tb.ctypes.data_as(_U8P),
    )
    return tb
