"""Wrappers of the CUDA NW kernels ``csrc/nw_gotoh.cu`` and
``csrc/nw_gotoh_xl.cu``.

The counterparts of the JAX package's ``ops/nw_pallas.py``, where both TPU
wrappers live too: same signature and result as the plain version
:func:`dynaalign_torch.ops.nw.nw_similarity_batch`.  Each wrapper alone
decides where a batch runs: a CUDA tensor always goes to its kernel, a CPU
tensor to the plain version, anything else raises.  ``LAUNCHES`` and
``LAUNCHES_XL`` count the two kernels' launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .nw import NWResult, nw_similarity_batch

LAUNCHES = 0  # nw_gotoh launches in this process; reset to 0 to count a run
LAUNCHES_XL = 0  # nw_gotoh_xl launches, likewise

# int32 scratch planes of N+1 columns per pair: nw_gotoh's row buffers
# (M, Ix, Iy, MT, LN) plus its copy of b; nw_gotoh_xl's boundary row.
SCRATCH_PLANES = {"nw_gotoh": 6, "nw_gotoh_xl": 5}

_VP, _INT = ctypes.c_void_p, ctypes.c_int
# a_idx, a_len, b_idx, b_len, sub, B, M, N, gap_open, gap_ext,
# scratch, out_mt, out_ln, stream (both kernels).  Pointers must be
# c_void_p: an undeclared int argument is passed as 32 bits and cuts the
# pointer.
LAUNCH_ARGTYPES = (
    _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT,
    _VP, _VP, _VP, _VP,
)


@functools.cache
def _launcher(name: str):
    fn = getattr(_build.load(name), f"{name}_launch")
    fn.argtypes = list(LAUNCH_ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(a_idx, a_len, b_idx, b_len, sub) -> None:
    """Raise on anything the kernels do not take."""
    named = dict(a_idx=a_idx, a_len=a_len, b_idx=b_idx, b_len=b_len, sub=sub)
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != a_idx.device:
            raise ValueError(f"{name} is on {t.device}, a_idx on {a_idx.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a_idx.dim() != 2 or b_idx.dim() != 2:
        raise ValueError("a_idx and b_idx must be [B, L]")
    bsz = a_idx.shape[0]
    if b_idx.shape[0] != bsz or a_len.shape != (bsz,) or b_len.shape != (bsz,):
        raise ValueError(
            f"batch mismatch: a_idx {tuple(a_idx.shape)}, b_idx "
            f"{tuple(b_idx.shape)}, a_len {tuple(a_len.shape)}, b_len "
            f"{tuple(b_len.shape)}"
        )
    if a_idx.shape[1] < 1 or b_idx.shape[1] < 1:
        raise ValueError("padded widths must be >= 1")
    if tuple(sub.shape) != (32, 32):
        raise ValueError(f"sub must be [32, 32], got {tuple(sub.shape)}")


def _check_lengths(a_len, b_len, m: int, n: int) -> None:
    """Raise unless 0 <= a_len <= M and 0 <= b_len <= N: the kernels read
    a[i-1] for i <= a_len and write scratch columns j <= b_len unchecked.
    One host sync per call."""
    lo_a, hi_a, lo_b, hi_b = torch.stack(
        [a_len.min(), a_len.max(), b_len.min(), b_len.max()]
    ).tolist()
    if min(lo_a, lo_b) < 0 or hi_a > m or hi_b > n:
        raise ValueError(
            f"lengths out of range: a_len in [{lo_a}, {hi_a}] with M={m}, "
            f"b_len in [{lo_b}, {hi_b}] with N={n}"
        )


def _run(name, a_idx, a_len, b_idx, b_len, sub, gap_open, gap_ext):
    """Check, then the plain version for CPU tensors or kernel ``name``
    for CUDA tensors.  Returns (result, launched)."""
    _check_inputs(a_idx, a_len, b_idx, b_len, sub)
    dev = a_idx.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no NW kernel for device {dev}")
    bsz, m = a_idx.shape
    n = b_idx.shape[1]
    if bsz:
        _check_lengths(a_len, b_len, m, n)
    if dev.type == "cpu":
        return nw_similarity_batch(
            a_idx, a_len, b_idx, b_len, sub,
            gap_open=gap_open, gap_ext=gap_ext,
        ), False
    out_mt = torch.empty(bsz, dtype=torch.int32, device=dev)
    out_ln = torch.empty(bsz, dtype=torch.int32, device=dev)
    if bsz == 0:
        return NWResult(out_mt, out_ln), False
    launch = _launcher(name)
    scratch = torch.empty(SCRATCH_PLANES[name] * (n + 1) * bsz,
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            a_idx.data_ptr(), a_len.data_ptr(), b_idx.data_ptr(),
            b_len.data_ptr(), sub.data_ptr(), bsz, m, n, gap_open, gap_ext,
            scratch.data_ptr(), out_mt.data_ptr(), out_ln.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return NWResult(out_mt, out_ln), True


def nw_similarity_batch_cuda(
    a_idx: torch.Tensor,  # int32 [B, M]
    a_len: torch.Tensor,  # int32 [B], each <= M
    b_idx: torch.Tensor,  # int32 [B, N]
    b_len: torch.Tensor,  # int32 [B], each <= N
    sub: torch.Tensor,  # int32 [32, 32]
    *,
    gap_open: int = 10,
    gap_ext: int = 4,
) -> NWResult:
    """(matches, alignment_length) per pair: through ``nw_gotoh`` (one
    thread per pair) for CUDA tensors, the plain version for CPU tensors."""
    global LAUNCHES
    res, launched = _run("nw_gotoh", a_idx, a_len, b_idx, b_len, sub,
                         gap_open, gap_ext)
    LAUNCHES += launched
    return res


def nw_similarity_batch_cuda_xl(
    a_idx: torch.Tensor,  # int32 [B, M]
    a_len: torch.Tensor,  # int32 [B], each <= M
    b_idx: torch.Tensor,  # int32 [B, N]
    b_len: torch.Tensor,  # int32 [B], each <= N
    sub: torch.Tensor,  # int32 [32, 32]
    *,
    gap_open: int = 10,
    gap_ext: int = 4,
) -> NWResult:
    """(matches, alignment_length) per pair: through ``nw_gotoh_xl`` (one
    warp per pair, for long pairs; any length) for CUDA tensors, the plain
    version for CPU tensors."""
    global LAUNCHES_XL
    res, launched = _run("nw_gotoh_xl", a_idx, a_len, b_idx, b_len, sub,
                         gap_open, gap_ext)
    LAUNCHES_XL += launched
    return res
