"""Wrappers of the CUDA NW kernels ``csrc/nw_gotoh.cu`` and
``csrc/nw_gotoh_xl.cu``.

The counterparts of the JAX package's ``ops/nw_pallas.py``, where both TPU
wrappers live too: same signature and result as the plain version
:func:`dynaalign_torch.ops.nw.nw_similarity_batch`.  Each wrapper alone
decides where a batch runs: a CUDA tensor always goes to its kernel, a CPU
tensor to the plain version, anything else raises.  ``LAUNCHES`` and
``LAUNCHES_XL`` count the two kernels' launches.

What the kernels take beyond the plain version's contract: substitution
scores in [-128, 127] (they travel as int8), gap penalties in [0, 2**20]
(so the INT_MIN / 2 sentinel cannot wrap), alphabet indices in [0, 24]
(the query profile holds those symbols), and, for ``nw_gotoh``, padded
max(M, N) + 1 <= ``MAX_MP1`` (its strips' boundary row lives in shared
memory).
"""

from __future__ import annotations

import ctypes
import functools
import os
import re

import torch

from . import _build
from .nw import NWResult, nw_similarity_batch

LAUNCHES = 0  # nw_gotoh launches in this process; reset to 0 to count a run
LAUNCHES_XL = 0  # nw_gotoh_xl launches, likewise

LAST_INSTANCE = None  # the INSTANCES index of the last nw_gotoh launch

# Largest padded max(m, n)+1 that nw_gotoh takes: the range of the TPU
# kernel it ports, the JAX package's PALLAS_MAX_MP1 (ops/nw_pallas.py).
MAX_MP1 = 1120
MAX_GAP = 1 << 20
MAX_SYMBOL = 24  # the 24-letter alphabet and PAD: the profile's NW_SYMS - 1

# int32 scratch planes of N+1 columns per pair.  nw_gotoh keeps its DP
# state in registers and shared memory; nw_gotoh_xl's boundary row is M, Ix
# and the path as one word or as two (MT, LN), whichever its launcher takes
# for the width: the wrapper allocates the larger.
SCRATCH_PLANES = {"nw_gotoh": 0, "nw_gotoh_xl": 4}


def _source(name: str) -> str:
    with open(os.path.join(_build.CSRC, name)) as f:
        return f.read()


# nw_gotoh's instantiations, (lanes per pair G, rows per lane R), read from
# csrc/nw_gotoh.cu's NW_INSTANCES, in its order; one strip holds G * R rows.
INSTANCES = tuple(
    (int(g), int(r)) for g, r in
    re.findall(r"\bX\(\d+, (\d+), (\d+)\)", _source("nw_gotoh.cu")))
# DP rows a pass of nw_gotoh_xl's warp covers: 32 lanes of XL_R rows
XL_STRIP = 32 * int(
    re.search(r"#define XL_R (\d+)", _source("nw_gotoh_xl.cu"))[1])

_VP, _INT = ctypes.c_void_p, ctypes.c_int
# Pointers must be c_void_p: an undeclared int argument is passed as 32
# bits and cuts the pointer.
# nw_gotoh_xl: a_idx, a_len, b_idx, b_len, sub transposed, B, M, N,
# gap_open, gap_ext, path words (0: the launcher picks by width), scratch,
# out_mt, out_ln, stream
LAUNCH_ARGTYPES = (
    _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT,
    _INT, _VP, _VP, _VP, _VP,
)
# nw_gotoh: ..., gap_ext, instance, largest a_len, out_mt, out_ln, stream
LAUNCH_ARGTYPES_NW = (
    _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT,
    _INT, _INT, _VP, _VP, _VP,
)


def pick_instance(a_max: int) -> int:
    """The first of INSTANCES whose strip holds ``a_max`` rows, else the
    last, which runs longer pairs in several strips."""
    for k, (g, r) in enumerate(INSTANCES):
        if a_max <= g * r:
            return k
    return len(INSTANCES) - 1


@functools.cache
def _launcher(name: str):
    fn = getattr(_build.load(name), f"{name}_launch")
    fn.argtypes = list(LAUNCH_ARGTYPES_NW if name == "nw_gotoh"
                       else LAUNCH_ARGTYPES)
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


def _check_values(a_idx, a_len, b_idx, b_len, sub) -> int:
    """Raise unless 0 <= a_len <= M and 0 <= b_len <= N (the kernels read
    a[i-1] for i <= a_len and b[j-1] for j <= b_len unchecked), the scores
    fit int8 and the symbols lie in [0, MAX_SYMBOL], as the kernels carry
    them.  Returns the largest a_len.  One host sync per call."""
    m, n = a_idx.shape[1], b_idx.shape[1]
    ia, ib = a_idx.aminmax(), b_idx.aminmax()  # one pass over each
    lo_a, hi_a, lo_b, hi_b, lo_s, hi_s, lo_i, hi_i = torch.stack(
        [a_len.min(), a_len.max(), b_len.min(), b_len.max(), sub.min(),
         sub.max(), torch.minimum(ia.min, ib.min),
         torch.maximum(ia.max, ib.max)]
    ).tolist()
    if min(lo_a, lo_b) < 0 or hi_a > m or hi_b > n:
        raise ValueError(
            f"lengths out of range: a_len in [{lo_a}, {hi_a}] with M={m}, "
            f"b_len in [{lo_b}, {hi_b}] with N={n}"
        )
    if lo_s < -128 or hi_s > 127:
        raise ValueError(f"sub must lie in [-128, 127], got [{lo_s}, {hi_s}]")
    if lo_i < 0 or hi_i > MAX_SYMBOL:
        raise ValueError(f"alphabet indices must lie in [0, {MAX_SYMBOL}], "
                         f"got [{lo_i}, {hi_i}]")
    return hi_a


def _run(name, a_idx, a_len, b_idx, b_len, sub, gap_open, gap_ext,
         xl_words=0):
    """Check, then the plain version for CPU tensors or kernel ``name``
    for CUDA tensors.  Returns (result, launched).  ``xl_words``: 0 lets
    nw_gotoh_xl's launcher carry MT and LN in one word or two by the width;
    2 makes it two at any width (for the checks of that instantiation)."""
    global LAST_INSTANCE
    _check_inputs(a_idx, a_len, b_idx, b_len, sub)
    dev = a_idx.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no NW kernel for device {dev}")
    if not (0 <= gap_open <= MAX_GAP and 0 <= gap_ext <= MAX_GAP):
        raise ValueError(f"gap penalties must lie in [0, {MAX_GAP}], got "
                         f"({gap_open}, {gap_ext})")
    bsz, m = a_idx.shape
    n = b_idx.shape[1]
    a_max = _check_values(a_idx, a_len, b_idx, b_len, sub) if bsz else 0
    if dev.type == "cpu":
        return nw_similarity_batch(
            a_idx, a_len, b_idx, b_len, sub,
            gap_open=gap_open, gap_ext=gap_ext,
        ), False
    out_mt = torch.empty(bsz, dtype=torch.int32, device=dev)
    out_ln = torch.empty(bsz, dtype=torch.int32, device=dev)
    if bsz == 0:
        return NWResult(out_mt, out_ln), False
    if name == "nw_gotoh":
        if max(m, n) + 1 > MAX_MP1:
            raise ValueError(
                f"nw_gotoh takes padded max(M, N)+1 <= {MAX_MP1}, got M={m}, "
                f"N={n}; nw_similarity_batch_cuda_xl takes any width")
        LAST_INSTANCE = pick_instance(a_max)
        mid = (LAST_INSTANCE, a_max)
    else:
        scratch = torch.empty(SCRATCH_PLANES[name] * (n + 1) * bsz,
                              dtype=torch.int32, device=dev)
        mid = (xl_words, scratch.data_ptr())
    launch = _launcher(name)
    sub_t = sub.t().contiguous()  # the kernels read the table as [b][a]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            a_idx.data_ptr(), a_len.data_ptr(), b_idx.data_ptr(),
            b_len.data_ptr(), sub_t.data_ptr(), bsz, m, n, gap_open, gap_ext,
            *mid, out_mt.data_ptr(), out_ln.data_ptr(), stream,
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
    """(matches, alignment_length) per pair: through ``nw_gotoh`` (a group
    of lanes per pair, padded max(M, N)+1 <= MAX_MP1) for CUDA tensors, the
    plain version for CPU tensors."""
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
