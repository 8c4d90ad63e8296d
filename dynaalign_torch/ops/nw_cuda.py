"""Wrappers of the CUDA NW kernels ``csrc/nw_gotoh.cu`` and
``csrc/nw_gotoh_xl.cu``.

The counterparts of the JAX package's ``ops/nw_pallas.py``, where both TPU
wrappers live too: same signature and result as the plain version
:func:`dynaalign_torch.ops.nw.nw_similarity_batch`.  Each wrapper alone
decides where a batch runs: a CUDA tensor always goes to its kernel, a CPU
tensor to the plain version, anything else raises.  Each launch is a
span of :mod:`..utils.profiling` named for its kernel, which counts it;
:func:`launches` reads those counts back, and the counter
``nw_gotoh_xl.items`` holds the work items launched.  The checks each
launch waits in are the span ``nw_gotoh.check``.  ``nw_gotoh_xl`` takes its
work from a table of (pair, strip) items, longest pair first, which
:func:`xl_work_table` builds on the card.

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

from ..utils.profiling import counters, span
from . import _build
from .nw import NWResult, nw_similarity_batch

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
# Device bytes of one nw_gotoh_xl work item (one strip of a pair): its
# (pair, strip) entry and its progress word, 12, and what xl_work_table
# holds besides while it builds the entry, 12.  A pair also takes
# XL_PAIR_BYTES there: its int64 sort key, order, strip count and offset.
XL_ITEM_BYTES = 24
XL_PAIR_BYTES = 32


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
# gap_open, gap_ext, path words (0: the launcher picks by width), work
# table, its items, boundary rows, queue counter, progress words, out_mt,
# out_ln, stream
LAUNCH_ARGTYPES = (
    _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT,
    _INT, _VP, _INT, _VP, _VP, _VP, _VP, _VP, _VP,
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
def bind(lib: ctypes.CDLL, name: str):
    """``lib``'s launch function of kernel ``name``, its argument types
    declared."""
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = list(LAUNCH_ARGTYPES_NW if name == "nw_gotoh"
                       else LAUNCH_ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    return _build.load(name)


def xl_strips(a_len: torch.Tensor, b_len: torch.Tensor,
              strip: int) -> torch.Tensor:
    """int64 [B]: nw_gotoh_xl's work items for each pair, its
    ceil(a_len / strip) strips of ``strip`` rows, or one for a pair without
    cells (a_len or b_len 0), which writes the border result."""
    return torch.where((a_len > 0) & (b_len > 0),
                       (a_len.long() + strip - 1) // strip, 1)


def xl_work_table(a_len: torch.Tensor, b_len: torch.Tensor, strip: int,
                  n_items: int) -> torch.Tensor:
    """nw_gotoh_xl's queue, int32 [n_items, 2] of (pair, strip): the pairs
    by a_len * b_len descending, ties by index, each expanded into its
    strips in order (:func:`xl_strips`).  ``n_items`` is the sum of
    xl_strips, which the caller has fetched with its checks: tensors on the
    card, no host sync here."""
    cells = a_len.long() * b_len.long()
    order = torch.argsort(cells, descending=True, stable=True)
    strips = xl_strips(a_len, b_len, strip)[order]
    pair = order.int().repeat_interleave(strips, output_size=n_items)
    first = (strips.cumsum(0) - strips).int().repeat_interleave(
        strips, output_size=n_items)
    k = torch.arange(n_items, dtype=torch.int32, device=a_len.device)
    return torch.stack([pair, k - first], 1)


def prepare_xl(lib, a_idx, a_len, b_idx, b_len, sub, gap_open, gap_ext,
               nwd=0, n_items=None):
    """Everything one launch of nw_gotoh_xl as built into ``lib`` (the
    tree's library, or a variant of ``tools/nw_variants.py``) takes, on
    checked CUDA tensors: its work table, scratch, queue counter and
    progress words.  ``nwd``: 0 lets the launcher carry MT and LN in one word
    or two by the width, 2 makes it two.  ``n_items``: the table's length,
    fetched with the wrapper's checks; None fetches it here (one host
    sync).  Returns (go, result): go() zeroes the counter and the progress
    words and launches the kernel, which writes ``result``; it may be
    called again, so a timing loop can time the launch alone."""
    bsz, m = a_idx.shape
    n = b_idx.shape[1]
    dev = a_idx.device
    strip = lib.nw_gotoh_xl_strip_rows()
    if n_items is None:
        n_items = int(xl_strips(a_len, b_len, strip).sum())
    items = xl_work_table(a_len, b_len, strip, n_items)
    scratch = torch.empty(SCRATCH_PLANES["nw_gotoh_xl"] * (n + 1) * bsz,
                          dtype=torch.int32, device=dev)
    # the queue counter, then a progress word per item, a 128-byte line on
    sync = torch.empty(32 + n_items, dtype=torch.int32, device=dev)
    out_mt = torch.empty(bsz, dtype=torch.int32, device=dev)
    out_ln = torch.empty(bsz, dtype=torch.int32, device=dev)
    sub_t = sub.t().contiguous()  # the kernels read the table as [b][a]
    fn = bind(lib, "nw_gotoh_xl")

    def go():
        sync.zero_()
        with torch.cuda.device(dev), span("nw_gotoh_xl", items=n_items):
            rc = fn(a_idx.data_ptr(), a_len.data_ptr(), b_idx.data_ptr(),
                    b_len.data_ptr(), sub_t.data_ptr(), bsz, m, n, gap_open,
                    gap_ext, nwd, items.data_ptr(), n_items,
                    scratch.data_ptr(), sync.data_ptr(),
                    sync[32:].data_ptr(), out_mt.data_ptr(),
                    out_ln.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"nw_gotoh_xl launch failed: CUDA error {rc}")

    return go, NWResult(out_mt, out_ln)


def launch_xl(lib, a_idx, a_len, b_idx, b_len, sub, gap_open, gap_ext,
              nwd=0, n_items=None) -> NWResult:
    """Run nw_gotoh_xl as built into ``lib`` on checked CUDA tensors
    (:func:`prepare_xl`, then the launch)."""
    go, res = prepare_xl(lib, a_idx, a_len, b_idx, b_len, sub, gap_open,
                         gap_ext, nwd, n_items)
    go()
    return res


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


def _check_values(a_idx, a_len, b_idx, b_len, sub,
                  strip: int = 0) -> tuple[int, int]:
    """Raise unless 0 <= a_len <= M and 0 <= b_len <= N (the kernels read
    a[i-1] for i <= a_len and b[j-1] for j <= b_len unchecked), the scores
    fit int8 and the symbols lie in [0, MAX_SYMBOL], as the kernels carry
    them.  Returns the largest a_len and, for ``strip`` > 0, nw_gotoh_xl's
    work items at that strip height (else 0).  One host sync per call."""
    m, n = a_idx.shape[1], b_idx.shape[1]
    ia, ib = a_idx.aminmax(), b_idx.aminmax()  # one pass over each
    items = (xl_strips(a_len, b_len, strip).sum() if strip
             else a_len.new_zeros(()))
    lo_a, hi_a, lo_b, hi_b, lo_s, hi_s, lo_i, hi_i, n_items = torch.stack(
        [x.long() for x in (
            a_len.min(), a_len.max(), b_len.min(), b_len.max(), sub.min(),
            sub.max(), torch.minimum(ia.min, ib.min),
            torch.maximum(ia.max, ib.max), items)]
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
    return hi_a, n_items


def _run(name, a_idx, a_len, b_idx, b_len, sub, gap_open, gap_ext,
         xl_words=0):
    """Check, then the plain version for CPU tensors or kernel ``name``
    for CUDA tensors.  ``xl_words``: 0 lets nw_gotoh_xl's launcher carry
    MT and LN in one word or two by the width; 2 makes it two at any width
    (for the checks of that instantiation)."""
    _check_inputs(a_idx, a_len, b_idx, b_len, sub)
    dev = a_idx.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no NW kernel for device {dev}")
    if not (0 <= gap_open <= MAX_GAP and 0 <= gap_ext <= MAX_GAP):
        raise ValueError(f"gap penalties must lie in [0, {MAX_GAP}], got "
                         f"({gap_open}, {gap_ext})")
    bsz, m = a_idx.shape
    n = b_idx.shape[1]
    xl = name == "nw_gotoh_xl" and dev.type == "cuda"
    strip = _library(name).nw_gotoh_xl_strip_rows() if xl and bsz else 0
    a_max, n_items = 0, 0
    if bsz:
        with span("nw_gotoh.check"):
            a_max, n_items = _check_values(a_idx, a_len, b_idx, b_len, sub,
                                           strip)
    if dev.type == "cpu":
        return nw_similarity_batch(
            a_idx, a_len, b_idx, b_len, sub,
            gap_open=gap_open, gap_ext=gap_ext,
        )
    if bsz == 0:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return NWResult(empty, empty.clone())
    if xl:
        return launch_xl(_library(name), a_idx, a_len, b_idx, b_len, sub,
                         gap_open, gap_ext, xl_words, n_items)
    if max(m, n) + 1 > MAX_MP1:
        raise ValueError(
            f"nw_gotoh takes padded max(M, N)+1 <= {MAX_MP1}, got M={m}, "
            f"N={n}; nw_similarity_batch_cuda_xl takes any width")
    inst = pick_instance(a_max)
    out_mt = torch.empty(bsz, dtype=torch.int32, device=dev)
    out_ln = torch.empty(bsz, dtype=torch.int32, device=dev)
    sub_t = sub.t().contiguous()  # the kernels read the table as [b][a]
    with torch.cuda.device(dev), span(name, **{f"instance{inst}": 1}):
        rc = bind(_library(name), name)(
            a_idx.data_ptr(), a_len.data_ptr(), b_idx.data_ptr(),
            b_len.data_ptr(), sub_t.data_ptr(), bsz, m, n, gap_open, gap_ext,
            inst, a_max, out_mt.data_ptr(), out_ln.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return NWResult(out_mt, out_ln)


def launches() -> tuple[int, int, list[int]]:
    """Launches since the last ``profiling.reset()``: of ``nw_gotoh``, of
    ``nw_gotoh_xl``, and the sorted ``INSTANCES`` indices ``nw_gotoh``
    launched."""
    c = counters()
    prefix = "nw_gotoh.instance"
    return (c.get("nw_gotoh", 0), c.get("nw_gotoh_xl", 0),
            sorted(int(k[len(prefix):]) for k in c if k.startswith(prefix)))


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
    return _run("nw_gotoh", a_idx, a_len, b_idx, b_len, sub, gap_open,
                gap_ext)


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
    """(matches, alignment_length) per pair: through ``nw_gotoh_xl`` (a
    queue of strips, longest pair first, a warp a strip; for long pairs, any
    length) for CUDA tensors, the plain version for CPU tensors."""
    return _run("nw_gotoh_xl", a_idx, a_len, b_idx, b_len, sub, gap_open,
                gap_ext)
