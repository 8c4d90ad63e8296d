"""Batched NW dispatch: the range check of the ported kernel, then the
wrapper, which sends CUDA tensors to the kernel and CPU tensors to the
plain PyTorch version."""

from __future__ import annotations

import torch

from .nw import NEG_SENTINEL, NWResult, nw_similarity_batch  # noqa: F401
from .nw_cuda import nw_similarity_batch_cuda

# Largest padded m+1 the CUDA route serves in this slice: the range of the
# TPU kernel it ports (PALLAS_MAX_MP1 in the JAX package's
# ops/nw_pallas.py).
# Longer pairs are the range of nw_pallas.py::_kernel_xl, not yet ported.
MAX_MP1 = 1120


def pick_nw_backend(device, m: int, n: int) -> str:
    """``"torch"`` (the plain version) on the CPU, else ``"cuda"`` (the
    kernel), as ``nw_similarity_batch_cuda`` routes a batch of padded widths
    (m, n); raises where the kernel's range ends.  The wrapper itself raises
    on devices other than CPU and CUDA."""
    if torch.device(device).type == "cpu":
        return "torch"
    if max(m, n) + 1 > MAX_MP1:
        raise NotImplementedError(
            f"padded length {max(m, n)} + 1 > {MAX_MP1}: multi-kilobase "
            "pairs are the range of the TPU kernel _kernel_xl, not yet "
            "ported (ROADMAP.md, queue 2 item 2)"
        )
    return "cuda"


def nw_batch(
    a_idx, a_len, b_idx, b_len, sub, *, gap_open: int = 10, gap_ext: int = 4
) -> NWResult:
    """(matches, length) for [B, L] pair batches on their own device."""
    pick_nw_backend(a_idx.device, a_idx.shape[1], b_idx.shape[1])
    return nw_similarity_batch_cuda(a_idx, a_len, b_idx, b_len, sub,
                                    gap_open=gap_open, gap_ext=gap_ext)


def nw_batch_tiled(
    a_idx, a_len, b_idx, b_len, sub, *, gap_open: int = 10, gap_ext: int = 4
) -> NWResult:
    """``nw_batch`` over [T, B, L] tile stacks, as one batch of T*B pairs;
    the result is [T, B]."""
    t, bsz, m = a_idx.shape
    res = nw_batch(
        a_idx.reshape(t * bsz, m), a_len.reshape(t * bsz),
        b_idx.reshape(t * bsz, b_idx.shape[2]), b_len.reshape(t * bsz),
        sub, gap_open=gap_open, gap_ext=gap_ext,
    )
    return NWResult(res.matches.reshape(t, bsz), res.length.reshape(t, bsz))
